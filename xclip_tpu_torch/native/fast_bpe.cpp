// Fast BPE merge loop for the CLIP tokenizer (host-side data pipeline), a
// copy of xclip_tpu/native/fast_bpe.cpp.
//
// The pure-Python merge loop (xclip_tpu_torch/data/tokenizer.py
// SimpleTokenizer.bpe) spends its time in a pair-merge loop; this is the
// C++ equivalent, exposed through a C ABI consumed via ctypes.
//
// Division of labor: Python does text cleaning and pre-tokenization (the
// standard library's `re`, its classes spelled out from unicodedata) and
// maps raw bytes through the byte->unicode table; this library receives the
// byte-mapped pre-tokens joined by '\n' (a character that can never occur in
// byte-mapped text) and runs the merge loop + vocab lookup, returning token
// ids.
//
// Semantics are bit-identical to the Python loop: lowest-rank bigram first,
// left-to-right replacement, '</w>' end-of-word marker, per-token result
// cache.

#include <cstdint>
#include <cstring>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
    size_t operator()(const std::pair<std::string, std::string>& p) const {
        std::hash<std::string> h;
        return h(p.first) * 31 ^ h(p.second);
    }
};

// --- utf-8 iteration over the byte-mapped symbol strings -------------------
std::vector<std::string> utf8_chars(const std::string& s) {
    std::vector<std::string> out;
    size_t i = 0;
    while (i < s.size()) {
        unsigned char c = s[i];
        size_t len = (c < 0x80) ? 1 : (c < 0xE0) ? 2 : (c < 0xF0) ? 3 : 4;
        out.push_back(s.substr(i, len));
        i += len;
    }
    return out;
}

// byte → printable-unicode map (same table as tokenizer.py bytes_to_unicode)
std::vector<std::string> bytes_to_unicode_table() {
    std::vector<int> bs;
    for (int b = int('!'); b <= int('~'); ++b) bs.push_back(b);
    for (int b = 0xA1; b <= 0xAC; ++b) bs.push_back(b);
    for (int b = 0xAE; b <= 0xFF; ++b) bs.push_back(b);
    std::vector<int> cs(bs.begin(), bs.end());
    int n = 0;
    for (int b = 0; b < 256; ++b) {
        bool found = false;
        for (int x : bs) if (x == b) { found = true; break; }
        if (!found) { bs.push_back(b); cs.push_back(256 + n); ++n; }
    }
    auto encode_cp = [](int cp) {
        std::string out;
        if (cp < 0x80) out += char(cp);
        else if (cp < 0x800) {
            out += char(0xC0 | (cp >> 6));
            out += char(0x80 | (cp & 0x3F));
        } else {
            out += char(0xE0 | (cp >> 12));
            out += char(0x80 | ((cp >> 6) & 0x3F));
            out += char(0x80 | (cp & 0x3F));
        }
        return out;
    };
    std::vector<std::string> table(256);
    for (size_t i = 0; i < bs.size(); ++i) table[bs[i]] = encode_cp(cs[i]);
    return table;
}

struct Tokenizer {
    std::unordered_map<std::pair<std::string, std::string>, int, PairHash> ranks;
    std::unordered_map<std::string, int> encoder;
    std::unordered_map<std::string, std::vector<int32_t>> cache;
    std::mutex cache_mu;

    explicit Tokenizer(const std::string& merges_path) {
        std::ifstream f(merges_path);
        std::string line;
        std::getline(f, line);  // header
        std::vector<std::pair<std::string, std::string>> merges;
        // merges[1 : 49152-256-2+1] — 48894 merge lines (tokenizer.py:63)
        const int kNumMerges = 49152 - 256 - 2;
        while ((int)merges.size() < kNumMerges && std::getline(f, line)) {
            if (!line.empty() && line.back() == '\r') line.pop_back();
            auto sp = line.find(' ');
            if (sp == std::string::npos) break;
            merges.emplace_back(line.substr(0, sp), line.substr(sp + 1));
        }
        auto table = bytes_to_unicode_table();
        std::vector<std::string> vocab;
        vocab.reserve(49408);
        for (int b = 0; b < 256; ++b) vocab.push_back(table[b]);
        // order must match python: list(bytes_to_unicode().values()) is
        // insertion order of the bs list, not byte order
        vocab.clear();
        {
            std::vector<int> order;
            for (int b = int('!'); b <= int('~'); ++b) order.push_back(b);
            for (int b = 0xA1; b <= 0xAC; ++b) order.push_back(b);
            for (int b = 0xAE; b <= 0xFF; ++b) order.push_back(b);
            for (int b = 0; b < 256; ++b) {
                bool found = false;
                for (size_t i = 0; i < order.size() && !found; ++i)
                    if (order[i] == b) found = true;
                if (!found) order.push_back(b);
            }
            for (int b : order) vocab.push_back(table[b]);
        }
        size_t base = vocab.size();
        for (size_t i = 0; i < base; ++i) vocab.push_back(vocab[i] + "</w>");
        for (size_t i = 0; i < merges.size(); ++i) {
            ranks[merges[i]] = (int)i;
            vocab.push_back(merges[i].first + merges[i].second);
        }
        vocab.push_back("<|startoftext|>");
        vocab.push_back("<|endoftext|>");
        for (size_t i = 0; i < vocab.size(); ++i) encoder[vocab[i]] = (int)i;
        cache["<|startoftext|>"] = {encoder["<|startoftext|>"]};
        cache["<|endoftext|>"] = {encoder["<|endoftext|>"]};
    }

    std::vector<int32_t> bpe(const std::string& token) {
        {
            std::lock_guard<std::mutex> lock(cache_mu);
            auto it = cache.find(token);
            if (it != cache.end()) return it->second;
        }
        std::vector<std::string> word = utf8_chars(token);
        if (word.empty()) return {};
        word.back() += "</w>";

        while (word.size() > 1) {
            int best_rank = INT32_MAX;
            size_t best_i = 0;
            for (size_t i = 0; i + 1 < word.size(); ++i) {
                auto it = ranks.find({word[i], word[i + 1]});
                if (it != ranks.end() && it->second < best_rank) {
                    best_rank = it->second;
                    best_i = i;
                }
            }
            if (best_rank == INT32_MAX) break;
            // merge ALL occurrences of the best pair left-to-right
            const std::string first = word[best_i], second = word[best_i + 1];
            std::vector<std::string> merged;
            merged.reserve(word.size());
            size_t i = 0;
            while (i < word.size()) {
                if (i + 1 < word.size() && word[i] == first && word[i + 1] == second) {
                    merged.push_back(first + second);
                    i += 2;
                } else {
                    merged.push_back(word[i]);
                    i += 1;
                }
            }
            word.swap(merged);
        }

        std::vector<int32_t> ids;
        ids.reserve(word.size());
        for (const auto& w : word) {
            auto it = encoder.find(w);
            ids.push_back(it == encoder.end() ? -1 : it->second);
        }
        {
            std::lock_guard<std::mutex> lock(cache_mu);
            cache[token] = ids;
        }
        return ids;
    }
};

}  // namespace

extern "C" {

void* fastbpe_create(const char* merges_path) {
    try {
        return new Tokenizer(merges_path);
    } catch (...) {
        return nullptr;
    }
}

void fastbpe_destroy(void* handle) {
    delete static_cast<Tokenizer*>(handle);
}

// `pretokens`: byte-mapped pre-tokens joined by '\n'. Writes ids into `out`
// (capacity `max_out`), returns the count (or -1 on overflow/error).
int32_t fastbpe_encode(void* handle, const char* pretokens, int32_t* out,
                       int32_t max_out) {
    auto* tok = static_cast<Tokenizer*>(handle);
    if (!tok) return -1;
    int32_t n = 0;
    std::stringstream ss(pretokens);
    std::string piece;
    while (std::getline(ss, piece, '\n')) {
        if (piece.empty()) continue;
        for (int32_t id : tok->bpe(piece)) {
            if (n >= max_out) return -1;
            out[n++] = id;
        }
    }
    return n;
}

}  // extern "C"
