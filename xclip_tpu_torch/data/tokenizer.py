"""OpenAI-CLIP-compatible BPE tokenizer (host side), the counterpart of
`xclip_tpu/data/tokenizer.py`.

Same merges file (its own byte-identical copy of
`bpe_simple_vocab_16e6.txt`), byte-to-unicode table, specials,
`vocab_size` 49408, `encode` / `decode` / `tokenize` and their errors.
`tokenize` returns a NumPy int32 array.

The standard library only: JAX's pre-tokenizer is a `regex` pattern,

    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d
    |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+          (IGNORECASE)

and here it is a pattern of Python's `re` whose classes are spelled out
from `unicodedata` (`_classes`): letters are `str.isalpha`, numbers the
categories N*, and whitespace `regex`'s `\\s` (Python's `str.isspace`
without U+001C-U+001F). IGNORECASE is written into the specials and the
contractions (`s` also matches U+017F, as in `regex`), and U+0345, which
`regex` leaves out of the negated class under IGNORECASE (its case partner
is a letter), matches no alternative. Both agree on every code point that
Python's Unicode database assigns; `regex` may know later code points.
`re` tests a character against a class's ranges above U+FFFF one by one,
so the letter and number classes are each split into their part below
U+10000 (one table lookup) and, behind a one-range guard, the rest.

`ftfy` fixes the text only if it is installed. The BPE merge loop runs in
C++ (`xclip_tpu_torch.native.fast_bpe`, built with g++ at first use) unless
`use_native=False` selects the Python loop; a failed build raises. The
module attribute `tokenizer` is built at first use, so importing this
module reads and builds nothing.
"""

from __future__ import annotations

import functools
import html
import itertools
import os
import re
import unicodedata
from typing import List, Union

import numpy as np

try:
    import ftfy

    def _fix_text(t: str) -> str:
        return ftfy.fix_text(t)
except ImportError:
    def _fix_text(t: str) -> str:
        return t

SPECIALS = ("<|startoftext|>", "<|endoftext|>")
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# regex's \s is Unicode's White_Space; str.isspace also takes these four
# (bidi class B / S)
_NOT_WHITESPACE = "\x1c\x1d\x1e\x1f"
# no alternative matches it: its case partner (iota) is a letter, so the
# negated class under IGNORECASE refuses it, and \p{L} does not take it
_UNMATCHED = "\u0345"
_ASTRAL = "\U00010000-\U0010ffff"


def default_bpe() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bpe_simple_vocab_16e6.txt")


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte → printable-unicode map (avoids control chars so BPE
    merges operate on visible symbols). Same table as GPT-2/CLIP."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _ranges(codepoints) -> str:
    """A character-class body of `re` for the sorted code points."""
    out = []
    for _, run in itertools.groupby(enumerate(codepoints),
                                    lambda t: t[1] - t[0]):
        run = [cp for _, cp in run]
        lo, hi = re.escape(chr(run[0])), re.escape(chr(run[-1]))
        out.append(lo if run[0] == run[-1] else f"{lo}-{hi}")
    return "".join(out)


@functools.lru_cache()
def _classes():
    """Letters and numbers, each as (part below U+10000, the rest), and
    whitespace (all below U+10000): `re` class bodies from Python's Unicode
    database."""
    letters, numbers, space = [], [], []
    for cp in range(0x110000):
        c = chr(cp)
        if c.isalpha():
            letters.append(cp)
        elif unicodedata.category(c)[0] == "N":
            numbers.append(cp)
        elif c.isspace() and c not in _NOT_WHITESPACE:
            space.append(cp)

    def halves(cps):
        return (_ranges([cp for cp in cps if cp < 0x10000]),
                _ranges([cp for cp in cps if cp >= 0x10000]))

    return halves(letters), halves(numbers), _ranges(space)


def _caseless(word: str) -> str:
    """`word` as a pattern matching it under regex's simple case folding."""
    out = []
    for c in word:
        variants = {c, c.upper(), c.lower()} | ({"ſ"} if c == "s" else set())
        variants = sorted(v for v in variants if len(v) == 1)
        out.append(re.escape(c) if len(variants) == 1
                   else "[" + "".join(map(re.escape, variants)) + "]")
    return "".join(out)


@functools.lru_cache()
def pretokenizer() -> "re.Pattern":
    """JAX's pre-tokenizer pattern in Python's `re` (module docstring)."""
    (letters, astral_letters), (numbers, astral_numbers), space = _classes()
    guard = f"(?=[{_ASTRAL}])"
    return re.compile("|".join(
        [_caseless(w) for w in SPECIALS + CONTRACTIONS]
        + [f"(?:[{letters}]+|{guard}[{astral_letters}])+",
           f"[{numbers}]|{guard}[{astral_numbers}]",
           f"(?:[^{space}{letters}{numbers}{_UNMATCHED}{_ASTRAL}]+"
           f"|{guard}[^{astral_letters}{astral_numbers}])+"]))


@functools.lru_cache()
def _whitespace_run() -> "re.Pattern":
    return re.compile(f"[{_classes()[2]}]+")


def _whitespace_clean(text: str) -> str:
    """JAX's `regex.sub(r"\\s+", " ", text).strip()`."""
    return _whitespace_run().sub(" ", text).strip()


def _basic_clean(text: str) -> str:
    text = _fix_text(text)
    return html.unescape(html.unescape(text)).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: str = None, use_native: bool = True):
        bpe_path = bpe_path or default_bpe()
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with open(bpe_path, encoding="utf8") as f:
            merge_lines = f.read().split("\n")
        merge_lines = merge_lines[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merge_lines]

        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += list(SPECIALS)

        self.vocab_size = 49408
        assert len(vocab) == self.vocab_size

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {s: s for s in SPECIALS}
        self.pat = pretokenizer()

        self.sot_token = self.encoder["<|startoftext|>"]   # 49406
        self.eot_token = self.encoder["<|endoftext|>"]     # 49407

        self._native = None
        if use_native:
            from ..native.fast_bpe import FastBPE
            self._native = FastBPE(bpe_path)

    # ------------------------------------------------------------------ BPE
    def bpe(self, token: str) -> str:
        """Greedy lowest-rank merging, as JAX's `SimpleTokenizer.bpe`:
        repeatedly pick the adjacent pair with the best merge rank and fuse
        every left-to-right non-overlapping occurrence, until no adjacent
        pair has a rank. The last symbol carries the `</w>` marker."""
        if token in self.cache:
            return self.cache[token]
        parts = list(token[:-1]) + [token[-1] + "</w>"]

        no_rank = float("inf")
        while len(parts) > 1:
            ranks = [self.bpe_ranks.get(pair, no_rank)
                     for pair in zip(parts, parts[1:])]
            best = min(range(len(ranks)), key=ranks.__getitem__)
            if ranks[best] == no_rank:
                break
            first, second = parts[best], parts[best + 1]
            fused, i = [], 0
            while i < len(parts):
                if (parts[i] == first and i + 1 < len(parts)
                        and parts[i + 1] == second):
                    fused.append(first + second)
                    i += 2
                else:
                    fused.append(parts[i])
                    i += 1
            parts = fused

        result = " ".join(parts)
        self.cache[token] = result
        return result

    # --------------------------------------------------------------- encode
    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        # each pre-token's UTF-8 bytes (read as latin-1) mapped to symbols
        pretokens = [token.encode("utf-8").decode("latin-1").translate(
            self.byte_encoder) for token in self.pat.findall(text)]
        if self._native is not None:
            return self._native.encode(pretokens)
        return [self.encoder[t] for token in pretokens
                for t in self.bpe(token).split(" ")]

    # --------------------------------------------------------------- decode
    def decode(self, tokens, remove_start_end: bool = True, pad_tokens=()) -> str:
        if hasattr(tokens, "tolist"):
            tokens = tokens.tolist()
        if remove_start_end:
            tokens = [t for t in tokens if t not in (49406, 49407, 0)]
        text = "".join(self.decoder[t] for t in tokens if t not in set(pad_tokens))
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    # -------------------------------------------------------------- tokenize
    def tokenize(
        self,
        texts: Union[str, List[str]],
        context_length: int = 256,
        truncate_text: bool = False,
        pad_to_context_length: bool = False,
    ) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        if not isinstance(texts, (list, tuple)) or any(
                not isinstance(t, str) for t in texts):
            raise TypeError(
                "tokenize() expects a str or a list of str, got "
                f"{type(texts).__name__}"
                + ("" if not isinstance(texts, (list, tuple)) else
                   " containing " + ", ".join(sorted(
                       {type(t).__name__ for t in texts
                        if not isinstance(t, str)}))))

        all_tokens = [self.encode(t) for t in texts]
        max_length = max((len(t) for t in all_tokens), default=0)

        if max_length > context_length:
            if truncate_text:
                all_tokens = [t[:context_length] for t in all_tokens]
                max_length = context_length
            else:
                raise RuntimeError(
                    f"One of the inputs is too long for context length {context_length}")

        width = context_length if pad_to_context_length else max_length
        out = np.zeros((len(all_tokens), width), dtype=np.int32)
        for i, toks in enumerate(all_tokens):
            out[i, :len(toks)] = toks
        return out


@functools.lru_cache()
def _shared() -> SimpleTokenizer:
    return SimpleTokenizer()


def __getattr__(name):
    # `tokenizer`, JAX's module-level instance, built at first use
    if name == "tokenizer":
        return _shared()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
