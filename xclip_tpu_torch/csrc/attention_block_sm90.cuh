// The bf16 attention core of the port: whole-head attention on the fused
// qkv (b*n x 3*heads*dh), forward and backward, in two modes chosen at
// compile time, at a head's true width dh, any multiple of 8 up to 256
// (NH = ⌈dh / 64⌉ staged 64-column halves, as bf16 K7 takes them:
// flash_attention_sm90.cuh).
//   * K6 (MEGA false), in place of the Pallas bodies of
//     xclip_tpu/kernels/attention_block.py: `_fwd_kernel` (:83) and
//     `_bwd_kernel` (:117); csrc/attention_block.cu gives the semantics.
//   * The attention megablock's core (MEGA true), the attention step of
//     K-MEGA, K2 and K3 (csrc/attention_megablock.cu), in place of the
//     attention part of `_fwd_common` and of `_bwd_kernel_stored` /
//     `_bwd_kernel` in xclip_tpu/kernels/attention_megablock.py.
// Both compute the same numbers as the Pallas bodies: scores (q . k) *
// scale in fp32, -inf on masked and future keys; a dead row (maybe_dead,
// no valid key up to it) uniform over the n keys with m = 0; l = max(sum
// p, 1e-30); p / l rounded to bf16 before p . v. They differ in what the
// forward keeps and in where the backward puts the scale:
//   * K6 keeps lse = m + log l (b*n x heads); its backward takes p =
//     exp(s - lse) (1/n on a dead row), delta = sum do * out from the
//     stored out and the bf16 do, ds = T(p (dp - delta) scale) with dp =
//     do . vᵀ;
//   * the megablock keeps its pair `sm` (b*n x 2*heads: m at column h, l at
//     heads + h), or nothing (K-MEGA, K3's recompute); its backward takes p
//     = (dead ? 1 : exp(s - m)) / l from the stored pair (not re-reduced),
//     the fp32 row cotangent dattn, delta = scale * sum dattn * attnout in
//     fp32, dp = T(dattn * scale) . vᵀ and ds = T(p (dp - delta)): the
//     scale sits on do, not on ds (for a scale that is not a power of two
//     the two orders round differently).
// Then ds is 0 on a dead row; dq = ds . k, dk = dsᵀ . q, dv = T(p)ᵀ . do
// (the megablock's do unscaled, T(dattn)), each cast once.
//
// What bounds it on the card: bytes. At K6's text shape (b 256, n 256, 8
// heads, causal, key pads uniform in 1..n) the forward reads q and the k
// and v of the keys some query uses (the valid ones; all n where a row is
// dead) and writes out and lse (0.061 ms at 3.35 TB/s), the backward also
// reads out, do and lse and writes all of dqkv (0.141 ms); the products
// are ~29 GFLOP, 0.03 ms of the tensor cores. At the megablock's text
// shape (b 256, n 257, 8 heads, not causal, caption lengths 5..257) the
// bounds are 0.061 and 0.161 ms: its backward reads the cotangent in fp32.
// The wmma core both ran on before (the megablock until this design took
// it over) lost its time elsewhere, and the design answers each:
//   * every 32-query tile re-staged the head's k and v: here a block is 64
//     queries (forward, dq) or 64 keys (dk/dv) x one head x one batch
//     element, and it streams the other side's 64-row tiles through a
//     double-buffered cp.async ring once per pass;
//   * score rows went through shared memory (wmma stores, three warp
//     sweeps, p written back as bf16): here each of the 4 warps owns 16
//     rows, and scores, dp and the out / dq / dk / dv accumulators stay in
//     registers on mma.sync m16n8k16 with ldmatrix (mma_tiles.cuh); p and
//     ds pass from an accumulator to the next product's A operand in
//     registers, and row statistics reduce over the quad with shuffles;
//   * the mask was read from global memory per element: here a block reads
//     its mask row once into one 64-bit word per 64-key tile, and the first
//     valid key comes from the words;
//   * no tile was skipped: here key tiles above the causal diagonal and
//     key tiles with no valid key are skipped (forward and dq), and so are
//     query tiles below a key tile (dk/dv), except where dead rows need
//     them: a forward block holding a dead row walks every key tile, and
//     the dk/dv kernel walks every query tile that holds a dead row (its p
//     = 1/n reaches dv for every key).
// The forward takes two passes over the key tiles: the first keeps a
// running (m, l), the second recomputes s and accumulates T(p / l) . v, so
// that p / l is rounded with the whole row's l, as the reference rounds
// it. Every kernel skips work a warp does not need: a warp whose 16 rows
// are all at or past n runs no product (it still joins the block's
// barriers); key columns past the last key a warp reads (n, or causal its
// last row) are skipped in 8-key chunks in q . kᵀ and 16-deep slices in p
// . v, and a whole tile takes its products without a branch; a full tile
// (all 64 keys valid and, causal, none past the warp's first row) takes
// only the scale, with no per-element mask. e^x is 2^(x log2 e) on
// ex2.approx (`k6_exp`) and p / l is p times a reciprocal taken once a row
// (`k6_norm`). Holding a block's score rows whole in registers up to 320
// keys (one q . kᵀ and one exp a score) costs half the blocks an SM: on an
// NVIDIA H100 (700 W) it won only where every key tile of a row holds
// valid keys (full-length captions) and lost to two passes at the text
// tower's key pads and under K6's causal triangle;
// tools/mega_core_variants.py times it (tools/held_rows.patch), with the
// scores in shared memory and with expf and the division, against the
// shipped kernels (PERF.md).
// The backward is two kernels, each owning its outputs (no atomics, two
// runs agree bit for bit): query tiles give delta (into the `delta`
// scratch) and dq; key tiles compute sᵀ = k . qᵀ and dpᵀ = v . doᵀ, so pᵀ
// and dsᵀ are the A operands of dv += T(p)ᵀ . do and dk += dsᵀ . q. Both
// take the same warp, chunk and full-tile cuts, and the row terms (m, 1 /
// l, delta) once a row or a tile column. Registers bound the dk/dv kernel
// at three blocks an SM, so it passes its A operands and p, ds one 16-wide
// slice at a time (whole operands spill in the megablock's mode, two
// blocks an SM run slower: tools/mega_core_variants.py). In megablock mode
// the dq kernel reads its block's fp32 dattn rows once, sums delta from
// them and writes the two bf16 copies the dk/dv kernel streams as K6
// streams do: T(dattn * scale) for dpᵀ and T(dattn) for dv, side by side
// in the 256 bytes of the row's fp32 head slice (`dcopy`, which may be
// dattn's own storage: nothing reads the fp32 values after the dq kernel).
// Every output element is written (the wrappers' tensors come from
// torch.empty): a skipped tile leaves its accumulator 0. Rows and keys at
// or past n read as 0 and are never written.
// A head of 128 (NH = 2) is two 64-column halves a side. Four warps on
// mma.sync held both halves' accumulators and no q or do fragments (read
// again by ldmatrix at every key tile), and the megablock's dk/dv kernel
// staged 149,248 bytes, one block an SM. So at 128:
//   * the forward and the dq kernel run on Hopper's warpgroup products
//     (k6_fwd_wg_kernel, k6_bwd_dq_wg_kernel): one warpgroup a 64-row block,
//     two blocks (8 warps) an SM. Thread 0 loads q (and K6's do) once and
//     the walk's key tiles one step ahead by TMA, from a 3-D map over (b,
//     n, 3 hd) that zero-fills rows past n of each batch element, into a
//     two-stage mbarrier ring of 128-byte-swizzled panels; q . kᵀ and do .
//     vᵀ are m64n64k16 products whose operands wgmma reads from shared
//     memory, p . v and ds . k m64n128k16 with p or ds from registers. The
//     walk, cuts, masks, statistics and row terms are the 4-warp kernels'
//     (the m64nN accumulator gives a warp the mma.sync tile's layout).
//   * the dk/dv kernel stays on four warps (255 registers a thread, both
//     halves' dk and dv): K6's with its double-buffered rings (111,872
//     bytes), the megablock's with one buffer of do and one of T(dattn),
//     staged once the tile before has been read (112,384 bytes): two
//     blocks, 8 warps an SM, where the double-buffered kernel held one.
// tools/wide_bf16_variants.py times these against an older checkout's
// (--parent) and 128 query rows a forward block; the forward and dk/dv on
// 8-warp mma.sync blocks of warp pairs and key tile 0 loaded before the
// mask words were timed too and lost (PERF.md). In the megablock mode the
// row's fp32 head slice of dattn (512
// bytes) takes the bf16 copies half by half, each half's T(dattn * scale)
// and T(dattn) in the 256 bytes its own fp32 values held (`dcopy` column
// 2 D h + 128 hh for half hh).
// A head is read at its true width dh:
// q, k, v, out and do at their real strides (3 heads dh, heads dh), the
// last half's columns past dh zero in shared memory (cp.async with a
// source size of 0; the wgmma kernels' TMA boxes from a 4-D map over (b,
// n, slot, dh) whose extent dh reads 0 past it), and only columns below
// dh stored. A partial half of w columns keeps its dattn copies in w + w
// bf16 slots (column 2 dh h + 128 hh, T(dattn) w on). At three and four
// halves (dh 136 to 256) every kernel is mma.sync, one block an SM: the
// forward and dq hold every half's accumulator and read q (and do) from
// shared memory a 16-deep slice at a time; the dk/dv kernel runs two
// groups of four warps on the same 16-key slabs, each recomputing s and
// dp over the whole head and keeping dk and dv for two halves (a thread
// holding all four halves' would need 256 fp32). A head of whole halves at
// one or two (64, 128: the widths the kernels were tuned at) runs an
// instance with dh a compile-time constant (`FULL`, `by_width`): read at
// run time, the width's address arithmetic and guards cost those kernels
// 3-17 % (tools/wide_bf16_variants.py --parent).
#pragma once

#include "mma_tiles.cuh"
#include "sm90_async.cuh"

namespace xclip {
namespace {

constexpr int K6_THREADS = 128;   // 4 warps of 16 rows: 64-row blocks
constexpr int K6_MAX_TILES = 32;  // key tiles of the longest sequence
constexpr int K6_MAX_N = 64 * K6_MAX_TILES;
constexpr int K6_TILE = 64 * LDT;  // bf16 elements of a staged tile
constexpr float K6_LOG2E = 1.4426950408889634f;

// Query rows of a wgmma forward block at heads of 128: one warpgroup (64)
// or two sharing each staged key tile (128); tools/wide_bf16_variants.py
// times both.
constexpr int K6_WG_ROWS = 64;

// The backward's row cotangent: K6's bf16 do, the megablock's fp32 dattn.
template <bool MEGA>
using K6Cot = typename std::conditional<MEGA, float, bf16>::type;

// e^(x - m) as 2^(x log2 e - m log2 e): one FFMA and one ex2.approx (m
// log2 e is a row's, hoisted), within a few fp32 ulps of expf(x - m);
// results below 2^-126 flush to 0.
__device__ __forceinline__ float k6_exp(float x, float m) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(y)
      : "f"(fmaf(x, K6_LOG2E, -m * K6_LOG2E)));
  return y;
}

// p / l, given linv = 1 / l taken once a row (or a dk/dv tile column).
__device__ __forceinline__ float k6_norm(float p, float l, float linv) {
  return p * linv;
}

// One 64-bit word per 64-key tile of the batch element's mask (bit c: key
// 64 t + c < n is valid), into `bits`; returns the first valid key (n if
// none). Ends with the block synchronised. THREADS: the block's threads
// (the fp32 core's backward also reads its mask so), `warp` the calling
// warp's index among them.
template <int THREADS = K6_THREADS>
__device__ int k6_key_tiles(unsigned long long* bits, const uint8_t* mrow,
                            int n, int warp = threadIdx.x >> 5) {
  const int lane = threadIdx.x & 31;
  const int tiles = (n + 63) / 64;
  for (int t = warp; t < tiles; t += THREADS / 32) {
    const int j = 64 * t + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, j < n && mrow[j]);
    const unsigned hi = __ballot_sync(0xffffffffu, j + 32 < n && mrow[j + 32]);
    if (lane == 0) bits[t] = lo | (unsigned long long)hi << 32;
  }
  __syncthreads();
  for (int t = 0; t < tiles; ++t)
    if (bits[t]) return 64 * t + __ffsll((long long)bits[t]) - 1;
  return n;
}

// Whether key tile t (mask word `word`) is full for the 16 query rows from
// r0: every key valid and, causal, none past r0. Such a tile needs no
// per-element mask, and holds no dead row.
__device__ __forceinline__ bool k6_full(unsigned long long word, int t, int r0,
                                        int causal) {
  return word == ~0ull && !(causal && 64 * t + 63 > r0);
}

// The warp's 16 rows of a staged head as the A operand of a . bᵀ over the
// head: read again from the staged halves by ldmatrix a 16-deep slice at a
// time (the mma.sync kernels at NH 3 and 4, where the halves' output
// accumulators take the registers; at 128 the wgmma kernels read q and do
// from shared memory by descriptor), or held in registers at a head of
// one half.
template <int NH>
struct HeadRows {
  const bf16* t;
  int r;
  __device__ __forceinline__ void load(const bf16* tile, int r0) {
    t = tile;
    r = r0;
  }
  __device__ __forceinline__ void abt(float (&acc)[8][4], const bf16* b,
                                      int nc) const {
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t a[4];
        load_a_k(a, t + hh * K6_TILE, r, k);
        if (nc >= 8)
          mma_abt_k(acc, a, k, b + hh * K6_TILE);
        else
          mma_abt_k(acc, a, k, b + hh * K6_TILE, nc);
      }
  }
};
template <>
struct HeadRows<1> {
  uint32_t a[4][4];
  __device__ __forceinline__ void load(const bf16* t, int r) {
    load_a(a, t, r);
  }
  __device__ __forceinline__ void abt(float (&acc)[8][4], const bf16* b,
                                      int nc) const {
    mma_abt(acc, a, b, nc);
  }
};

// The warp's products q . kᵀ over key tile t (its 16 rows from row[0] - g)
// scaled into scores: a full tile takes only the scale, elsewhere masked
// and future keys are -inf.
__device__ __forceinline__ void k6_mask(float (&s)[8][4], int t,
                                        unsigned long long word, bool full,
                                        const int (&row)[2], float scale,
                                        int causal) {
  if (full) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] *= scale;
    return;
  }
  const int tq = threadIdx.x & 3;
  const KeyBits key(word, tq);
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 64 * t + 8 * c + 2 * tq + (e & 1);
      const bool valid = key(c, e & 1) && !(causal && j > row[e >> 1]);
      s[c][e] = valid ? s[c][e] * scale : -INFINITY;
    }
}

// The warp's scores over key tile t (staged at kt): s = (q . kᵀ) scale
// over the tile's first `nc` 8-key chunks (the rest hold no key the warp
// reads, and read -inf); a full tile takes only the scale, elsewhere
// masked and future keys are -inf.
template <int NH>
__device__ __forceinline__ void k6_scores(float (&s)[8][4],
                                          const HeadRows<NH>& qa,
                                          const bf16* kt, int t,
                                          unsigned long long word, bool full,
                                          int nc, const int (&row)[2],
                                          float scale, int causal) {
  zero_acc(s);
  qa.abt(s, kt, nc);
  k6_mask(s, t, word, full, row, scale, causal);
}

// Forward at heads of one half (dh up to 64) or of three or four (136 to
// 256), one block per (64-query tile, head, batch element), in two passes
// over the key tiles; the last query tiles, which have the most key tiles
// when causal, start first. `stats`: K6's lse (b*n x heads); the
// megablock's sm (b*n x 2*heads), or null to keep none.
template <bool MEGA, int NH, bool FULL>
__global__ void __launch_bounds__(K6_THREADS, NH == 1 ? 4 : 1)
k6_fwd_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
              bf16* __restrict__ out, float* __restrict__ stats, int n,
              int heads, int dh_arg, float scale, int causal,
              int maybe_dead) {
  const int dh = FULL ? 64 * NH : dh_arg;  // whole halves fold it in
  constexpr int T = NH * K6_TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + T;      // two buffers
  bf16* vs = ks + 2 * T;  // two buffers
  auto* bits = reinterpret_cast<unsigned long long*>(vs + 2 * T);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64, h = blockIdx.y;
  const int bi = blockIdx.z, hd = heads * dh, tiles = (n + 63) / 64;
  const long ld = 3L * hd;
  const bf16* base = qkv + (long)bi * n * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  // the walk's steps: 64 p + t is key tile t in pass p (0 or 1)
  constexpr int END = 128;
  auto stage = [&](int st, int buf) {
    const int t = st & 63;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      stage_tile_async<K6_THREADS>(ks + buf * T + hh * K6_TILE, base, ld,
                                   hd + h * dh + 64 * hh, 64 * t, n,
                                   dh - 64 * hh);
      if (st >= 64)
        stage_tile_async<K6_THREADS>(vs + buf * T + hh * K6_TILE, base, ld,
                                     2 * hd + h * dh + 64 * hh, 64 * t, n,
                                     dh - 64 * hh);
    }
  };
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
    stage_tile_async<K6_THREADS>(qs + hh * K6_TILE, base, ld,
                                 h * dh + 64 * hh, q0, n, dh - 64 * hh);
  cp_async_commit();
  const int fv = k6_key_tiles(bits, mask + (long)bi * n, n);
  // a dead row is uniform over every key: its block walks every tile
  const bool dead_block = maybe_dead && (causal ? fv > q0 : fv >= n);
  const int last =
      causal && !dead_block ? min(tiles, q0 / 64 + 1) : tiles;
  auto next_tile = [&](int t) {
    for (++t; t < last && !dead_block && !bits[t]; ++t) {
    }
    return t;
  };
  const int first = next_tile(-1);
  auto next = [&](int st) {
    const int u = next_tile(st & 63);
    if (u < last) return (st & 64) + u;
    return st < 64 ? 64 + first : END;
  };
  const int first_step = first < last ? first : END;
  // the warp's cuts: no product past n; no key scored from `kend` on, no
  // p . v from `pend` on (a dead row reads every key)
  const int r0 = q0 + warp * 16;
  const bool live = r0 < n;
  const bool warp_dead = maybe_dead && live && (causal ? fv > r0 : fv >= n);
  const int kend = causal ? min(n, r0 + 16) : n;
  const int pend = warp_dead ? n : kend;
  int row[2];
  bool dead[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    dead[i] = maybe_dead && row[i] < n && (causal ? fv > row[i] : fv >= n);
  }
  cp_async_wait<0>();  // q
  __syncthreads();
  HeadRows<NH> qa;
  qa.load(qs, warp * 16);

  // pass 1 keeps the running max and sum of each row; then (m, l) are
  // final and the statistics are written; pass 2 accumulates o = T(p /
  // l) . v
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, linv[2];
  bool rows_final = false;
  auto finish_rows = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float sum = quad_sum(l[i]);  // every lane shuffles
      l[i] = dead[i] ? (float)n : fmaxf(sum, 1e-30f);
      linv[i] = 1.f / l[i];
      if (dead[i]) m[i] = 0.f;
      const long r = (long)bi * n + row[i];
      if (tq != 0 || row[i] >= n) continue;
      if (!MEGA) {
        stats[r * heads + h] = m[i] + logf(l[i]);
      } else if (stats) {
        stats[r * 2 * heads + h] = m[i];
        stats[r * 2 * heads + heads + h] = l[i];
      }
    }
    rows_final = true;
  };
  float o[NH][8][4];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) zero_acc(o[hh]);
  tile_walk(
      first_step, END, next, stage,
      [&](int st, int buf) {
        const int t = st & 63;
        const bf16* kt = ks + buf * T;
        const bool full = k6_full(bits[t], t, r0, causal);
        const int nc = tile_parts(kend - 64 * t, 8);
        float s[8][4];
        if (st < 64) {
          if (!live || nc == 0) return;
          k6_scores(s, qa, kt, t, bits[t], full, nc, row, scale, causal);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float mt = -INFINITY;
#pragma unroll
            for (int c = 0; c < 8; ++c)
              mt = fmaxf(mt, fmaxf(s[c][2 * i], s[c][2 * i + 1]));
            const float mn = fmaxf(m[i], quad_max(mt));
            if (mn != -INFINITY) {  // the same in the whole quad
              float sum = l[i] * k6_exp(m[i], mn);
#pragma unroll
              for (int c = 0; c < 8; ++c)
                sum += k6_exp(s[c][2 * i], mn) + k6_exp(s[c][2 * i + 1], mn);
              l[i] = sum;
              m[i] = mn;
            }
          }
          return;
        }
        if (!rows_final) finish_rows();
        const int ns = tile_parts(pend - 64 * t, 16);
        if (!live || ns == 0) return;
        if (nc > 0) {
          k6_scores(s, qa, kt, t, bits[t], full, nc, row, scale, causal);
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[c][e] = -INFINITY;
        }
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int j = 64 * t + 8 * c + 2 * tq + (e & 1);
            const float p = full ? k6_exp(s[c][e], m[i])
                            : dead[i] ? (j < n ? 1.f : 0.f)
                            : (s[c][e] == -INFINITY ? 0.f
                                                    : k6_exp(s[c][e], m[i]));
            s[c][e] = k6_norm(p, l[i], linv[i]);
          }
        uint32_t pa[4][4];
        pack_a(pa, s);
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
          mma_ab(o[hh], pa, vs + buf * T + hh * K6_TILE, ns);
      });
  if (!rows_final) finish_rows();
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
    store_rows(out + (long)bi * n * hd + h * dh + 64 * hh, hd, q0, n,
               qs + hh * K6_TILE, warp * 16, o[hh], dh - 64 * hh);
}

// dq and delta at heads of one half or of three or four, one block per
// (64-query tile, head, batch element).
// `stats`, `dout`: K6's lse and bf16 do, or the megablock's sm and fp32
// dattn; in megablock mode the kernel also writes dattn's two bf16 copies
// into `dcopy` (b*n x 2*heads*dh; half hh of head h, w = min(64, dh - 64
// hh) columns, at column 2 dh h + 128 hh: T(dattn * scale), then T(dattn)
// w columns on, in the 2 w bf16 its own w fp32 values held), which may
// alias dattn.
template <bool MEGA, int NH, bool FULL>
__global__ void __launch_bounds__(K6_THREADS, NH == 1 ? 3 : 1)
k6_bwd_dq_kernel(const bf16* __restrict__ qkv,
                 const uint8_t* __restrict__ mask,
                 const bf16* __restrict__ out, const float* __restrict__ stats,
                 const K6Cot<MEGA>* dout, bf16* dcopy,
                 bf16* __restrict__ dqkv, float* __restrict__ delta, int n,
                 int heads, int dh_arg, float scale, int causal,
                 int maybe_dead) {
  const int dh = FULL ? 64 * NH : dh_arg;  // whole halves fold it in
  constexpr int T = NH * K6_TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + T;
  bf16* ks = dos + T;     // two buffers
  bf16* vs = ks + 2 * T;  // two buffers
  auto* bits = reinterpret_cast<unsigned long long*>(vs + 2 * T);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64, h = blockIdx.y;
  const int bi = blockIdx.z, hd = heads * dh, tiles = (n + 63) / 64;
  const long ld = 3L * hd;
  const bf16* base = qkv + (long)bi * n * ld;
  const bf16* obase = out + (long)bi * n * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  auto stage = [&](int t, int buf) {
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      stage_tile_async<K6_THREADS>(ks + buf * T + hh * K6_TILE, base, ld,
                                   hd + h * dh + 64 * hh, 64 * t, n,
                                   dh - 64 * hh);
      stage_tile_async<K6_THREADS>(vs + buf * T + hh * K6_TILE, base, ld,
                                   2 * hd + h * dh + 64 * hh, 64 * t, n,
                                   dh - 64 * hh);
    }
  };
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    stage_tile_async<K6_THREADS>(qs + hh * K6_TILE, base, ld,
                                 h * dh + 64 * hh, q0, n, dh - 64 * hh);
    if constexpr (!MEGA)
      stage_tile_async<K6_THREADS>(dos + hh * K6_TILE,
                                   dout + (long)bi * n * hd, hd,
                                   h * dh + 64 * hh, q0, n, dh - 64 * hh);
  }
  cp_async_commit();
  const int fv = k6_key_tiles(bits, mask + (long)bi * n, n);
  // a dead row's ds is 0: only tiles with a valid key up to the diagonal
  const int last = causal ? min(tiles, q0 / 64 + 1) : tiles;
  auto next = [&](int t) {
    for (++t; t < last && !bits[t]; ++t) {
    }
    return t;
  };
  const int first = next(-1);
  // the warp's cuts: no product past n, no key from `kend` on
  const int r0 = q0 + warp * 16;
  const bool live = r0 < n;
  const int kend = causal ? min(n, r0 + 16) : n;
  int row[2];
  bool dead[2];
  float rm[2], rl[2], rinv[2];  // the row's m, l and 1 / l; K6: lse
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    dead[i] = maybe_dead && row[i] < n && (causal ? fv > row[i] : fv >= n);
    const long r = (long)bi * n + row[i];
    rm[i] = 0.f;
    rl[i] = 1.f;
    if (row[i] < n) {
      rm[i] = MEGA ? stats[r * 2 * heads + h] : stats[r * heads + h];
      if (MEGA) rl[i] = stats[r * 2 * heads + heads + h];
    }
    rinv[i] = 1.f / rl[i];
  }
  cp_async_wait<0>();
  __syncthreads();

  // delta: lanes 2r, 2r + 1 take half of each 64-column half of row r,
  // 8 columns at a time up to the head's true width. K6: sum do * out from
  // the staged do. Megablock: scale * sum dattn * attnout from the fp32
  // rows, which also give the A tile T(dattn * scale) (0 past the true
  // width) and the bf16 copies, half by half (each half's copies written
  // over its own fp32 values once the warp has read them).
  float rdelta[2];
  {
    const int r = warp * 16 + (lane >> 1);
    const long q = (long)bi * n + q0 + r;
    const bool in = q0 + r < n;
    float acc = 0.f;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const int d0 = (lane & 1) * 32, col = h * dh + 64 * hh + d0;
      const int w = min(64, dh - 64 * hh);  // the half's true columns
      bf16* dtile = dos + hh * K6_TILE;
      if constexpr (MEGA) {
        float dv[32];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 f =
              in && d0 + 8 * (c >> 1) < w
                  ? *reinterpret_cast<const float4*>(dout + q * hd + col +
                                                     4 * c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
          dv[4 * c] = f.x;
          dv[4 * c + 1] = f.y;
          dv[4 * c + 2] = f.z;
          dv[4 * c + 3] = f.w;
        }
        if (in) {
          const bf16* orow = out + q * hd + col;
#pragma unroll
          for (int c = 0; c < 32; c += 8) {
            const uint4 ov = load16_if(orow + c, d0 + c < w);
            const bf16* op = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
            for (int k = 0; k < 8; ++k) acc += dv[c + k] * to_f(op[k]) * scale;
          }
        }
        // the warp's fp32 reads are done before the copies, which may
        // overwrite them, are written
        __syncwarp();
        uint32_t sc[16], un[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          sc[k] = pack_bf16(dv[2 * k] * scale, dv[2 * k + 1] * scale);
          un[k] = pack_bf16(dv[2 * k], dv[2 * k + 1]);
        }
        bf16* crow = dcopy + q * 2 * hd + 2 * dh * h + 128 * hh + d0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint4 vsc = make_uint4(sc[4 * c], sc[4 * c + 1], sc[4 * c + 2],
                                       sc[4 * c + 3]);
          *reinterpret_cast<uint4*>(dtile + r * LDT + d0 + 8 * c) = vsc;
          if (in && d0 + 8 * c < w) {
            *reinterpret_cast<uint4*>(crow + 8 * c) = vsc;
            *reinterpret_cast<uint4*>(crow + w + 8 * c) = make_uint4(
                un[4 * c], un[4 * c + 1], un[4 * c + 2], un[4 * c + 3]);
          }
        }
        __syncwarp();  // the warp's rows of the A tile
      } else if (in) {
        const bf16* orow = obase + (long)(q0 + r) * hd + col;
#pragma unroll
        for (int c = 0; c < 32; c += 8) {
          // the staged do is 0 past the true width
          const uint4 ov = load16_if(orow + c, d0 + c < w);
          const uint4 dv =
              *reinterpret_cast<const uint4*>(dtile + r * LDT + d0 + c);
          const bf16* op = reinterpret_cast<const bf16*>(&ov);
          const bf16* dp = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc += to_f(dp[k]) * to_f(op[k]);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0 && in) delta[q * heads + h] = acc;
    rdelta[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    rdelta[1] = __shfl_sync(0xffffffffu, acc, 2 * g + 16);
  }
  HeadRows<NH> qa, da;
  qa.load(qs, warp * 16);
  da.load(dos, warp * 16);

  float dq[NH][8][4];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) zero_acc(dq[hh]);
  tile_walk(
      first, last, next, stage,
      [&](int t, int buf) {
        const int nc = tile_parts(kend - 64 * t, 8);
        if (!live || nc == 0) return;
        const bf16* kt = ks + buf * T;
        float s[8][4], dp[8][4];
        zero_acc(s);
        zero_acc(dp);
        qa.abt(s, kt, nc);
        da.abt(dp, vs + buf * T, nc);
        if (k6_full(bits[t], t, r0, causal)) {
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1;
              if (MEGA) {
                const float p = k6_norm(
                    k6_exp(__fmul_rn(s[c][e], scale), rm[i]), rl[i], rinv[i]);
                s[c][e] = p * (dp[c][e] - rdelta[i]);
              } else {
                const float p = k6_exp(s[c][e] * scale, rm[i]);
                s[c][e] = p * (dp[c][e] - rdelta[i]) * scale;
              }
            }
        } else {
          const KeyBits key(bits[t], tq);
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1, col = 8 * c + 2 * tq + (e & 1);
              const bool valid =
                  key(c, e & 1) && !(causal && 64 * t + col > row[i]);
              if (MEGA) {
                const float p =
                    valid ? k6_norm(k6_exp(__fmul_rn(s[c][e], scale), rm[i]),
                                    rl[i], rinv[i])
                          : 0.f;
                s[c][e] = dead[i] ? 0.f : p * (dp[c][e] - rdelta[i]);
              } else {
                const float p =
                    valid ? k6_exp(s[c][e] * scale, rm[i]) : 0.f;
                s[c][e] = dead[i] ? 0.f : p * (dp[c][e] - rdelta[i]) * scale;
              }
            }
        }
        const int ns = tile_parts(kend - 64 * t, 16);
        if constexpr (NH == 1) {
          uint32_t dsa[4][4];
          pack_a(dsa, s);
          mma_ab(dq[0], dsa, kt, ns);
        } else {
          // ds into the halves' products a 16-wide slice at a time
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (k >= ns) break;
            uint32_t a[4];
            pack_a_k(a, s, k);
#pragma unroll
            for (int hh = 0; hh < NH; ++hh)
              mma_ab_k(dq[hh], a, k, kt + hh * K6_TILE);
          }
        }
      });
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
    store_rows(dqkv + (long)bi * n * ld + h * dh + 64 * hh, ld, q0, n,
               qs + hh * K6_TILE, warp * 16, dq[hh], dh - 64 * hh);
}

// dk and dv, one block per (64-key tile, head, batch element), over the
// query tiles that reach it. `stats`: K6's lse or the megablock's sm;
// `dsrc`: K6's do (b*n x hd) or the megablock's `dcopy`, which the dq
// kernel wrote.
template <bool MEGA, int NH, bool FULL>
__global__ void __launch_bounds__(K6_THREADS * dkv_groups(NH),
                                  NH == 1 ? 3 : NH == 2 ? 2 : 1)
k6_bwd_dkv_kernel(const bf16* __restrict__ qkv,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ stats,
                  const bf16* __restrict__ dsrc,
                  const float* __restrict__ delta, bf16* __restrict__ dqkv,
                  int n, int heads, int dh_arg, float scale, int causal,
                  int maybe_dead) {
  const int dh = FULL ? 64 * NH : dh_arg;  // whole halves fold it in
  // a query tile's row terms: K6 lse, delta; megablock m, l, delta
  constexpr int NS = MEGA ? 3 : 2;
  constexpr int T = NH * K6_TILE;
  constexpr int CG = dkv_groups(NH), THREADS = K6_THREADS * CG;
  constexpr int NO = NH / CG + NH % CG;  // halves of dk, dv a group keeps
  // the megablock past one half: one buffer of do and one of T(dattn), so
  // that two blocks fit an SM at 128 and one at 256
  constexpr bool LEAN = MEGA && NH >= 2;
  constexpr int DB = LEAN ? 1 : 2;  // buffers of do and T(dattn)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + T;
  bf16* qs = vs + T;       // two buffers
  bf16* dos = qs + 2 * T;  // two buffers: do (megablock: scaled)
  bf16* dov = dos + DB * T;  // megablock: two buffers of T(dattn)
  float* rows = reinterpret_cast<float*>(dov + (MEGA ? DB * T : 0));
  auto* bits = reinterpret_cast<unsigned long long*>(rows + 2 * NS * 64);
  const int kt = blockIdx.x, k0 = 64 * kt, h = blockIdx.y, bi = blockIdx.z;
  const int hd = heads * dh, tiles = (n + 63) / 64;
  const long ld = 3L * hd, dld = MEGA ? 2L * hd : hd;
  const bf16* base = qkv + (long)bi * n * ld;
  const bf16* dbase = dsrc + (long)bi * n * dld;
  // half hh of the head's do: K6 at column dh h + 64 hh; the megablock's
  // scaled copy at 2 dh h + 128 hh, T(dattn) the half's width on
  const int dcol = MEGA ? 2 * dh * h : dh * h, dstep = MEGA ? 128 : 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slab = warp & 3, cg = warp >> 2;  // 16 keys; the group
  const int g = lane >> 2, tq = lane & 3;

  // the tile's row terms: K6 lse (threads 0-63) and delta (64-127);
  // megablock m (0-63), l (64-127), then delta (0-63)
  auto stage_rows = [&](int t, int buf) {
    if (threadIdx.x >= K6_THREADS) return;
    const int c = threadIdx.x & 63, q = 64 * t + c, k = threadIdx.x >> 6;
    const long r = q < n ? (long)bi * n + q : 0;
    if (MEGA) {
      cp_async4(rows + (buf * NS + k) * 64 + c,
                stats + r * 2 * heads + k * heads + h, q < n);
      if (k == 0)
        cp_async4(rows + (buf * NS + 2) * 64 + c, delta + r * heads + h,
                  q < n);
    } else {
      cp_async4(rows + (buf * NS + k) * 64 + c,
                (k == 0 ? stats : delta) + r * heads + h, q < n);
    }
  };
  auto stage_q = [&](int t, int buf) {
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
      stage_tile_async<THREADS>(qs + buf * T + hh * K6_TILE, base, ld,
                                h * dh + 64 * hh, 64 * t, n, dh - 64 * hh);
    stage_rows(t, buf);
  };
  auto stage_do = [&](int t, int buf) {
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const int w = min(64, dh - 64 * hh);
      stage_tile_async<THREADS>(dos + buf * T + hh * K6_TILE, dbase, dld,
                                dcol + dstep * hh, 64 * t, n, w);
      if (MEGA)
        stage_tile_async<THREADS>(dov + buf * T + hh * K6_TILE, dbase, dld,
                                  dcol + dstep * hh + w, 64 * t, n, w);
    }
  };
  auto stage = [&](int t, int buf) {
    stage_q(t, buf);
    stage_do(t, buf);
  };
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    stage_tile_async<THREADS>(ks + hh * K6_TILE, base, ld,
                              hd + h * dh + 64 * hh, k0, n, dh - 64 * hh);
    stage_tile_async<THREADS>(vs + hh * K6_TILE, base, ld,
                              2 * hd + h * dh + 64 * hh, k0, n, dh - 64 * hh);
  }
  cp_async_commit();
  const int fv = k6_key_tiles<THREADS>(bits, mask + (long)bi * n, n);
  const unsigned long long kw = bits[kt];
  // queries below `dead_end` are dead rows: their p = 1/n reaches every key
  const int dead_end =
      maybe_dead ? (causal ? min(fv, n) : (fv >= n ? n : 0)) : 0;
  auto next = [&](int t) {
    for (++t; t < tiles; ++t)
      if (64 * t < dead_end || (kw && !(causal && 64 * t + 63 < k0))) break;
    return t;
  };
  // the warp's 16 keys: none at or past n runs a product; all valid makes
  // a query tile full where every query is valid, live and (causal) at or
  // past them
  const int kw0 = k0 + slab * 16;
  const bool live = kw0 < n;
  const bool keys_full = ((kw >> (slab * 16)) & 0xffffull) == 0xffffull;
  int key[2];
  bool kvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = slab * 16 + g + 8 * i;
    key[i] = k0 + c;
    kvalid[i] = (kw >> c) & 1ull;
  }
  const float inv_n = 1.f / (float)n;
  const int first = next(-1);

  float dk[NO][8][4], dv[NO][8][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    zero_acc(dk[j]);
    zero_acc(dv[j]);
  }
  auto body = [&](int t, int buf) {
        if (!live) return;
        const int dbuf = LEAN ? 0 : buf;
        const bf16* qt = qs + buf * T;
        const bf16* dot = dos + dbuf * T;
        const float* tm = rows + buf * NS * 64;  // K6: lse
        const float* tl = tm + 64;               // megablock only
        const float* tdelta = tm + (NS - 1) * 64;
        const int nc = tile_parts(n - 64 * t, 8);
        const int ns = tile_parts(n - 64 * t, 16);
        const bool full = keys_full && 64 * t + 64 <= n && 64 * t >= dead_end &&
                          !(causal && kw0 + 15 > 64 * t);
        // registers bound the kernel (three blocks an SM): the A operands
        // pass one 16-wide depth slice at a time, and p and ds go into the
        // dv and dk products 16 queries at a time; a whole query tile takes
        // the products without a branch
        float s[8][4], dp[8][4];
        zero_acc(s);
        zero_acc(dp);
        auto products = [&](auto cut) {
          const int ncut = decltype(cut)::value ? nc : 8;
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int o = hh * K6_TILE;
              uint32_t a[4];
              load_a_k(a, ks + o, slab * 16, k);
              mma_abt_k(s, a, k, qt + o, ncut);  // sᵀ = k . qᵀ
              load_a_k(a, vs + o, slab * 16, k);
              mma_abt_k(dp, a, k, dot + o, ncut);  // dpᵀ = v . doᵀ
            }
        };
        if (nc < 8)
          products(std::true_type{});
        else
          products(std::false_type{});
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k >= ns) break;
#pragma unroll
          for (int c = 2 * k; c < 2 * k + 2; ++c)
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              // the column's row terms, once for the warp's two keys
              const int col = 8 * c + 2 * tq + e1, q = 64 * t + col;
              const float tmc = tm[col], tdc = tdelta[col];
              // megablock: 1 / l; l reads 0 past n, taken as 1
              const float tlc = MEGA && (full || q < n) ? tl[col] : 1.f;
              const float tli = 1.f / tlc;
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int e = 2 * i + e1;
                float p, ds;
                if (full) {
                  if (MEGA) {
                    p = k6_norm(k6_exp(__fmul_rn(s[c][e], scale), tmc), tlc,
                                tli);
                    ds = p * (dp[c][e] - tdc);
                  } else {
                    p = k6_exp(s[c][e] * scale, tmc);
                    ds = p * (dp[c][e] - tdc) * scale;
                  }
                } else if (MEGA) {
                  // (dead ? 1 : exp(s - m)) / l
                  const bool valid =
                      kvalid[i] && q < n && !(causal && key[i] > q);
                  float num = key[i] < n ? 1.f : 0.f;  // a dead row's
                  if (q >= dead_end)
                    num = valid ? k6_exp(__fmul_rn(s[c][e], scale), tmc) : 0.f;
                  p = k6_norm(num, tlc, tli);
                  ds = q < dead_end ? 0.f : p * (dp[c][e] - tdc);
                } else if (q < dead_end) {
                  p = key[i] < n ? inv_n : 0.f;
                  ds = 0.f;
                } else {
                  const bool valid =
                      kvalid[i] && q < n && !(causal && key[i] > q);
                  p = valid ? k6_exp(s[c][e] * scale, tmc) : 0.f;
                  ds = p * (dp[c][e] - tdc) * scale;
                }
                s[c][e] = p;
                dp[c][e] = ds;
              }
            }
          // the group's halves: dv += T(p)ᵀ . do, dk += T(ds)ᵀ . q
          uint32_t a[4];
          pack_a_k(a, s, k);
#pragma unroll
          for (int j = 0; j < NO; ++j) {
            const int hh = cg * NO + j;
            if (hh < NH)
              mma_ab_k(dv[j], a, k,
                       (MEGA ? dov + dbuf * T : dot) + hh * K6_TILE);
          }
          pack_a_k(a, dp, k);
#pragma unroll
          for (int j = 0; j < NO; ++j) {
            const int hh = cg * NO + j;
            if (hh < NH) mma_ab_k(dk[j], a, k, qt + hh * K6_TILE);
          }
        }
      };
  if constexpr (LEAN) {
    // q and the row terms one tile ahead as tile_walk stages them; do and
    // T(dattn) into their one buffer once the tile before has been read
    int t = first, buf = 0;
    if (t < tiles) {
      stage_q(t, 0);
      stage_do(t, 0);
    }
    cp_async_commit();
    while (t < tiles) {
      const int u = next(t);
      if (u < tiles) stage_q(u, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      body(t, buf);
      __syncthreads();
      if (u < tiles) stage_do(u, 0);
      cp_async_commit();
      t = u;
      buf ^= 1;
    }
  } else {
    tile_walk(first, tiles, next, stage, body);
  }
  cp_async_wait<0>();  // k and v have landed even if no tile was walked
  __syncthreads();
  bf16* dst = dqkv + (long)bi * n * ld + h * dh;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int hh = cg * NO + j;
    if (hh >= NH) break;
    store_rows(dst + hd + 64 * hh, ld, k0, n, ks + hh * K6_TILE, slab * 16,
               dk[j], dh - 64 * hh);
    store_rows(dst + 2 * hd + 64 * hh, ld, k0, n, vs + hh * K6_TILE,
               slab * 16, dv[j], dh - 64 * hh);
  }
}

// ------------------------------------------------- heads of 128 (NH = 2)

#define K6_ACC8(i)                                                        \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// D (64 x 64 fp32) (+)= A (64 x 16) . Bᵀ, A and B (64 x 16) K-major in
// shared memory
__device__ __forceinline__ void wgmma_s64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : K6_ACC8(0), K6_ACC8(8), K6_ACC8(16), K6_ACC8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128 fp32) += A (64 x 16, bf16 fragments in registers, the
// mma.sync A layout a warp a 16-row strip) . B (16 x 128, MN-major in
// shared memory)
__device__ __forceinline__ void wgmma_o128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : K6_ACC8(0), K6_ACC8(8), K6_ACC8(16), K6_ACC8(24), K6_ACC8(32),
        K6_ACC8(40), K6_ACC8(48), K6_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef K6_ACC8

// The forward at heads of two halves (72 to 128 columns) on wgmma, one
// block of WG warpgroups per (64 WG-query tile, head, batch element), the
// walk, cuts and statistics of k6_fwd_kernel. Thread 0 loads by TMA (a 4-D
// map over (b, n, 3 heads, dh), which zero-fills rows past n of each batch
// element and a head's columns past dh) q once and the walk's key
// tiles one step ahead into a ring of two stages (k; in pass 2 k and v),
// each completing on its mbarrier, 128-byte swizzled as wgmma reads them.
// s = q . kᵀ is eight m64n64k16 products from shared memory (no q
// fragments in registers); T(p / l) . v is m64n128k16 with p from
// registers and v MN-major, only over the 16-key slices some row of the
// warpgroup reads. The accumulator of m64nN is mma.sync's a warp: warp w holds
// rows 16 w + g and + 8, columns 8 c + 2 tq + {0, 1}, so the masks, the
// quad reductions and the statistics are k6_fwd_kernel's.
template <bool MEGA, int WG, bool FULL>
__global__ void __launch_bounds__(K6_THREADS * WG, WG == 1 ? 2 : 1)
k6_fwd_wg_kernel(const __grid_constant__ CUtensorMap qkv_map,
                 const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                 float* __restrict__ stats, int n, int heads, int dh_arg,
                 float scale, int causal, int maybe_dead) {
  const int dh = FULL ? 128 : dh_arg;  // whole halves fold it in
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle atoms repeat every 1024 bytes: align the tiles to them
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // warpgroup w's q at panels 2 w, 2 w + 1; then the ring
  unsigned char* ring = smem + 2 * WG * kPanel;  // stage s: k 4 s, v 4 s + 2
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + 8 * kPanel);
  auto* bits = reinterpret_cast<unsigned long long*>(bar + 3);
  const CUtensorMap* map = &qkv_map;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64 * WG, h = blockIdx.y;
  const int bi = blockIdx.z, hd = heads * dh, tiles = (n + 63) / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2, tq = lane & 3;
  const bool leader = threadIdx.x == 0;
  if (leader) {  // q, then stages 0 and 1
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&bar[0], 2 * WG * kPanel);
#pragma unroll
    for (int w = 0; w < WG; ++w)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        tma_load_4d(smem + (2 * w + hh) * kPanel, map, &bar[0], 64 * hh, h,
                    q0 + 64 * w, bi);
  }
  const int fv = k6_key_tiles<K6_THREADS * WG>(bits, mask + (long)bi * n, n);
  const bool dead_block = maybe_dead && (causal ? fv > q0 : fv >= n);
  const int last =
      causal && !dead_block ? min(tiles, q0 / 64 + WG) : tiles;
  auto next_tile = [&](int t) {
    for (++t; t < last && !dead_block && !bits[t]; ++t) {
    }
    return t;
  };
  constexpr int END = 128;
  const int first = next_tile(-1);
  auto next = [&](int st) {
    const int u = next_tile(st & 63);
    if (u < last) return (st & 64) + u;
    return st < 64 ? 64 + first : END;
  };
  const int first_step = first < last ? first : END;
  auto issue = [&](int st, int s) {
    const int t = st & 63;
    mbar_expect_tx(&bar[1 + s], (st >= 64 ? 4 : 2) * kPanel);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tma_load_4d(ring + (4 * s + hh) * kPanel, map, &bar[1 + s], 64 * hh,
                  heads + h, 64 * t, bi);
      if (st >= 64)
        tma_load_4d(ring + (4 * s + 2 + hh) * kPanel, map, &bar[1 + s],
                    64 * hh, 2 * heads + h, 64 * t, bi);
    }
  };
  uint32_t parity = 0;  // bit s: the phase stage s completes next
  if (leader && first_step < END) issue(first_step, 0);
  // the warp's cuts as k6_fwd_kernel's; the products run for the whole
  // warpgroup, p . v over the slices up to its last key `pend_wg`
  const int r0 = q0 + warp * 16;
  const bool live = r0 < n;
  const bool warp_dead = maybe_dead && live && (causal ? fv > r0 : fv >= n);
  const int kend = causal ? min(n, r0 + 16) : n;
  const int pend = warp_dead ? n : kend;
  const int pend_wg = causal && !dead_block ? min(n, q0 + 64 * wg + 64) : n;
  int row[2];
  bool dead[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    dead[i] = maybe_dead && row[i] < n && (causal ? fv > row[i] : fv >= n);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, linv[2];
  bool rows_final = false;
  auto finish_rows = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float sum = quad_sum(l[i]);  // every lane shuffles
      l[i] = dead[i] ? (float)n : fmaxf(sum, 1e-30f);
      linv[i] = 1.f / l[i];
      if (dead[i]) m[i] = 0.f;
      const long r = (long)bi * n + row[i];
      if (tq != 0 || row[i] >= n) continue;
      if (!MEGA) {
        stats[r * heads + h] = m[i] + logf(l[i]);
      } else if (stats) {
        stats[r * 2 * heads + h] = m[i];
        stats[r * 2 * heads + heads + h] = l[i];
      }
    }
    rows_final = true;
  };
  float o[2][8][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) zero_acc(o[hh]);
  float(&oacc)[64] = *reinterpret_cast<float(*)[64]>(&o[0][0][0]);
  const uint32_t qaddr = smem_u32(smem + 2 * wg * kPanel);
  mbar_wait(&bar[0], 0);  // q (waited on even if no tile is walked)
  int s = 0;
  for (int st = first_step; st < END;) {
    const int u = next(st);
    if (leader && u < END) issue(u, s ^ 1);
    mbar_wait(&bar[1 + s], (parity >> s) & 1);
    parity ^= 1u << s;
    const int t = st & 63;
    const uint32_t kaddr = smem_u32(ring + 4 * s * kPanel);
    float sc[8][4];
    float(&sacc)[32] = *reinterpret_cast<float(*)[32]>(&sc[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {  // 16 deeper: 32 bytes, then a panel
      const uint32_t off = (kk >> 2) * kPanel + (kk & 3) * 32;
      wgmma_s64(sacc, smem_desc(qaddr + off, 16, 1024),
                smem_desc(kaddr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sacc);
    const bool full = k6_full(bits[t], t, r0, causal);
    const int nc = tile_parts(kend - 64 * t, 8);
    if (st < 64) {
      if (live && nc > 0) {
        k6_mask(sc, t, bits[t], full, row, scale, causal);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mt = -INFINITY;
#pragma unroll
          for (int c = 0; c < 8; ++c)
            mt = fmaxf(mt, fmaxf(sc[c][2 * i], sc[c][2 * i + 1]));
          const float mn = fmaxf(m[i], quad_max(mt));
          if (mn != -INFINITY) {  // the same in the whole quad
            float sum = l[i] * k6_exp(m[i], mn);
#pragma unroll
            for (int c = 0; c < 8; ++c)
              sum += k6_exp(sc[c][2 * i], mn) + k6_exp(sc[c][2 * i + 1], mn);
            l[i] = sum;
            m[i] = mn;
          }
        }
      }
    } else {
      if (!rows_final) finish_rows();
      const int ns = tile_parts(pend - 64 * t, 16);
      if (live && ns > 0) {
        if (nc > 0) {
          k6_mask(sc, t, bits[t], full, row, scale, causal);
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[c][e] = -INFINITY;
        }
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int j = 64 * t + 8 * c + 2 * tq + (e & 1);
            const float p = full ? k6_exp(sc[c][e], m[i])
                            : dead[i] ? (j < n ? 1.f : 0.f)
                            : (sc[c][e] == -INFINITY ? 0.f
                                                     : k6_exp(sc[c][e], m[i]));
            sc[c][e] = k6_norm(p, l[i], linv[i]);
          }
      } else {
        zero_acc(sc);
      }
      const int nsb = tile_parts(pend_wg - 64 * t, 16);
      const uint32_t vaddr = kaddr + 2 * kPanel;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < nsb) {
          uint32_t a[4];
          pack_a_k(a, sc, k);
          wgmma_o128(oacc, a, smem_desc(vaddr + k * 2048, kPanel, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(oacc);
    }
    __syncthreads();  // every warp is done with stage s before it reloads
    s ^= 1;
    st = u;
  }
  if (!rows_final) finish_rows();
  // the ring, idle now, stages the rows for 16-byte stores
  bf16* stage = reinterpret_cast<bf16*>(ring);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    store_rows(out + (long)bi * n * hd + h * dh + 64 * hh, hd, q0 + 64 * wg,
               n, stage + (2 * wg + hh) * K6_TILE, (warp & 3) * 16, o[hh],
               dh - 64 * hh);
}

// dq and delta at heads of two halves on wgmma, one block of one warpgroup per
// (64-query tile, head, batch element), the walk, cuts and row terms of
// k6_bwd_dq_kernel. Thread 0 loads by TMA q (and K6's do) once and the
// walk's k and v tiles one ahead into a ring of two stages; in megablock
// mode the warps write the A tile T(dattn * scale) into the swizzled
// panels themselves (beside the two bf16 copies in `dcopy`), and K6 sums
// delta from do's rows in global memory. s = q . kᵀ and dp = do . vᵀ are
// eight m64n64k16 products each from shared memory; dq += T(ds) . k is
// m64n128k16 with ds from registers and k MN-major, over the 16-key
// slices some row of the block reads.
template <bool MEGA, bool FULL>
__global__ void __launch_bounds__(K6_THREADS, 2)
k6_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap qkv_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const uint8_t* __restrict__ mask,
                    const bf16* __restrict__ out,
                    const float* __restrict__ stats, const K6Cot<MEGA>* dout,
                    bf16* dcopy, bf16* __restrict__ dqkv,
                    float* __restrict__ delta, int n, int heads, int dh_arg,
                    float scale, int causal, int maybe_dead) {
  const int dh = FULL ? 128 : dh_arg;  // whole halves fold it in
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* dos = smem + 2 * kPanel;   // K6 do; megablock T(dattn s)
  unsigned char* ring = smem + 4 * kPanel;  // stage s: k at 4 s, v 4 s + 2
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + 8 * kPanel);
  auto* bits = reinterpret_cast<unsigned long long*>(bar + 3);
  const CUtensorMap* qmap = &qkv_map;
  const CUtensorMap* dmap = &do_map;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64, h = blockIdx.y;
  const int bi = blockIdx.z, hd = heads * dh, tiles = (n + 63) / 64;
  const long ld = 3L * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bool leader = threadIdx.x == 0;
  if (leader) {  // q (and K6's do), then stages 0 and 1
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&bar[0], (MEGA ? 2 : 4) * kPanel);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tma_load_4d(smem + hh * kPanel, qmap, &bar[0], 64 * hh, h, q0, bi);
      if (!MEGA)
        tma_load_4d(dos + hh * kPanel, dmap, &bar[0], 64 * hh, h, q0, bi);
    }
  }
  const int fv = k6_key_tiles(bits, mask + (long)bi * n, n);
  // a dead row's ds is 0: only tiles with a valid key up to the diagonal
  const int last = causal ? min(tiles, q0 / 64 + 1) : tiles;
  auto next = [&](int t) {
    for (++t; t < last && !bits[t]; ++t) {
    }
    return t;
  };
  const int first = next(-1);
  auto issue = [&](int t, int s) {
    mbar_expect_tx(&bar[1 + s], 4 * kPanel);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tma_load_4d(ring + (4 * s + hh) * kPanel, qmap, &bar[1 + s], 64 * hh,
                  heads + h, 64 * t, bi);
      tma_load_4d(ring + (4 * s + 2 + hh) * kPanel, qmap, &bar[1 + s],
                  64 * hh, 2 * heads + h, 64 * t, bi);
    }
  };
  uint32_t parity = 0;  // bit s: the phase stage s completes next
  if (leader && first < last) issue(first, 0);
  const int r0 = q0 + warp * 16;
  const bool live = r0 < n;
  const int kend = causal ? min(n, r0 + 16) : n;
  const int kend_blk = causal ? min(n, q0 + 64) : n;
  int row[2];
  bool dead[2];
  float rm[2], rl[2], rinv[2];  // the row's m, l and 1 / l; K6: lse
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    dead[i] = maybe_dead && row[i] < n && (causal ? fv > row[i] : fv >= n);
    const long r = (long)bi * n + row[i];
    rm[i] = 0.f;
    rl[i] = 1.f;
    if (row[i] < n) {
      rm[i] = MEGA ? stats[r * 2 * heads + h] : stats[r * heads + h];
      if (MEGA) rl[i] = stats[r * 2 * heads + heads + h];
    }
    rinv[i] = 1.f / rl[i];
  }

  // delta as k6_bwd_dq_kernel's: lanes 2r, 2r + 1 take half of each
  // 64-column half of row r up to the true width; K6 reads do from global
  // memory, the megablock its fp32 rows, which also give the A tile
  // (16-byte chunk c of a panel's row r at chunk c ^ (r % 8), the 128-byte
  // swizzle; 0 past the true width) and the bf16 copies
  float rdelta[2];
  {
    const int r = warp * 16 + (lane >> 1);
    const long q = (long)bi * n + q0 + r;
    const bool in = q0 + r < n;
    float acc = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int d0 = (lane & 1) * 32, col = h * dh + 64 * hh + d0;
      const int w = min(64, dh - 64 * hh);  // the half's true columns
      if constexpr (MEGA) {
        float dv[32];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 f =
              in && d0 + 8 * (c >> 1) < w
                  ? *reinterpret_cast<const float4*>(dout + q * hd + col +
                                                     4 * c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
          dv[4 * c] = f.x;
          dv[4 * c + 1] = f.y;
          dv[4 * c + 2] = f.z;
          dv[4 * c + 3] = f.w;
        }
        if (in) {
          const bf16* orow = out + q * hd + col;
#pragma unroll
          for (int c = 0; c < 32; c += 8) {
            const uint4 ov = load16_if(orow + c, d0 + c < w);
            const bf16* op = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
            for (int k = 0; k < 8; ++k) acc += dv[c + k] * to_f(op[k]) * scale;
          }
        }
        // the warp's fp32 reads are done before the copies, which may
        // overwrite them, are written
        __syncwarp();
        uint32_t sc[16], un[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          sc[k] = pack_bf16(dv[2 * k] * scale, dv[2 * k + 1] * scale);
          un[k] = pack_bf16(dv[2 * k], dv[2 * k + 1]);
        }
        bf16* crow = dcopy + q * 2 * hd + 2 * dh * h + 128 * hh + d0;
        unsigned char* arow = dos + hh * kPanel + r * 128;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint4 vsc = make_uint4(sc[4 * c], sc[4 * c + 1], sc[4 * c + 2],
                                       sc[4 * c + 3]);
          *reinterpret_cast<uint4*>(
              arow + ((((d0 >> 3) + c) ^ (r & 7)) << 4)) = vsc;
          if (in && d0 + 8 * c < w) {
            *reinterpret_cast<uint4*>(crow + 8 * c) = vsc;
            *reinterpret_cast<uint4*>(crow + w + 8 * c) = make_uint4(
                un[4 * c], un[4 * c + 1], un[4 * c + 2], un[4 * c + 3]);
          }
        }
      } else if (in) {
        const bf16* orow = out + q * hd + col;
        const bf16* drow = dout + q * hd + col;
#pragma unroll
        for (int c = 0; c < 32; c += 8) {
          const uint4 ov = load16_if(orow + c, d0 + c < w);
          const uint4 dv = load16_if(drow + c, d0 + c < w);
          const bf16* op = reinterpret_cast<const bf16*>(&ov);
          const bf16* dp = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc += to_f(dp[k]) * to_f(op[k]);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0 && in) delta[q * heads + h] = acc;
    rdelta[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    rdelta[1] = __shfl_sync(0xffffffffu, acc, 2 * g + 16);
  }
  // the megablock's A tile, written by the warps, is read by wgmma (the
  // async proxy) once every warp has written it
  if (MEGA) fence_async_smem();
  mbar_wait(&bar[0], 0);
  __syncthreads();

  float dq[2][8][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) zero_acc(dq[hh]);
  float(&dqacc)[64] = *reinterpret_cast<float(*)[64]>(&dq[0][0][0]);
  const uint32_t qaddr = smem_u32(smem), daddr = smem_u32(dos);
  int s = 0;
  for (int t = first; t < last;) {
    const int u = next(t);
    if (leader && u < last) issue(u, s ^ 1);
    mbar_wait(&bar[1 + s], (parity >> s) & 1);
    parity ^= 1u << s;
    const uint32_t kaddr = smem_u32(ring + 4 * s * kPanel);
    const uint32_t vaddr = kaddr + 2 * kPanel;
    float sc[8][4], dp[8][4];
    float(&sacc)[32] = *reinterpret_cast<float(*)[32]>(&sc[0][0]);
    float(&dpacc)[32] = *reinterpret_cast<float(*)[32]>(&dp[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {  // 16 deeper: 32 bytes, then a panel
      const uint32_t off = (kk >> 2) * kPanel + (kk & 3) * 32;
      wgmma_s64(sacc, smem_desc(qaddr + off, 16, 1024),
                smem_desc(kaddr + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk >> 2) * kPanel + (kk & 3) * 32;
      wgmma_s64(dpacc, smem_desc(daddr + off, 16, 1024),
                smem_desc(vaddr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sacc);
    fence_acc(dpacc);
    const int nc = tile_parts(kend - 64 * t, 8);
    if (live && nc > 0) {
      if (k6_full(bits[t], t, r0, causal)) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            if (MEGA) {
              const float p = k6_norm(
                  k6_exp(__fmul_rn(sc[c][e], scale), rm[i]), rl[i], rinv[i]);
              sc[c][e] = p * (dp[c][e] - rdelta[i]);
            } else {
              const float p = k6_exp(sc[c][e] * scale, rm[i]);
              sc[c][e] = p * (dp[c][e] - rdelta[i]) * scale;
            }
          }
      } else {
        const KeyBits key(bits[t], tq);
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, col = 8 * c + 2 * tq + (e & 1);
            const bool valid =
                key(c, e & 1) && !(causal && 64 * t + col > row[i]);
            if (MEGA) {
              const float p =
                  valid ? k6_norm(k6_exp(__fmul_rn(sc[c][e], scale), rm[i]),
                                  rl[i], rinv[i])
                        : 0.f;
              sc[c][e] = dead[i] ? 0.f : p * (dp[c][e] - rdelta[i]);
            } else {
              const float p = valid ? k6_exp(sc[c][e] * scale, rm[i]) : 0.f;
              sc[c][e] = dead[i] ? 0.f : p * (dp[c][e] - rdelta[i]) * scale;
            }
          }
      }
    } else {
      zero_acc(sc);
    }
    const int nsb = tile_parts(kend_blk - 64 * t, 16);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < nsb) {
        uint32_t a[4];
        pack_a_k(a, sc, k);
        wgmma_o128(dqacc, a, smem_desc(kaddr + k * 2048, kPanel, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dqacc);
    __syncthreads();  // every warp is done with stage s before it reloads
    s ^= 1;
    t = u;
  }
  // the ring, idle now, stages the rows for 16-byte stores
  bf16* stage = reinterpret_cast<bf16*>(ring);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    store_rows(dqkv + (long)bi * n * ld + h * dh + 64 * hh, ld, q0, n,
               stage + hh * K6_TILE, warp * 16, dq[hh], dh - 64 * hh);
}

// shared memory of a head of NH 64-column halves (megablock dk/dv at NH 1:
// 8 tiles, 75,520 bytes; at NH 2: 112,384 with one buffer of do and of
// T(dattn); at NH 4: 24 tiles, 222,976)
template <int NH>
constexpr size_t k6_fwd_smem() {
  return 5 * NH * K6_TILE * sizeof(bf16) + K6_MAX_TILES * 8;
}
template <int NH>
constexpr size_t k6_dq_smem() {
  return 6 * NH * K6_TILE * sizeof(bf16) + K6_MAX_TILES * 8;
}
template <int NH>
constexpr size_t k6_dkv_smem(bool mega) {
  const int db = mega && NH >= 2 ? 1 : 2;
  return (mega ? 4 + 2 * db : 6) * NH * K6_TILE * sizeof(bf16) +
         2 * (mega ? 3 : 2) * 64 * sizeof(float) + K6_MAX_TILES * 8;
}
// the wgmma forward of WG warpgroups: q and a ring of two stages of k and
// v in 64-row panels, three mbarriers and the mask words, 1024-byte
// aligned (83,224 bytes at WG 1)
template <int WG>
constexpr size_t k6_fwd_wg_smem() {
  return 1024 + (2 * WG + 8) * kPanel + 3 * 8 + K6_MAX_TILES * 8;
}
// the wgmma dq kernel: q, do and the ring of the forward's, 99,608 bytes
constexpr size_t k6_dq_wg_smem() {
  return 1024 + 12 * kPanel + 3 * 8 + K6_MAX_TILES * 8;
}
// every kernel under the 232,448 bytes a block may opt in to; at four
// halves the dk/dv kernel only with one buffer of the megablock's do and
// T(dattn) (two would take 294,912 bytes)
static_assert(k6_fwd_smem<4>() <= 232448 && k6_dq_smem<4>() <= 232448,
              "the forward and dq kernels at four halves fit a block");
static_assert(k6_dkv_smem<4>(false) <= 232448 &&
                  k6_dkv_smem<4>(true) <= 232448,
              "the dk/dv kernels at four halves fit a block");
static_assert(k6_fwd_wg_smem<K6_WG_ROWS / 64>() <= 232448 &&
                  k6_dq_wg_smem() <= 232448,
              "the wgmma kernels fit a block");

// Allow a kernel its dynamic shared memory; the cudaError_t.
template <typename K>
inline cudaError_t k6_allow(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// A 4-D map over the (b, n, slots, dh) view of a row-major (b*n x slots*dh)
// matrix (qkv: 3 heads slots; K6's do: heads), each box one slot's 64
// columns at 64 . hh by 64 rows, 128-byte swizzled: rows past n of each
// batch element and a head's columns past dh read 0. dh a multiple of 8
// (the slot stride of 2 dh bytes a multiple of 16).
inline bool encode_head_map(CUtensorMap* map, const bf16* base, int dh,
                            int slots, int n, int b) {
  EncodeTiled fn = encode_tiled();
  if (!fn || reinterpret_cast<uintptr_t>(base) % 16 || dh % 8) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)slots,
                              (cuuint64_t)n, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)slots * dh * 2,
                                 (cuuint64_t)n * slots * dh * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<bf16*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool MEGA, int NH>
inline int launch_k6_fwd_nh(const bf16* qkv, const uint8_t* mask, bf16* out,
                            float* stats, int b, int n, int heads, int dh,
                            float scale, int causal, int maybe_dead,
                            cudaStream_t st) {
  return by_width<NH>(dh, [&](auto full) {
    constexpr bool FULL = decltype(full)::value;
    if constexpr (NH == 2) {
      constexpr int WG = K6_WG_ROWS / 64;
      CUtensorMap map;
      if (!encode_head_map(&map, qkv, dh, 3 * heads, n, b))
        return (int)cudaErrorInvalidValue;
      auto* kernel = k6_fwd_wg_kernel<MEGA, WG, FULL>;
      const cudaError_t e = k6_allow(kernel, k6_fwd_wg_smem<WG>());
      if (e != cudaSuccess) return (int)e;
      kernel<<<dim3((n + 64 * WG - 1) / (64 * WG), heads, b),
               K6_THREADS * WG, k6_fwd_wg_smem<WG>(), st>>>(
          map, mask, out, stats, n, heads, dh, scale, causal, maybe_dead);
    } else {
      auto* kernel = k6_fwd_kernel<MEGA, NH, FULL>;
      const cudaError_t e = k6_allow(kernel, k6_fwd_smem<NH>());
      if (e != cudaSuccess) return (int)e;
      kernel<<<dim3((n + 63) / 64, heads, b), K6_THREADS, k6_fwd_smem<NH>(),
               st>>>(qkv, mask, out, stats, n, heads, dh, scale, causal,
                     maybe_dead);
    }
    XCLIP_CHECK_LAUNCH();
    return 0;
  });
}

// out (b*n x hd) and the row statistics (K6: lse, b*n x heads; megablock:
// sm, b*n x 2*heads, or null) from qkv (b*n x 3hd), hd = heads * dh, dh a
// width bf16_halves takes.
template <bool MEGA>
inline int launch_k6_fwd(const bf16* qkv, const uint8_t* mask, bf16* out,
                         float* stats, int b, int n, int heads, int dh,
                         float scale, int causal, int maybe_dead,
                         cudaStream_t st) {
  auto* launch = launch_k6_fwd_nh<MEGA, 1>;
  switch (n > K6_MAX_N ? 0 : bf16_halves(dh)) {
    case 1: break;
    case 2: launch = launch_k6_fwd_nh<MEGA, 2>; break;
    case 3: launch = launch_k6_fwd_nh<MEGA, 3>; break;
    case 4: launch = launch_k6_fwd_nh<MEGA, 4>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return launch(qkv, mask, out, stats, b, n, heads, dh, scale, causal,
                maybe_dead, st);
}

// dqkv (b*n x 3hd) from qkv, out, the statistics and the row cotangent
// (K6: lse and the bf16 do; megablock: sm and the fp32 dattn, whose bf16
// copies go to `dcopy`, b*n x 2hd, which may alias dattn); delta (b*n x
// heads, fp32) is scratch the dq kernel writes and the dk/dv kernel reads.
template <bool MEGA, int NH>
inline int launch_k6_bwd_nh(const bf16* qkv, const uint8_t* mask,
                            const bf16* out, const float* stats,
                            const K6Cot<MEGA>* dout, bf16* dcopy, bf16* dqkv,
                            float* delta, int b, int n, int heads, int dh,
                            float scale, int causal, int maybe_dead,
                            cudaStream_t st) {
  return by_width<NH>(dh, [&](auto full) {
    constexpr bool FULL = decltype(full)::value;
    const dim3 grid((n + 63) / 64, heads, b);
    cudaError_t e;
    if constexpr (NH == 2) {
      // 4-D maps over qkv (3 heads slots) and K6's do (heads)
      CUtensorMap qmap, dmap;
      if (!encode_head_map(&qmap, qkv, dh, 3 * heads, n, b))
        return (int)cudaErrorInvalidValue;
      dmap = qmap;
      if (!MEGA &&
          !encode_head_map(&dmap, reinterpret_cast<const bf16*>(dout), dh,
                           heads, n, b))
        return (int)cudaErrorInvalidValue;
      auto* kernel = k6_bwd_dq_wg_kernel<MEGA, FULL>;
      e = k6_allow(kernel, k6_dq_wg_smem());
      if (e != cudaSuccess) return (int)e;
      kernel<<<grid, K6_THREADS, k6_dq_wg_smem(), st>>>(
          qmap, dmap, mask, out, stats, dout, dcopy, dqkv, delta, n, heads,
          dh, scale, causal, maybe_dead);
    } else {
      auto* kernel = k6_bwd_dq_kernel<MEGA, NH, FULL>;
      e = k6_allow(kernel, k6_dq_smem<NH>());
      if (e != cudaSuccess) return (int)e;
      kernel<<<grid, K6_THREADS, k6_dq_smem<NH>(), st>>>(
          qkv, mask, out, stats, dout, dcopy, dqkv, delta, n, heads, dh,
          scale, causal, maybe_dead);
    }
    XCLIP_CHECK_LAUNCH();
    const bf16* dsrc;
    if constexpr (MEGA)
      dsrc = dcopy;
    else
      dsrc = dout;
    auto* kernel = k6_bwd_dkv_kernel<MEGA, NH, FULL>;
    e = k6_allow(kernel, k6_dkv_smem<NH>(MEGA));
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, K6_THREADS * dkv_groups(NH), k6_dkv_smem<NH>(MEGA),
             st>>>(qkv, mask, stats, dsrc, delta, dqkv, n, heads, dh, scale,
                   causal, maybe_dead);
    XCLIP_CHECK_LAUNCH();
    return 0;
  });
}

template <bool MEGA>
inline int launch_k6_bwd(const bf16* qkv, const uint8_t* mask, const bf16* out,
                         const float* stats, const K6Cot<MEGA>* dout,
                         bf16* dcopy, bf16* dqkv, float* delta, int b, int n,
                         int heads, int dh, float scale, int causal,
                         int maybe_dead, cudaStream_t st) {
  auto* launch = launch_k6_bwd_nh<MEGA, 1>;
  switch (n > K6_MAX_N ? 0 : bf16_halves(dh)) {
    case 1: break;
    case 2: launch = launch_k6_bwd_nh<MEGA, 2>; break;
    case 3: launch = launch_k6_bwd_nh<MEGA, 3>; break;
    case 4: launch = launch_k6_bwd_nh<MEGA, 4>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return launch(qkv, mask, out, stats, dout, dcopy, dqkv, delta, b, n, heads,
                dh, scale, causal, maybe_dead, st);
}

// Blocks (warps with `warps`) an SM of a bf16 kernel at head width dh, as
// its launch configures it: the forward (`which` -1) or the backward's dq
// (0) or dk/dv (1) kernel, K6's (mega false) or the megablock's; a
// negative cudaError_t code on failure.
template <typename K>
inline int k6_resident(K kernel, int threads, size_t smem, bool warps) {
  int blocks = 0;
  cudaError_t e = k6_allow(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return -(int)e;
  return warps ? blocks * threads / 32 : blocks;
}
template <bool MEGA, int NH>
inline int k6_blocks_nh(int which, int dh, bool warps) {
  return by_width<NH>(dh, [&](auto full) {
    constexpr bool FULL = decltype(full)::value;
    if (which < 0) {
      if constexpr (NH == 2)
        return k6_resident(k6_fwd_wg_kernel<MEGA, K6_WG_ROWS / 64, FULL>,
                           K6_WG_ROWS * 2, k6_fwd_wg_smem<K6_WG_ROWS / 64>(),
                           warps);
      else
        return k6_resident(k6_fwd_kernel<MEGA, NH, FULL>, K6_THREADS,
                           k6_fwd_smem<NH>(), warps);
    }
    if (which == 0) {
      if constexpr (NH == 2)
        return k6_resident(k6_bwd_dq_wg_kernel<MEGA, FULL>, K6_THREADS,
                           k6_dq_wg_smem(), warps);
      else
        return k6_resident(k6_bwd_dq_kernel<MEGA, NH, FULL>, K6_THREADS,
                           k6_dq_smem<NH>(), warps);
    }
    return k6_resident(k6_bwd_dkv_kernel<MEGA, NH, FULL>,
                       K6_THREADS * dkv_groups(NH), k6_dkv_smem<NH>(MEGA),
                       warps);
  });
}
template <bool MEGA>
inline int k6_blocks(int which, int dh, bool warps) {
  switch (bf16_halves(dh)) {
    case 1: return k6_blocks_nh<MEGA, 1>(which, dh, warps);
    case 2: return k6_blocks_nh<MEGA, 2>(which, dh, warps);
    case 3: return k6_blocks_nh<MEGA, 3>(which, dh, warps);
    case 4: return k6_blocks_nh<MEGA, 4>(which, dh, warps);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace xclip
