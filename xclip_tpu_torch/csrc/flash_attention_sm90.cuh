// K7 in bf16: FlashAttention-2 forward and backward on register-resident
// mma.sync tiles, in place of the Pallas bodies of
// xclip_tpu/kernels/flash_attention.py: the forward `_fwd_kernel` (:66,
// through `_flash_forward` :101) and the backward `_bwd_dq_kernel` (:134)
// and `_bwd_dkv_kernel` (:156, through `_flash_backward` :182). The numbers
// are theirs (csrc/flash_attention.cu gives the semantics): an online
// softmax over 64-key tiles in fp32 with p rounded to bf16 against the
// running max before p . v; l = max(l, 1e-30), out = T(acc / l), lse =
// m_safe + log l (a row with no valid key: out 0, lse log 1e-30); the
// backward's p = exp(s - lse), 0 on masked entries, ds = p (dp - delta),
// dq = T(ds) . k, dk = T(ds)ᵀ . q, dv = T(p)ᵀ . dO, each rounded once.
// exp is taken as 2^(x log2 e) (`k7_exp`).
//
// What bounds it on the card: bytes. At the text tower's shape (b·h 2048,
// n 256, causal, key pads uniform in n/2..n) the forward reads q and the k
// and v of the valid keys and writes out and lse (0.072 ms at 3.35 TB/s);
// the backward also reads out, dO and lse and writes dq, dk and dv (0.152
// ms); the products are ~16 GFLOP forward and ~40 backward, 0.016 and
// 0.040 ms of the tensor cores. The wmma kernels this replaces (still the
// fp32 path of flash_attention.cu) lost their time elsewhere, and the
// design answers each:
//   * scores went through shared memory as fp32 (wmma fragments have no
//     row layout), were swept three times by two threads a row, written
//     back as bf16 p, and the accumulator was rescaled in shared memory,
//     five barriers a key tile: here a block is 64 queries (forward, dq)
//     or 64 keys (dk/dv) of one bh row, 4 warps of 16 rows on mma.sync
//     m16n8k16 with ldmatrix (mma_tiles.cuh). Scores, dp and the out / dq
//     / dk / dv accumulators stay in registers, row statistics reduce over
//     the quad with shuffles, p and ds pass from an accumulator to the
//     next product's A operand through `pack_a`, and the forward rescales
//     its accumulator by the correction in registers: no score tile
//     exists in shared memory, and a key tile costs two barriers;
//   * tiles were staged by synchronous loads, each load exposed: here the
//     other side's 64-row tiles stream through a double-buffered cp.async
//     ring (`tile_walk`), the next tile landing while this one computes;
//   * shared memory (72, 99 and 125 KB) held 3, 2 and 1 blocks an SM:
//     here 45 KB forward (q and two k, v buffers) and 54 KB dq, 55 KB
//     dk/dv (q, dO or k, v and two buffers of the other pair), so
//     registers set the blocks an SM: 4 forward, 3 dq and dk/dv;
//   * only key tiles past the causal diagonal were skipped: here the
//     forward and dq also skip every key tile whose 64 mask bits are all
//     zero (exact: over such a tile the recurrence leaves m, l and acc
//     bit-equal, and ds is 0), and a dk/dv block whose key tile has no
//     valid key writes zeros and returns. Unlike K6 no row is uniform over
//     every key, so every skip is unconditional. The mask has no length
//     limit: each warp tests the mask bytes of the tiles ahead itself (8
//     bytes a lane, four tiles a ballot) and builds a walked tile's 64-bit
//     word with two ballots, instead of K6's per-row words in shared
//     memory;
//   * delta = sum dO * O was three fp32 tensors in PyTorch (~0.5 GB of
//     traffic at the text shape, against the backward's bound of 0.152
//     ms): here the dq kernel reads its out rows, computes delta in fp32,
//     uses it and writes it to the (bh, n) scratch that the dk/dv kernel,
//     launched after it on the same stream, reads (K6's scheme).
// A block is one of bh x n/64 on a 1-D grid, the tiles of one bh row
// adjacent so that they share its k and v (or q and dO) in the L2. Causal:
// the forward and dq take a row's query tiles last first, the heaviest
// (most key tiles) first, which trims the tail of a long row's launch
// (1.5-3 % at n 8192) and costs 1-2 % (~0.004 ms) at n 256; dk/dv's
// first key tiles are already its heaviest. Every block owns its outputs (no
// atomics: two runs agree bit for bit) and writes every element of them
// (the wrapper's tensors come from torch.empty).
//
// ptxas -v (sm_90a, -O3, CUDA 12.8): forward 126 registers (4 blocks an
// SM under its bound), dq 157 and dk/dv 168 (3 blocks an SM each, under
// their bounds, as K6's), no spill in any. tools/k7_variants.py times the
// query-tile order and the exp against their alternatives.
//
// A head of d columns (any multiple of 8 up to 256) is NH = ⌈d / 64⌉
// staged 64-column halves, read at the tensors' true row stride d: the
// columns of the last half past d are zero in shared memory (cp.async with
// a source size of 0) and are never stored. At three and four halves the
// forward and dq kernels hold every half's accumulator (one block an SM),
// and the dk/dv kernel runs two groups of four warps on the same 16-key
// slabs, each recomputing s and dp over the whole head and keeping dk and
// dv for two halves (each thread's dk and dv for four would be 256 fp32).
#pragma once

#include "mma_tiles.cuh"

namespace xclip {
namespace {

constexpr int K7_THREADS = 128;    // 4 warps of 16 rows: 64-row blocks
constexpr int K7_TILE = 64 * LDT;  // bf16 elements of a staged tile

// e^x as 2^(x log2 e): a multiply and one ex2.approx, within a few fp32
// ulps of expf, whose range reduction made the backward 1.2x (text shape)
// to 1.3x (n 8192) slower
__device__ __forceinline__ float k7_exp(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// A block's (bh row, tile) from its place on the 1-D grid: the tiles of a
// row adjacent, last first when `reverse`.
struct K7Block {
  long bh;
  int t;
  __device__ __forceinline__ K7Block(int tiles, bool reverse)
      : bh(blockIdx.x / tiles), t(blockIdx.x % tiles) {
    if (reverse) t = tiles - 1 - t;
  }
};

// A head of d columns is NH staged 64-column tiles: its scores sum the
// halves' products, and each half keeps its own output accumulator. Tile h
// of a staged side sits at `tiles + h * K7_TILE`; rows of d columns, the
// last tile's columns past d zero.
template <int NH, int THREADS = K7_THREADS>
__device__ __forceinline__ void k7_stage(bf16* tiles, const bf16* src,
                                         int r0, int n, int d) {
#pragma unroll
  for (int h = 0; h < NH; ++h)
    stage_tile_async<THREADS>(tiles + h * K7_TILE, src, d, 64 * h, r0, n,
                              d - 64 * h);
}

// acc += a . bᵀ over the whole head: a's NH tiles (rows r0 to r0 + 16)
// against b's NH tiles
template <int NH>
__device__ __forceinline__ void k7_abt(float (&acc)[8][4], const bf16* a,
                                       const bf16* b, int r0) {
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    uint32_t f[4][4];
    load_a(f, a + h * K7_TILE, r0);
    mma_abt(acc, f, b + h * K7_TILE);
  }
}

// Forward, one block per (bh row, 64-query tile).
template <int NH, bool FULL>
__global__ void __launch_bounds__(K7_THREADS,
                                  NH == 1 ? 4 : NH == 2 ? 2 : 1)
k7_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
              bf16* __restrict__ out, float* __restrict__ lse, int n,
              int d_arg, int causal) {
  const int d = FULL ? 64 * NH : d_arg;  // whole halves fold it in
  constexpr int T = NH * K7_TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + T;      // two buffers
  bf16* vs = ks + 2 * T;  // two buffers
  const int tiles = n / 64;
  const K7Block blk(tiles, causal);
  const int qt = blk.t, q0 = 64 * qt;
  const long base = blk.bh * n * d;
  const uint8_t* mrow = mask + blk.bh * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  auto stage = [&](int t, int buf) {
    k7_stage<NH>(ks + buf * T, k + base, 64 * t, n, d);
    k7_stage<NH>(vs + buf * T, v + base, 64 * t, n, d);
  };
  // q lands with the first key tile
  k7_stage<NH>(qs, q + base, q0, n, d);
  const int last = causal ? qt + 1 : tiles;
  auto next = [&](int t) { return next_key_tile(mrow, t + 1, last); };
  const int r[2] = {warp * 16 + g, warp * 16 + g + 8};  // rows in the tile

  // per row: the running max, this thread's share of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NH][8][4];
#pragma unroll
  for (int h = 0; h < NH; ++h) zero_acc(o[h]);
  tile_walk(next(-1), last, next, stage, [&](int t, int buf) {
    const KeyBits key(key_word(mrow + 64 * t), tq);
    const bool diag = causal && t == qt;  // the only tile with future keys
    float s[8][4];
    zero_acc(s);
    k7_abt<NH>(s, qs, ks + buf * T, warp * 16);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid =
              key(c, e) && !(diag && 8 * c + 2 * tq + e > r[i]);
          float& x = s[c][2 * i + e];
          x = valid ? x : -INFINITY;
          mt = fmaxf(mt, x);
        }
      const float mn = fmaxf(m[i], quad_max(mt));
      const float msafe = mn == -INFINITY ? 0.f : mn;
      const float corr = m[i] == -INFINITY ? 0.f : k7_exp(m[i] - msafe);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[c][2 * i + e];
          x = k7_exp(x - msafe);  // exp(-inf) = 0: masked
          sum += x;
#pragma unroll
          for (int h = 0; h < NH; ++h) o[h][c][2 * i + e] *= corr;
        }
      l[i] = l[i] * corr + sum;
      m[i] = mn;
    }
    uint32_t a[4][4];
    pack_a(a, s);  // p rounded to bf16 against the running max
#pragma unroll
    for (int h = 0; h < NH; ++h) mma_ab(o[h], a, vs + buf * T + h * K7_TILE);
  });
  cp_async_wait<0>();  // q has landed even if no tile was walked
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = fmaxf(quad_sum(l[i]), 1e-30f);
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        o[h][c][2 * i] /= li;
        o[h][c][2 * i + 1] /= li;
      }
    if (tq == 0)
      lse[blk.bh * n + q0 + r[i]] =
          (m[i] == -INFINITY ? 0.f : m[i]) + logf(li);
  }
#pragma unroll
  for (int h = 0; h < NH; ++h)
    store_rows(out + base + 64 * h, d, q0, n, qs + h * K7_TILE, warp * 16,
               o[h], d - 64 * h);
}

// dq and delta, one block per (bh row, 64-query tile).
template <int NH, bool FULL>
__global__ void __launch_bounds__(K7_THREADS,
                                  NH == 1 ? 3 : NH == 2 ? 2 : 1)
k7_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                 const bf16* __restrict__ out, const float* __restrict__ lse,
                 const bf16* __restrict__ dout, bf16* __restrict__ dq,
                 float* __restrict__ delta, int n, int d_arg, int causal) {
  const int d = FULL ? 64 * NH : d_arg;  // whole halves fold it in
  constexpr int D = 64 * NH, T = NH * K7_TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + T;
  bf16* ks = dos + T;     // two buffers
  bf16* vs = ks + 2 * T;  // two buffers
  const int tiles = n / 64;
  const K7Block blk(tiles, causal);
  const int qt = blk.t, q0 = 64 * qt;
  const long base = blk.bh * n * d, rows = blk.bh * n + q0;
  const uint8_t* mrow = mask + blk.bh * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  auto stage = [&](int t, int buf) {
    k7_stage<NH>(ks + buf * T, k + base, 64 * t, n, d);
    k7_stage<NH>(vs + buf * T, v + base, 64 * t, n, d);
  };
  // q and dO land with the first key tile
  k7_stage<NH>(qs, q + base, q0, n, d);
  k7_stage<NH>(dos, dout + base, q0, n, d);
  const int last = causal ? qt + 1 : tiles;
  auto next = [&](int t) { return next_key_tile(mrow, t + 1, last); };
  const int first = next(-1);
  const int r[2] = {warp * 16 + g, warp * 16 + g + 8};
  float rlse[2], rdelta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) rlse[i] = lse[rows + r[i]];

  // delta = sum dO * out in fp32: lanes 2j, 2j + 1 take half of the
  // halves' columns of row warp * 16 + j each (those below d), from global
  // memory while the tiles load
  {
    const int c0 = (lane & 1) * (D / 2);
    const long off = (rows + warp * 16 + (lane >> 1)) * d + c0;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      const uint4 ov = load16_if(out + off + c, c0 + c < d);
      const uint4 dv = load16_if(dout + off + c, c0 + c < d);
      const bf16* op = reinterpret_cast<const bf16*>(&ov);
      const bf16* dp = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += to_f(dp[e]) * to_f(op[e]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0) delta[rows + warp * 16 + (lane >> 1)] = acc;
    rdelta[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    rdelta[1] = __shfl_sync(0xffffffffu, acc, 2 * g + 16);
  }

  float dqa[NH][8][4];
#pragma unroll
  for (int h = 0; h < NH; ++h) zero_acc(dqa[h]);
  tile_walk(first, last, next, stage, [&](int t, int buf) {
    const KeyBits key(key_word(mrow + 64 * t), tq);
    const bool diag = causal && t == qt;
    const bf16* kt = ks + buf * T;
    float s[8][4], dp[8][4];
    zero_acc(s);
    k7_abt<NH>(s, qs, kt, warp * 16);
    zero_acc(dp);
    k7_abt<NH>(dp, dos, vs + buf * T, warp * 16);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool valid =
            key(c, e & 1) && !(diag && 8 * c + 2 * tq + (e & 1) > r[i]);
        const float p = valid ? k7_exp(s[c][e] - rlse[i]) : 0.f;
        s[c][e] = p * (dp[c][e] - rdelta[i]);
      }
    if constexpr (NH <= 2) {
      uint32_t a[4][4];
      pack_a(a, s);
#pragma unroll
      for (int h = 0; h < NH; ++h)
        mma_ab(dqa[h], a, kt + h * K7_TILE);  // dq += T(ds) . k
    } else {
      // ds into the halves' products a 16-wide slice at a time
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        pack_a_k(a, s, kk);
#pragma unroll
        for (int h = 0; h < NH; ++h)
          mma_ab_k(dqa[h], a, kk, kt + h * K7_TILE);
      }
    }
  });
  cp_async_wait<0>();  // q, dO have landed even if no tile was walked
  __syncthreads();
#pragma unroll
  for (int h = 0; h < NH; ++h)
    store_rows(dq + base + 64 * h, d, q0, n, qs + h * K7_TILE, warp * 16,
               dqa[h], d - 64 * h);
}

// dk and dv, one block per (bh row, 64-key tile), over the query tiles
// that see it.
template <int NH, bool FULL>
__global__ void __launch_bounds__(K7_THREADS * dkv_groups(NH),
                                  NH == 1 ? 3 : 1)
k7_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ lse,
                  const bf16* __restrict__ dout,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int n, int d_arg, int causal) {
  const int d = FULL ? 64 * NH : d_arg;  // whole halves fold it in
  constexpr int T = NH * K7_TILE;
  constexpr int CG = dkv_groups(NH), THREADS = K7_THREADS * CG;
  constexpr int NO = NH / CG + NH % CG;  // halves of dk, dv a group keeps
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + T;
  bf16* qs = vs + T;       // two buffers
  bf16* dos = qs + 2 * T;  // two buffers
  float* stats = reinterpret_cast<float*>(dos + 2 * T);  // [2][2][64]
  const int tiles = n / 64;
  const K7Block blk(tiles, false);
  const int kt = blk.t, k0 = 64 * kt;
  const long base = blk.bh * n * d, rows = blk.bh * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slab = warp & 3, cg = warp >> 2;  // 16 keys; the group
  const int g = lane >> 2, tq = lane & 3;

  const unsigned long long kw = key_word(mask + rows + k0);
  if (kw == 0) {  // no valid key: no query reaches the tile
    for (int c = threadIdx.x; c < 64 * d / 8; c += THREADS) {
      const long o = base + (long)(k0 + c / (d / 8)) * d + (c % (d / 8)) * 8;
      *reinterpret_cast<uint4*>(dk + o) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dv + o) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  auto stage = [&](int t, int buf) {
    k7_stage<NH, THREADS>(qs + buf * T, q + base, 64 * t, n, d);
    k7_stage<NH, THREADS>(dos + buf * T, dout + base, 64 * t, n, d);
    // lse (threads 0-63) and delta (64-127) of the tile's queries
    if (threadIdx.x < K7_THREADS) {
      const int c = threadIdx.x & 63;
      cp_async4(stats + (buf * 2 + (threadIdx.x >> 6)) * 64 + c,
                (threadIdx.x < 64 ? lse : delta) + rows + 64 * t + c, true);
    }
  };
  // k and v land with the first query tile
  k7_stage<NH, THREADS>(ks, k + base, k0, n, d);
  k7_stage<NH, THREADS>(vs, v + base, k0, n, d);
  const int r[2] = {slab * 16 + g, slab * 16 + g + 8};  // keys in the tile
  bool kvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kvalid[i] = (kw >> r[i]) & 1ull;

  float dka[NO][8][4], dva[NO][8][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    zero_acc(dka[j]);
    zero_acc(dva[j]);
  }
  // causal: query tiles before the key tile see none of its keys
  tile_walk(causal ? kt : 0, tiles, [](int t) { return t + 1; }, stage,
            [&](int t, int buf) {
    const bool diag = causal && t == kt;
    const bf16* qt = qs + buf * T;
    const bf16* dot = dos + buf * T;
    const float* tlse = stats + buf * 2 * 64;
    const float* tdelta = tlse + 64;
    float s[8][4], dp[8][4];
    zero_acc(s);
    k7_abt<NH>(s, ks, qt, slab * 16);  // sᵀ = k . qᵀ
    zero_acc(dp);
    k7_abt<NH>(dp, vs, dot, slab * 16);  // dpᵀ = v . dOᵀ
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = 8 * c + 2 * tq + (e & 1);
        const bool valid = kvalid[i] && !(diag && r[i] > col);
        const float p = valid ? k7_exp(s[c][e] - tlse[col]) : 0.f;
        s[c][e] = p;
        dp[c][e] = p * (dp[c][e] - tdelta[col]);
      }
    if constexpr (NH <= 2) {
      uint32_t a[4][4];
      pack_a(a, s);
#pragma unroll
      for (int h = 0; h < NH; ++h)
        mma_ab(dva[h], a, dot + h * K7_TILE);  // dv += T(p)ᵀ . dO
      pack_a(a, dp);
#pragma unroll
      for (int h = 0; h < NH; ++h)
        mma_ab(dka[h], a, qt + h * K7_TILE);  // dk += T(ds)ᵀ . q
    } else {
      // the group's halves, p and ds a 16-wide slice at a time
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        pack_a_k(a, s, kk);
#pragma unroll
        for (int j = 0; j < NO; ++j)
          if (cg * NO + j < NH)
            mma_ab_k(dva[j], a, kk, dot + (cg * NO + j) * K7_TILE);
        pack_a_k(a, dp, kk);
#pragma unroll
        for (int j = 0; j < NO; ++j)
          if (cg * NO + j < NH)
            mma_ab_k(dka[j], a, kk, qt + (cg * NO + j) * K7_TILE);
      }
    }
  });
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int h = cg * NO + j;
    if (h >= NH) break;
    store_rows(dk + base + 64 * h, d, k0, n, ks + h * K7_TILE, slab * 16,
               dka[j], d - 64 * h);
    store_rows(dv + base + 64 * h, d, k0, n, vs + h * K7_TILE, slab * 16,
               dva[j], d - 64 * h);
  }
}

template <int NH>
constexpr size_t k7_fwd_smem() { return 5 * NH * K7_TILE * sizeof(bf16); }
template <int NH>
constexpr size_t k7_dq_smem() { return 6 * NH * K7_TILE * sizeof(bf16); }
template <int NH>
constexpr size_t k7_dkv_smem() {
  return 6 * NH * K7_TILE * sizeof(bf16) + 4 * 64 * sizeof(float);
}
// four halves fit the 232,448 bytes a block may opt in to
static_assert(k7_fwd_smem<4>() <= 232448 && k7_dq_smem<4>() <= 232448 &&
                  k7_dkv_smem<4>() <= 232448,
              "K7's kernels at four halves fit a block");

// the 1-D grid of bh x n/64 blocks, 0 when it exceeds the grid's x limit
inline unsigned k7_blocks(int bh, int n) {
  const long blocks = (long)bh * (n / 64);
  return blocks <= 0x7fffffffL ? (unsigned)blocks : 0u;
}

template <typename K>
cudaError_t k7_allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NH>
int launch_k7_fwd_nh(const bf16* q, const bf16* k, const bf16* v,
                     const uint8_t* mask, bf16* out, float* lse,
                     unsigned blocks, int n, int d, int causal,
                     cudaStream_t st) {
  return by_width<NH>(d, [&](auto full) {
    auto* kernel = k7_fwd_kernel<NH, decltype(full)::value>;
    cudaError_t e = k7_allow_smem(kernel, k7_fwd_smem<NH>());
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, K7_THREADS, k7_fwd_smem<NH>(), st>>>(
        q, k, v, mask, out, lse, n, d, causal);
    XCLIP_CHECK_LAUNCH();
    return 0;
  });
}

template <int NH>
int launch_k7_bwd_nh(const bf16* q, const bf16* k, const bf16* v,
                     const uint8_t* mask, const bf16* out, const float* lse,
                     const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
                     float* delta, unsigned blocks, int n, int d, int causal,
                     cudaStream_t st) {
  return by_width<NH>(d, [&](auto full) {
    constexpr bool FULL = decltype(full)::value;
    auto* dq_kernel = k7_bwd_dq_kernel<NH, FULL>;
    auto* dkv_kernel = k7_bwd_dkv_kernel<NH, FULL>;
    cudaError_t e = k7_allow_smem(dq_kernel, k7_dq_smem<NH>());
    if (e == cudaSuccess) e = k7_allow_smem(dkv_kernel, k7_dkv_smem<NH>());
    if (e != cudaSuccess) return (int)e;
    dq_kernel<<<blocks, K7_THREADS, k7_dq_smem<NH>(), st>>>(
        q, k, v, mask, out, lse, dout, dq, delta, n, d, causal);
    XCLIP_CHECK_LAUNCH();
    dkv_kernel<<<blocks, K7_THREADS * dkv_groups(NH), k7_dkv_smem<NH>(),
                 st>>>(q, k, v, mask, lse, dout, delta, dk, dv, n, d, causal);
    XCLIP_CHECK_LAUNCH();
    return 0;
  });
}

// out (bh, n, d) and lse (bh, n) fp32 from q (pre-scaled), k, v (bh, n,
// d) and the key mask (bh, n) uint8; n a multiple of 64, d a width
// bf16_halves takes (a multiple of 8 up to 256).
inline int launch_k7_fwd(const bf16* q, const bf16* k, const bf16* v,
                         const uint8_t* mask, bf16* out, float* lse, int bh,
                         int n, int d, int causal, cudaStream_t st) {
  const unsigned blocks = k7_blocks(bh, n);
  auto* launch = launch_k7_fwd_nh<1>;
  switch (blocks ? bf16_halves(d) : 0) {
    case 1: break;
    case 2: launch = launch_k7_fwd_nh<2>; break;
    case 3: launch = launch_k7_fwd_nh<3>; break;
    case 4: launch = launch_k7_fwd_nh<4>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return launch(q, k, v, mask, out, lse, blocks, n, d, causal, st);
}

// dq, dk, dv (bh, n, d) from the forward's inputs, out, lse and dout;
// delta (bh, n) fp32 is scratch the dq kernel writes and the dk/dv kernel
// reads.
inline int launch_k7_bwd(const bf16* q, const bf16* k, const bf16* v,
                         const uint8_t* mask, const bf16* out,
                         const float* lse, const bf16* dout, bf16* dq,
                         bf16* dk, bf16* dv, float* delta, int bh, int n,
                         int d, int causal, cudaStream_t st) {
  const unsigned blocks = k7_blocks(bh, n);
  auto* launch = launch_k7_bwd_nh<1>;
  switch (blocks ? bf16_halves(d) : 0) {
    case 1: break;
    case 2: launch = launch_k7_bwd_nh<2>; break;
    case 3: launch = launch_k7_bwd_nh<3>; break;
    case 4: launch = launch_k7_bwd_nh<4>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return launch(q, k, v, mask, out, lse, dout, dq, dk, dv, delta, blocks, n,
                d, causal, st);
}

}  // namespace
}  // namespace xclip
