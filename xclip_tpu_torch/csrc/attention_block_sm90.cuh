// K6 in bf16: whole-head attention on the fused qkv, forward and backward,
// in place of the Pallas bodies of xclip_tpu/kernels/attention_block.py:
// `_fwd_kernel` (:83) and `_bwd_kernel` (:117). The same numbers as they
// compute (csrc/attention_block.cu gives the semantics): scores (q . k) *
// scale in fp32, -inf on masked and future keys; a dead row (maybe_dead,
// no valid key up to it) uniform over the n keys with m = 0; l = max(sum
// p, 1e-30); p / l rounded to bf16 before p . v; lse = m + log l. The
// backward takes p = exp(s - lse) (1/n on a dead row), delta = sum do *
// out from the stored out, ds = T(p (dp - delta) scale) (0 on a dead
// row), dq = ds . k, dk = dsᵀ . q, dv = T(p)ᵀ . do, each cast once.
//
// What bounds it on the card: bytes. At the text tower's shape (b 256, n
// 256, 8 heads, causal, key pads uniform in 1..n) the forward reads q and
// the k and v of the keys some query uses (the valid ones; all n where a
// row is dead) and writes out and lse (0.061 ms at 3.35 TB/s), the
// backward also reads out, do and lse and writes all of dqkv (0.141 ms);
// the products are ~29 GFLOP, 0.03 ms of the tensor cores. The attention
// megablock's core (attention_core.cuh), which K6 ran on before, lost its
// time elsewhere, and the design answers each:
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
// The forward takes two passes over the key tiles to keep the reference's
// cast order (p divided by the whole row's l before rounding): the first
// keeps a running (m, l), the second recomputes s and accumulates
// T(exp(s - m) / l) . v. The backward is two kernels, each owning its
// outputs (no atomics, two runs agree bit for bit): query tiles give delta
// (into the `delta` scratch) and dq; key tiles compute sᵀ = k . qᵀ and dpᵀ
// = v . doᵀ, so pᵀ and dsᵀ are the A operands of dv += T(p)ᵀ . do and dk
// += dsᵀ . q. Every output element is written (the wrapper's tensors come
// from torch.empty): a skipped tile leaves its accumulator 0. Rows and keys
// at or past n read as 0 and are never written.
#pragma once

#include "mma_tiles.cuh"

namespace xclip {
namespace {

constexpr int K6_THREADS = 128;  // 4 warps of 16 rows: 64-row blocks
constexpr int K6_MAX_TILES = 32;  // n <= 2048
constexpr int K6_TILE = 64 * LDT;  // bf16 elements of a staged tile

// One 64-bit word per 64-key tile of the batch element's mask (bit c: key
// 64 t + c < n is valid), into `bits`; returns the first valid key (n if
// none). Ends with the block synchronised.
__device__ int k6_key_tiles(unsigned long long* bits, const uint8_t* mrow,
                            int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (n + 63) / 64;
  for (int t = warp; t < tiles; t += K6_THREADS / 32) {
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

// Forward, one block per (64-query tile, head, batch element); the last
// query tiles, which walk the most key tiles when causal, start first.
__global__ void __launch_bounds__(K6_THREADS, 4)
k6_fwd_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
              bf16* __restrict__ out, float* __restrict__ lse, int n,
              int heads, float scale, int causal, int maybe_dead) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + K6_TILE;      // two buffers
  bf16* vs = ks + 2 * K6_TILE;  // two buffers
  auto* bits = reinterpret_cast<unsigned long long*>(vs + 2 * K6_TILE);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64, h = blockIdx.y;
  const int bi = blockIdx.z, hd = heads * 64, tiles = (n + 63) / 64;
  const long ld = 3L * hd;
  const bf16* base = qkv + (long)bi * n * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  // the walk's steps: 64 p + t is key tile t in pass p (0 or 1)
  constexpr int END = 128;
  auto stage = [&](int st, int buf) {
    const int t = st & 63;
    stage_tile_async<K6_THREADS>(ks + buf * K6_TILE, base, ld, hd + h * 64,
                                 64 * t, n);
    if (st >= 64)
      stage_tile_async<K6_THREADS>(vs + buf * K6_TILE, base, ld,
                                   2 * hd + h * 64, 64 * t, n);
  };
  stage_tile_async<K6_THREADS>(qs, base, ld, h * 64, q0, n);
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
  int row[2];
  bool dead[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    dead[i] = maybe_dead && row[i] < n && (causal ? fv > row[i] : fv >= n);
  }
  cp_async_wait<0>();  // q
  __syncthreads();
  uint32_t qa[4][4];
  load_a(qa, qs, warp * 16);

  // s = (q . kᵀ) scale for key tile t, -inf on masked and future keys
  auto scores = [&](float (&s)[8][4], int t, const bf16* kt) {
    zero_acc(s);
    mma_abt(s, qa, kt);
    const KeyBits key(bits[t], tq);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 64 * t + 8 * c + 2 * tq + (e & 1);
        const bool valid = key(c, e & 1) && !(causal && j > row[e >> 1]);
        s[c][e] = valid ? s[c][e] * scale : -INFINITY;
      }
  };

  // pass 1 keeps the running max and sum of each row; then (m, l) are
  // final and lse is written; pass 2 accumulates o = T(p / l) . v
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  bool rows_final = false;
  auto finish_rows = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float sum = quad_sum(l[i]);  // every lane shuffles
      l[i] = dead[i] ? (float)n : fmaxf(sum, 1e-30f);
      if (dead[i]) m[i] = 0.f;
      if (tq == 0 && row[i] < n)
        lse[((long)bi * n + row[i]) * heads + h] = m[i] + logf(l[i]);
    }
    rows_final = true;
  };
  float o[8][4];
  zero_acc(o);
  tile_walk(
      first_step, END, next, stage,
      [&](int st, int buf) {
        const int t = st & 63;
        float s[8][4];
        scores(s, t, ks + buf * K6_TILE);
        if (st < 64) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float mt = -INFINITY;
#pragma unroll
            for (int c = 0; c < 8; ++c)
              mt = fmaxf(mt, fmaxf(s[c][2 * i], s[c][2 * i + 1]));
            const float mn = fmaxf(m[i], quad_max(mt));
            if (mn != -INFINITY) {  // the same in the whole quad
              float sum = l[i] * expf(m[i] - mn);
#pragma unroll
              for (int c = 0; c < 8; ++c)
                sum += expf(s[c][2 * i] - mn) + expf(s[c][2 * i + 1] - mn);
              l[i] = sum;
              m[i] = mn;
            }
          }
          return;
        }
        if (!rows_final) finish_rows();
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int j = 64 * t + 8 * c + 2 * tq + (e & 1);
            const float p = dead[i] ? (j < n ? 1.f : 0.f)
                                    : (s[c][e] == -INFINITY
                                           ? 0.f
                                           : expf(s[c][e] - m[i]));
            s[c][e] = p / l[i];
          }
        uint32_t pa[4][4];
        pack_a(pa, s);
        mma_ab(o, pa, vs + buf * K6_TILE);
      });
  if (!rows_final) finish_rows();
  store_rows(out + (long)bi * n * hd + h * 64, hd, q0, n, qs, warp * 16, o);
}

// dq and delta, one block per (64-query tile, head, batch element).
__global__ void __launch_bounds__(K6_THREADS, 3)
k6_bwd_dq_kernel(const bf16* __restrict__ qkv,
                 const uint8_t* __restrict__ mask,
                 const bf16* __restrict__ out, const float* __restrict__ lse,
                 const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                 float* __restrict__ delta, int n, int heads, float scale,
                 int causal, int maybe_dead) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + K6_TILE;
  bf16* ks = dos + K6_TILE;     // two buffers
  bf16* vs = ks + 2 * K6_TILE;  // two buffers
  auto* bits = reinterpret_cast<unsigned long long*>(vs + 2 * K6_TILE);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64, h = blockIdx.y;
  const int bi = blockIdx.z, hd = heads * 64, tiles = (n + 63) / 64;
  const long ld = 3L * hd;
  const bf16* base = qkv + (long)bi * n * ld;
  const bf16* obase = out + (long)bi * n * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  auto stage = [&](int t, int buf) {
    stage_tile_async<K6_THREADS>(ks + buf * K6_TILE, base, ld, hd + h * 64,
                                 64 * t, n);
    stage_tile_async<K6_THREADS>(vs + buf * K6_TILE, base, ld,
                                 2 * hd + h * 64, 64 * t, n);
  };
  stage_tile_async<K6_THREADS>(qs, base, ld, h * 64, q0, n);
  stage_tile_async<K6_THREADS>(dos, dout + (long)bi * n * hd, hd, h * 64, q0,
                               n);
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
  int row[2];
  bool dead[2];
  float rlse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + 8 * i;
    dead[i] = maybe_dead && row[i] < n && (causal ? fv > row[i] : fv >= n);
    rlse[i] = row[i] < n ? lse[((long)bi * n + row[i]) * heads + h] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // delta = sum do * out: lanes 2r, 2r + 1 take half of row r each
  float rdelta[2];
  {
    const int r = warp * 16 + (lane >> 1), d0 = (lane & 1) * 32;
    float acc = 0.f;
    if (q0 + r < n) {
      const bf16* orow = obase + (long)(q0 + r) * hd + h * 64 + d0;
#pragma unroll
      for (int c = 0; c < 32; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dos + r * LDT + d0 + c);
        const bf16* op = reinterpret_cast<const bf16*>(&ov);
        const bf16* dp = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += to_f(dp[k]) * to_f(op[k]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0 && q0 + r < n)
      delta[((long)bi * n + q0 + r) * heads + h] = acc;
    rdelta[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    rdelta[1] = __shfl_sync(0xffffffffu, acc, 2 * g + 16);
  }
  uint32_t qa[4][4], da[4][4];
  load_a(qa, qs, warp * 16);
  load_a(da, dos, warp * 16);

  float dq[8][4];
  zero_acc(dq);
  tile_walk(
      first, last, next, stage,
      [&](int t, int buf) {
        const bf16* kt = ks + buf * K6_TILE;
        float s[8][4], dp[8][4];
        zero_acc(s);
        zero_acc(dp);
        mma_abt(s, qa, kt);
        mma_abt(dp, da, vs + buf * K6_TILE);
        const KeyBits key(bits[t], tq);
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, col = 8 * c + 2 * tq + (e & 1);
            const bool valid =
                key(c, e & 1) && !(causal && 64 * t + col > row[i]);
            const float p = valid ? expf(s[c][e] * scale - rlse[i]) : 0.f;
            s[c][e] = dead[i] ? 0.f : p * (dp[c][e] - rdelta[i]) * scale;
          }
        uint32_t dsa[4][4];
        pack_a(dsa, s);
        mma_ab(dq, dsa, kt);
      });
  store_rows(dqkv + (long)bi * n * ld + h * 64, ld, q0, n, qs, warp * 16, dq);
}

// dk and dv, one block per (64-key tile, head, batch element), over the
// query tiles that reach it.
__global__ void __launch_bounds__(K6_THREADS, 3)
k6_bwd_dkv_kernel(const bf16* __restrict__ qkv,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ lse,
                  const bf16* __restrict__ dout,
                  const float* __restrict__ delta, bf16* __restrict__ dqkv,
                  int n, int heads, float scale, int causal, int maybe_dead) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + K6_TILE;
  bf16* qs = vs + K6_TILE;       // two buffers
  bf16* dos = qs + 2 * K6_TILE;  // two buffers
  float* stats = reinterpret_cast<float*>(dos + 2 * K6_TILE);  // [2][2][64]
  auto* bits = reinterpret_cast<unsigned long long*>(stats + 4 * 64);
  const int kt = blockIdx.x, k0 = 64 * kt, h = blockIdx.y, bi = blockIdx.z;
  const int hd = heads * 64, tiles = (n + 63) / 64;
  const long ld = 3L * hd;
  const bf16* base = qkv + (long)bi * n * ld;
  const bf16* dbase = dout + (long)bi * n * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  auto stage = [&](int t, int buf) {
    stage_tile_async<K6_THREADS>(qs + buf * K6_TILE, base, ld, h * 64, 64 * t,
                                 n);
    stage_tile_async<K6_THREADS>(dos + buf * K6_TILE, dbase, hd, h * 64,
                                 64 * t, n);
    // lse (threads 0-63) and delta (64-127) of the tile's queries
    const int c = threadIdx.x & 63, q = 64 * t + c;
    const float* src = threadIdx.x < 64 ? lse : delta;
    cp_async4(stats + (buf * 2 + (threadIdx.x >> 6)) * 64 + c,
              src + (q < n ? ((long)bi * n + q) * heads + h : 0), q < n);
  };
  stage_tile_async<K6_THREADS>(ks, base, ld, hd + h * 64, k0, n);
  stage_tile_async<K6_THREADS>(vs, base, ld, 2 * hd + h * 64, k0, n);
  cp_async_commit();
  const int fv = k6_key_tiles(bits, mask + (long)bi * n, n);
  const unsigned long long kw = bits[kt];
  // queries below `dead_end` are dead rows: their p = 1/n reaches every key
  const int dead_end =
      maybe_dead ? (causal ? min(fv, n) : (fv >= n ? n : 0)) : 0;
  auto next = [&](int t) {
    for (++t; t < tiles; ++t)
      if (64 * t < dead_end || (kw && !(causal && 64 * t + 63 < k0))) break;
    return t;
  };
  int key[2];
  bool kvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = warp * 16 + g + 8 * i;
    key[i] = k0 + c;
    kvalid[i] = (kw >> c) & 1ull;
  }
  const float inv_n = 1.f / (float)n;
  const int first = next(-1);

  float dk[8][4], dv[8][4];
  zero_acc(dk);
  zero_acc(dv);
  tile_walk(
      first, tiles, next, stage,
      [&](int t, int buf) {
        const bf16* qt = qs + buf * K6_TILE;
        const bf16* dot = dos + buf * K6_TILE;
        const float* tlse = stats + buf * 2 * 64;
        const float* tdelta = tlse + 64;
        uint32_t a[4][4];
        float s[8][4], dp[8][4];
        zero_acc(s);
        zero_acc(dp);
        load_a(a, ks, warp * 16);
        mma_abt(s, a, qt);  // sᵀ = k . qᵀ
        load_a(a, vs, warp * 16);
        mma_abt(dp, a, dot);  // dpᵀ = v . doᵀ
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, col = 8 * c + 2 * tq + (e & 1);
            const int q = 64 * t + col;
            float p, ds;
            if (q < dead_end) {
              p = key[i] < n ? inv_n : 0.f;
              ds = 0.f;
            } else {
              const bool valid =
                  kvalid[i] && q < n && !(causal && key[i] > q);
              p = valid ? expf(s[c][e] * scale - tlse[col]) : 0.f;
              ds = p * (dp[c][e] - tdelta[col]) * scale;
            }
            s[c][e] = p;
            dp[c][e] = ds;
          }
        pack_a(a, s);
        mma_ab(dv, a, dot);  // dv += T(p)ᵀ . do
        pack_a(a, dp);
        mma_ab(dk, a, qt);   // dk += T(ds)ᵀ . q
      });
  cp_async_wait<0>();  // k and v have landed even if no tile was walked
  __syncthreads();
  bf16* dst = dqkv + (long)bi * n * ld + h * 64;
  store_rows(dst + hd, ld, k0, n, ks, warp * 16, dk);
  store_rows(dst + 2 * hd, ld, k0, n, vs, warp * 16, dv);
}

constexpr size_t k6_fwd_smem() {
  return 5 * K6_TILE * sizeof(bf16) + K6_MAX_TILES * 8;
}
constexpr size_t k6_dq_smem() {
  return 6 * K6_TILE * sizeof(bf16) + K6_MAX_TILES * 8;
}
constexpr size_t k6_dkv_smem() {
  return 6 * K6_TILE * sizeof(bf16) + 4 * 64 * sizeof(float) +
         K6_MAX_TILES * 8;
}

// out (b*n x hd) and lse (b*n x heads, fp32) from qkv (b*n x 3hd).
inline int launch_k6_fwd(const bf16* qkv, const uint8_t* mask, bf16* out,
                         float* lse, int b, int n, int heads, float scale,
                         int causal, int maybe_dead, cudaStream_t st) {
  if (n > 64 * K6_MAX_TILES) return (int)cudaErrorInvalidValue;
  const size_t smem = k6_fwd_smem();
  cudaError_t e = cudaFuncSetAttribute(
      k6_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k6_fwd_kernel<<<dim3((n + 63) / 64, heads, b), K6_THREADS, smem, st>>>(
      qkv, mask, out, lse, n, heads, scale, causal, maybe_dead);
  XCLIP_CHECK_LAUNCH();
  return 0;
}

// dqkv (b*n x 3hd) from qkv, out, lse and do; delta (b*n x heads, fp32)
// is scratch the dq kernel writes and the dk/dv kernel reads.
inline int launch_k6_bwd(const bf16* qkv, const uint8_t* mask, const bf16* out,
                         const float* lse, const bf16* dout, bf16* dqkv,
                         float* delta, int b, int n, int heads, float scale,
                         int causal, int maybe_dead, cudaStream_t st) {
  if (n > 64 * K6_MAX_TILES) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k6_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)k6_dq_smem());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k6_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)k6_dkv_smem());
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + 63) / 64, heads, b);
  k6_bwd_dq_kernel<<<grid, K6_THREADS, k6_dq_smem(), st>>>(
      qkv, mask, out, lse, dout, dqkv, delta, n, heads, scale, causal,
      maybe_dead);
  XCLIP_CHECK_LAUNCH();
  k6_bwd_dkv_kernel<<<grid, K6_THREADS, k6_dkv_smem(), st>>>(
      qkv, mask, lse, dout, delta, dqkv, n, heads, scale, causal, maybe_dead);
  XCLIP_CHECK_LAUNCH();
  return 0;
}

}  // namespace
}  // namespace xclip
