// The attention core of the attention megablock (K-MEGA, K2, K3:
// csrc/attention_megablock.cu) and of whole-head attention on a fused qkv
// (K6: csrc/attention_block.cu): softmax(q . kᵀ · scale) · v per (batch
// element, head) from the (b·n, 3·heads·64) qkv, and its backward.
//
// Cast order (as the Pallas kernels): scores are fp32 (q . k) * scale; keys
// where the mask is 0, and keys past the query when causal, get -inf. With
// maybe_dead a row with no valid key gets m = 0 and p = 1 on every column
// (uniform weights over the n real keys). l = max(sum p, 1e-30); p / l is
// cast to the storage dtype before p @ v (fp32 accumulation), and the head
// outputs are cast to the storage dtype. Head h takes q from columns
// [h*64, (h+1)*64) of a row, k from hd + h*64 and v from 2*hd + h*64.
//
// bf16 runs on the mma.sync kernels of attention_block_sm90.cuh: K6 in
// their K6 mode, the megablock in their megablock mode (launch_attention
// and launch_mega_attention_bwd below); their notes give the design and
// what bounds it. What follows is the fp32 path, which the tests and the
// fp32 goldens run.
//
// Forward, one block per (32-query tile, head, batch element): the tile's
// full fp32 score rows (32 x n) live in shared memory, so the softmax is
// exact rather than online, by FMAs. The row statistics go out as the
// megablock's (m, l) pair per head (`sm`) or as K6's log-sum-exp m + log l
// (`lse`), or not at all. What bounds it: it re-stages k and v for every
// 32-query tile, keeps full score rows in shared memory (which bounds n)
// and multiplies through block_mma (two shared loads an FMA).
//
// Backward: two kernels, each owning its outputs (no atomics; two runs
// agree bit for bit): a query-tile kernel gives delta (into the `delta`
// scratch) and dq, a key-tile kernel recomputes s and dp for its keys and
// gives dk and dv. p is rebuilt from the forward's statistics (not
// re-reduced): the megablock's p = (dead ? 1 : exp(s - m)) / l, K6's p =
// exp(s - lse) and 1/n on a dead row. The row cotangent do (`dattn`) is the
// megablock's dattn or K6's do. The megablock puts the softmax scale on do
// (dp = do * scale · vᵀ, here do · vᵀ times the scale, the same bits where
// the scale is a power of two as 64^-0.5 is; delta = scale · Σ do ·
// attnout, ds = p (dp - delta)); K6 applies it to ds as `_bwd_kernel` does
// (dp = do · vᵀ, delta = Σ do · out, ds = p (dp - delta) scale). Then ds
// is zeroed on dead rows; dq = ds · k, dk = dsᵀ · q, dv = pᵀ · do.
//
// What bounds the backward on the card: the FMAs. It makes seven 64-deep
// products of a (query, key) pair where the bound counts five (s and dp
// are made in both kernels), at 67 TFLOP/s; the bytes (q, k, v, out, do
// and the statistics read, dqkv written) are a tenth of that time at the
// flagship's shapes. Its design, as the bf16 kernels' (their notes) with
// fp32 FMAs in place of mma.sync:
//   * a block is 64 queries (dq) or 64 keys (dk/dv) x one head x one batch
//     element, 256 threads; the other side's 64-row tiles (k and v; q and
//     do) stream once through a double-buffered cp.async ring of 16-byte
//     copies (tile_walk), no score row is kept whole, so n is bounded by
//     the mask words (2048), not by shared memory;
//   * each thread owns a 4 x 4 register tile of every 64 x 64 product
//     (rows 4 ty + i, columns tx + 16 j; a warp 4 x 8 threads) and reads
//     its operands as 16-byte shared loads, 8 per 64 FMAs, each load of a
//     warp one 128-byte wavefront; tiles are unpadded 16 KB, their 16-byte
//     chunks swizzled by row (`swz`) so that no load or p / ds store of a
//     warp meets a bank conflict;
//   * s and dp of a tile stay in registers, p and ds are formed there; ds
//     (dq) or p, then ds (dk/dv) pass through one tile as the A operand of
//     dq += ds · k, dv += pᵀ · do, dk += dsᵀ · q, whose sums stay in
//     registers: seven 16 KB tiles a block, two blocks an SM;
//   * the mask is read once into one 64-bit word per key tile; key tiles
//     above the causal diagonal and with no valid key are skipped (dq),
//     and so are query tiles wholly before the key tile under causal
//     (dk/dv), except where dead rows reach them (a dead row's p = 1/n
//     reaches dv for every key). Below the tile, a warp (16 rows) runs no
//     product when its rows lie at or past n; in dq its key columns stop
//     (in groups of 16) at the tile's last valid key and, causal, at its
//     last row; in dk/dv its query columns stop at n, and 16 keys none of
//     which is valid run nothing on a query tile without a dead row;
//   * every element of dqkv is written: a skipped tile leaves its sums 0.
// tools/f32_attention_variants.py times the register tile (4 x 8 a
// thread), one block an SM (p and ds in two tiles) and ex2.approx in place
// of expf against the shipped choices (PERF.md).
#pragma once

#include "attention_block_sm90.cuh"

namespace {

constexpr int QT = 32;       // queries per forward block
constexpr int KC = 64;       // keys staged per step
constexpr int DH = 64;       // dim_head
constexpr int ALD = DH + 1;  // padded row stride of the staged q/k/v rows

using xclip::up128;

// The row statistics of query q, head h: the megablock's (m, l) in sm,
// (b*n) x (2*heads) with m at column h and l at heads + h; K6's lse,
// (b*n) x heads.
__device__ __forceinline__ void store_row_stats(float* sm, float* lse, int bi,
                                                int n, int q, int h,
                                                int heads, float m, float l) {
  const long row = (long)bi * n + q;
  if (sm) {
    sm[row * 2 * heads + h] = m;
    sm[row * 2 * heads + heads + h] = l;
  }
  if (lse) lse[row * heads + h] = m + logf(l);
}

inline size_t attention_fma_smem_bytes(int n) {
  return sizeof(float) * ((size_t)QT * n + QT * ALD + KC * ALD);
}

__global__ void __launch_bounds__(xclip::kThreads)
attention_fma_kernel(const float* __restrict__ qkv,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ attnout, int n, int heads,
                     float scale, int causal, int maybe_dead,
                     float* __restrict__ sm, float* __restrict__ lse) {
  using namespace xclip;
  // one dynamic shared-memory array per translation unit: every kernel
  // declares it alike and casts
  extern __shared__ __align__(128) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);  // QT x n scores, then probs
  float* qs = s + QT * n;      // QT x ALD
  float* kv = qs + QT * ALD;   // KC x ALD
  const int q0 = blockIdx.x * QT, h = blockIdx.y, bi = blockIdx.z;
  const int hd = heads * DH, ld = 3 * hd;
  const float* base = qkv + (long)bi * n * ld;
  const uint8_t* mrow = mask + (long)bi * n;

  for (int i = threadIdx.x; i < QT * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    qs[r * ALD + d] = q0 + r < n ? base[(long)(q0 + r) * ld + h * DH + d] : 0.f;
  }
  for (int j0 = 0; j0 < n; j0 += KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < KC * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      kv[r * ALD + d] =
          j0 + r < n ? base[(long)(j0 + r) * ld + hd + h * DH + d] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < QT * KC; i += kThreads) {
      const int r = i / KC, c = i % KC, j = j0 + c;
      if (j >= n) continue;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) acc = fmaf(qs[r * ALD + d], kv[c * ALD + d], acc);
      const bool valid = mrow[j] != 0 && !(causal && j > q0 + r);
      s[(long)r * n + j] = valid ? acc * scale : -INFINITY;
    }
  }
  __syncthreads();

  // softmax, one warp per query row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < QT && q0 + r < n; r += kThreads / 32) {
    float* sr = s + (long)r * n;
    bool dead = false;
    if (maybe_dead) {
      const int lim = causal ? q0 + r + 1 : n;
      int any = 0;
      for (int j = lane; j < lim; j += 32) any |= mrow[j] != 0;
      dead = !__any_sync(0xffffffffu, any);
    }
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
    mx = dead ? 0.f : warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = dead ? 1.f : expf(sr[j] - mx);
      sr[j] = p;
      sum += p;
    }
    const float l = fmaxf(warp_sum(sum), 1e-30f);
    if (lane == 0) store_row_stats(sm, lse, bi, n, q0 + r, h, heads, mx, l);
    for (int j = lane; j < n; j += 32) sr[j] = sr[j] / l;
  }

  // o = p @ v; thread t owns outputs (r, d) = divmod(t + i * kThreads, DH)
  constexpr int OPT = QT * DH / kThreads;
  float acc[OPT] = {};
  for (int j0 = 0; j0 < n; j0 += KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < KC * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      kv[r * ALD + d] = j0 + r < n
          ? base[(long)(j0 + r) * ld + 2 * hd + h * DH + d] : 0.f;
    }
    __syncthreads();
    const int jn = min(KC, n - j0);
#pragma unroll
    for (int t = 0; t < OPT; ++t) {
      const int i = threadIdx.x + t * kThreads, r = i / DH, d = i % DH;
      const float* pr = s + (long)r * n + j0;
      float a = acc[t];
      for (int c = 0; c < jn; ++c) a = fmaf(pr[c], kv[c * ALD + d], a);
      acc[t] = a;
    }
  }
#pragma unroll
  for (int t = 0; t < OPT; ++t) {
    const int i = threadIdx.x + t * kThreads, r = i / DH, d = i % DH;
    if (q0 + r < n) attnout[((long)bi * n + q0 + r) * hd + h * DH + d] = acc[t];
  }
}

// attnout (b*n x hd, T) from qkv (b*n x 3hd, T); with `sm` the rows' (m,
// l), with `lse` (fp32 only: bf16 K6 launches its own kernel) their
// log-sum-exp.
template <typename T>
int launch_attention(const T* qkv, const uint8_t* mask, T* attnout, int b,
                     int n, int heads, float scale, int causal, int maybe_dead,
                     float* sm, cudaStream_t st, float* lse = nullptr) {
  if constexpr (std::is_same<T, xclip::bf16>::value) {
    return xclip::launch_k6_fwd<true>(qkv, mask, attnout, sm, b, n, heads,
                                      scale, causal, maybe_dead, st);
  } else {
    const size_t smem = attention_fma_smem_bytes(n);
    cudaError_t e = cudaFuncSetAttribute(
        attention_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attention_fma_kernel<<<dim3((n + QT - 1) / QT, heads, b), xclip::kThreads,
                           smem, st>>>(qkv, mask, attnout, n, heads, scale,
                                       causal, maybe_dead, sm, lse);
    XCLIP_CHECK_LAUNCH();
    return 0;
  }
}

// ------------------------------------------------------------ backward

// The backward's tiles hold 64 rows of 64 fp32 (a head's q, k, v or do
// rows, or a 64 x 64 block of p or ds), 16 KB, unpadded. The 16-byte chunk
// c of row r sits at chunk c ^ swz(r) (`swz`): the rows a warp reads at
// one chunk fall into distinct banks.
constexpr int BT = 64 * DH;  // floats of a backward tile
// The register tile: a thread owns 4 rows and kBwdTN columns of each 64 x
// 64 product (4 x kBwdTN fp32 sums), rows 4 ty + i and columns tx + TX j,
// TX = 64 / kBwdTN threads along the columns, 16 rows of threads: 4096 /
// (4 kBwdTN) threads a block. A warp is 4 rows of threads by 8 columns
// (`bwd_tx`, `bwd_ty`), TX / 8 warps side by side: its 16 rows of a
// product are contiguous.
constexpr int kBwdTN = 4;
constexpr int kBwdTX = 64 / kBwdTN;
constexpr int kBwdThreads = 16 * kBwdTX;
// The dk/dv kernel's p and ds tiles: 1, one tile that takes p, then ds
// (seven tiles a block, two blocks an SM); 2, a tile each (one block).
constexpr int kBwdPTiles = 1;
constexpr int kBwdBlocks = kBwdPTiles == 1 ? 2 : 1;  // blocks an SM
// e^(x - m) as K6's 2^(x log2 e - m log2 e) on ex2.approx (true; a few
// fp32 ulps from expf, well inside the 1e-4 gate), or on expf (false)
constexpr bool kBwdEx2 = true;
constexpr size_t kBwdDqSmem =
    sizeof(float) * (7 * BT + 3 * 64) + 8 * xclip::K6_MAX_TILES;
constexpr size_t kBwdDkvSmem = sizeof(float) *
    ((6 + kBwdPTiles) * BT + 3 * 64) + 8 * xclip::K6_MAX_TILES;

__device__ __forceinline__ float bwd_exp(float x, float m) {
  if constexpr (kBwdEx2)
    return xclip::k6_exp(x, m);
  else
    return expf(x - m);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ int bwd_tx() {
  return (threadIdx.x & 7) + 8 * ((threadIdx.x >> 5) % (kBwdTX / 8));
}
__device__ __forceinline__ int bwd_ty() {
  return ((threadIdx.x & 31) >> 3) + 4 * ((threadIdx.x >> 5) / (kBwdTX / 8));
}

// The chunk swizzle of tile row r: distinct for 8 consecutive rows (a
// warp's B rows tx + TX j), and for rows 4 apart from 4 ty (its 4 A rows
// 4 ty + i): the low 3 bits of r, bit 1 flipped by bit 3.
__device__ __forceinline__ int swz(int r) { return (r & 7) ^ ((r >> 2) & 2); }

// Rows [r0, r0 + 64) of the 64 fp32 columns at `col` of a row-major matrix
// (row stride ld) into a tile, by cp.async (16-byte copies) from the
// block's threads; rows at or past n read as 0. The caller commits.
__device__ __forceinline__ void stage_f32(float* tile, const float* src,
                                          long ld, int col, int r0, int n) {
  for (int c = threadIdx.x; c < 64 * 16; c += kBwdThreads) {
    const int r = c >> 4, ch = c & 15;
    const bool in = r0 + r < n;
    xclip::cp_async16(tile + r * 64 + ((ch ^ swz(r)) << 2),
                      src + (in ? (long)(r0 + r) * ld + col + 4 * ch : 0), in);
  }
}

// The thread's 8 row pointers of a tile's rows 4 ty + i: swz(4 ty + i) =
// i ^ swz(4 ty), so chunk c of the row sits at 8 hi + (lo ^ swz(4 ty))
// for c ^ i = 8 hi + lo, and base[lo] + 64 i + 32 hi is its first float.
__device__ __forceinline__ void row_bases(const float* (&base)[8],
                                          const float* tile, int ty) {
#pragma unroll
  for (int lo = 0; lo < 8; ++lo)
    base[lo] = tile + 4 * ty * 64 + ((lo ^ swz(4 * ty)) << 2);
}

// acc[i][j] = a[4 ty + i] . b[tx + TX j] over the 64 columns (q . kᵀ, do .
// vᵀ and, in the dk/dv kernel, k . qᵀ, v . doᵀ), for the first NJ column
// groups j (the rest hold no key or query of the tile and are left
// alone); one FMA chain an element, in column order.
template <int NJ>
__device__ __forceinline__ void tile_abt(float (&acc)[4][kBwdTN],
                                         const float* a, const float* b) {
  constexpr int TX = kBwdTX;
  const int tx = bwd_tx(), ty = bwd_ty();
  const float* pa[8];
  row_bases(pa, a, ty);
  // rows tx + TX j: chunk c at c ^ swz(tx + TX j), which for TX 16 is
  // swz(tx) and for TX 8 depends on j's parity too
  constexpr int PAR = TX == 8 ? 2 : 1;
  const float* pb[PAR][8];
#pragma unroll
  for (int par = 0; par < PAR; ++par)
#pragma unroll
    for (int lo = 0; lo < 8; ++lo)
      pb[par][lo] = b + tx * 64 + ((lo ^ swz(tx + TX * par)) << 2);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int hi = 0; hi < 2; ++hi) {  // halves of the depth
#pragma unroll
    for (int lo = 0; lo < 8; ++lo) {
      float4 av[4], bv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = lds4(pa[lo ^ i] + 64 * i + 32 * hi);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        bv[j] = lds4(pb[j % PAR][lo] + 64 * TX * j + 32 * hi);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float s = fmaf(av[i].x, bv[j].x, acc[i][j]);
          s = fmaf(av[i].y, bv[j].y, s);
          s = fmaf(av[i].z, bv[j].z, s);
          acc[i][j] = fmaf(av[i].w, bv[j].w, s);
        }
    }
  }
}

// acc[i][4 g + e] += Σ_kk p[4 ty + i][kk] b[kk][4 (tx + TX g) + e] over
// the first 4 NC keys kk of a p or ds tile (ds . k, pᵀ . do, dsᵀ . q), in
// key order.
template <int NC>
__device__ __forceinline__ void tile_ab(float (&acc)[4][kBwdTN],
                                        const float* p, const float* b) {
  constexpr int TX = kBwdTX;
  const int tx = bwd_tx(), ty = bwd_ty();
  const float* pa[8];
  row_bases(pa, p, ty);
  // row kk of b, chunk tx + TX g, sits at TX g + (tx ^ swz(kk))
  const float* pb[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) pb[v] = b + ((tx ^ v) << 2);
#pragma unroll
  for (int c = 0; c < NC; ++c) {  // keys 4 c .. 4 c + 3
    float4 av4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = c ^ i;
      av4[i] = lds4(pa[v & 7] + 64 * i + 32 * (v >> 3));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = 4 * c + u;
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = u == 0 ? av4[i].x : u == 1 ? av4[i].y : u == 2 ? av4[i].z
                                                                : av4[i].w;
#pragma unroll
      for (int g = 0; g < kBwdTN / 4; ++g) {
        const float4 bv = lds4(pb[swz(kk)] + kk * 64 + 4 * TX * g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g] = fmaf(av[i], bv.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(av[i], bv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(av[i], bv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(av[i], bv.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// f(integral_constant<k>) for the smallest k in 1..N with k >= m (N if m
// >= N): a product's live column groups as a constant.
template <int N, typename F>
__device__ __forceinline__ void with_groups(int m, F&& f) {
  if constexpr (N > 1) {
    if (m < N) return with_groups<N - 1>(m, f);
  }
  f(std::integral_constant<int, N>{});
}

// Element (4 ty + i, tx + TX j) of a p or ds tile.
__device__ __forceinline__ float& tile_at(float* tile, int i, int j) {
  const int r = 4 * bwd_ty() + i, c = bwd_tx() + kBwdTX * j;
  return tile[r * 64 + (((c >> 2) ^ swz(r)) << 2) + (c & 3)];
}

// Rows 4 ty + i of a (64 x 64) output tile from registers to rows r0 + 4
// ty + i < n of dst (row stride ld), 16-byte stores.
__device__ __forceinline__ void store_tile(float* dst, long ld, int r0, int n,
                                           const float (&acc)[4][kBwdTN]) {
  constexpr int TX = kBwdTX;
  const int tx = bwd_tx(), ty = bwd_ty();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= n) continue;
#pragma unroll
    for (int g = 0; g < kBwdTN / 4; ++g)
      *reinterpret_cast<float4*>(dst + (long)r * ld + 4 * (tx + TX * g)) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]);
  }
}

// The first of the warp's 16 rows of a product.
__device__ __forceinline__ int warp_row0() {
  return 16 * ((threadIdx.x >> 5) / (kBwdTX / 8));
}

// dq and delta, one block per (64-query tile, head, batch element), the
// last query tiles (the most key tiles when causal) first. `dattn` the
// row cotangents (b*n x hd); `attnout` the forward's attention output (b*n
// x hd); `stats` the forward's row statistics (K6's lse; the megablock's
// (m, l)). Writes delta into its scratch for the dk/dv kernel.
template <bool LSE>
__global__ void __launch_bounds__(kBwdThreads, 2)
attention_bwd_dq_kernel(const float* __restrict__ qkv,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ dattn,
                        const float* __restrict__ attnout,
                        const float* __restrict__ stats,
                        float* __restrict__ dqkv, float* __restrict__ delta,
                        int n, int heads, float scale, int causal,
                        int maybe_dead) {
  using namespace xclip;
  constexpr int TX = kBwdTX;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + BT;
  float* ks = dos + BT;      // two buffers
  float* vs = ks + 2 * BT;   // two buffers
  float* dss = vs + 2 * BT;  // ds
  // the tile's rows: delta, m (K6: lse) and 1 / l (K6: 1)
  float* rdelta = dss + BT;
  float* rmax = rdelta + 64;
  float* rlinv = rmax + 64;
  auto* bits = reinterpret_cast<unsigned long long*>(rlinv + 64);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64, h = blockIdx.y;
  const int bi = blockIdx.z, hd = heads * DH, tiles = (n + 63) / 64;
  const long ld = 3L * hd;
  const float* base = qkv + (long)bi * n * ld;
  const int tx = bwd_tx(), ty = bwd_ty();
  // the megablock folds the softmax scale into dp and delta, K6 into ds
  const float dscale = LSE ? 1.f : scale;

  auto stage = [&](int t, int buf) {
    stage_f32(ks + buf * BT, base, ld, hd + h * DH, 64 * t, n);
    stage_f32(vs + buf * BT, base, ld, 2 * hd + h * DH, 64 * t, n);
  };
  stage_f32(qs, base, ld, h * DH, q0, n);
  stage_f32(dos, dattn + (long)bi * n * hd, hd, h * DH, q0, n);
  cp_async_commit();
  const int fv = k6_key_tiles<kBwdThreads>(bits, mask + (long)bi * n, n);
  // a dead row's ds is 0: only key tiles with a valid key up to the
  // diagonal
  const int last = causal ? min(tiles, q0 / 64 + 1) : tiles;
  auto next = [&](int t) {
    for (++t; t < last && !bits[t]; ++t) {
    }
    return t;
  };
  const int first = next(-1);
  cp_async_wait<0>();  // q, do
  __syncthreads();
  // delta = Σ do · out (the megablock: scale Σ dattn · attnout), G threads
  // a row, in column order within a thread, then summed over the G
  {
    constexpr int G = kBwdThreads / 64, CH = 16 / G;
    const int r = threadIdx.x / G, part = threadIdx.x % G, q = q0 + r;
    float acc = 0.f;
    if (q < n) {
      const float* orow = attnout + ((long)bi * n + q) * hd + h * DH;
#pragma unroll
      for (int c = part * CH; c < (part + 1) * CH; ++c) {
        const float4 o = *reinterpret_cast<const float4*>(orow + 4 * c);
        const float4 d = lds4(dos + r * 64 + ((c ^ swz(r)) << 2));
        acc += d.x * o.x * dscale;
        acc += d.y * o.y * dscale;
        acc += d.z * o.z * dscale;
        acc += d.w * o.w * dscale;
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (part == 0) {
      const long row = (long)bi * n + q;
      rdelta[r] = acc;
      rmax[r] = 0.f;
      rlinv[r] = 1.f;
      if (q < n) {
        delta[row * heads + h] = acc;
        rmax[r] = LSE ? stats[row * heads + h] : stats[row * 2 * heads + h];
        if (!LSE) rlinv[r] = 1.f / stats[row * 2 * heads + heads + h];
      }
    }
  }
  __syncthreads();
  // the warp's 16 rows: none at or past n runs a product (the warp still
  // joins the barriers); no key past the last row (causal)
  const int row0 = q0 + warp_row0();
  const bool wlive = row0 < n;
  const int kend = causal ? min(n, row0 + 16) : n;

  float dq[4][kBwdTN] = {};
  tile_walk(first, last, next, stage, [&](int t, int buf) {
    const float* kt = ks + buf * BT;
    const unsigned long long word = bits[t];
    // the column groups (of TX keys) that hold a key the warp's rows read:
    // up to the tile's last valid key and, causal, the warp's last row
    const int cols = min(kend - 64 * t, 64 - __clzll((long long)word));
    const int groups = (cols + TX - 1) / TX;
    if (wlive)
      with_groups<kBwdTN>(groups, [&](auto nj) {
        constexpr int NJ = decltype(nj)::value;
        float s[4][kBwdTN], dp[4][kBwdTN];
        tile_abt<NJ>(s, qs, kt);
        tile_abt<NJ>(dp, dos, vs + buf * BT);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // the row's terms; a dead row's ds is 0
          const int r = 4 * ty + i, q = q0 + r;
          const bool live = q < n &&
                            !(maybe_dead && (causal ? fv > q : fv >= n));
          const float rm = rmax[r], rl = rlinv[r], rd = rdelta[r];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int c = tx + TX * j;
            const bool valid = live && ((word >> c) & 1ull) &&
                               !(causal && 64 * t + c > q);
            float ds = 0.f;
            if (valid) {
              float p = bwd_exp(s[i][j] * scale, rm);
              if (!LSE) p *= rl;
              ds = LSE ? p * (dp[i][j] - rd) * scale
                       : p * (dp[i][j] * scale - rd);
            }
            tile_at(dss, i, j) = ds;
          }
        }
      });
    __syncthreads();
    // dq += ds . k over the same keys (the warp reads only its own rows of
    // the ds tile)
    if (wlive)
      with_groups<kBwdTN>(groups, [&](auto nj) {
        tile_ab<decltype(nj)::value * TX / 4>(dq, dss, kt);
      });
  });
  store_tile(dqkv + (long)bi * n * ld + h * DH, ld, q0, n, dq);
}

// dk and dv, one block per (64-key tile, head, batch element), over the
// query tiles that reach it: from the key tile's on when causal, and
// every tile holding a dead row (its p = 1/n reaches every key). `stats`
// and `delta` as the dq kernel's (delta its output).
template <bool LSE>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocks)
attention_bwd_dkv_kernel(const float* __restrict__ qkv,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ dattn,
                         const float* __restrict__ stats,
                         const float* __restrict__ delta,
                         float* __restrict__ dqkv, int n, int heads,
                         float scale, int causal, int maybe_dead) {
  using namespace xclip;
  constexpr int TX = kBwdTX;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + BT;
  float* qs = vs + BT;        // two buffers
  float* dos = qs + 2 * BT;   // two buffers
  float* ps = dos + 2 * BT;   // p, then ds (kBwdPTiles 2: p; ds next)
  float* dss = ps + (kBwdPTiles - 1) * BT;
  // the walked query tile's row terms: m (K6: lse), 1 / l (K6: 1; 1/n on a
  // dead row) and delta, 64 each
  float* terms = ps + kBwdPTiles * BT;
  auto* bits = reinterpret_cast<unsigned long long*>(terms + 3 * 64);
  const int kt = blockIdx.x, k0 = 64 * kt, h = blockIdx.y, bi = blockIdx.z;
  const int hd = heads * DH, tiles = (n + 63) / 64;
  const long ld = 3L * hd;
  const float* base = qkv + (long)bi * n * ld;
  const float* dbase = dattn + (long)bi * n * hd;
  const int tx = bwd_tx(), ty = bwd_ty();

  auto stage = [&](int t, int buf) {
    stage_f32(qs + buf * BT, base, ld, h * DH, 64 * t, n);
    stage_f32(dos + buf * BT, dbase, hd, h * DH, 64 * t, n);
  };
  stage_f32(ks, base, ld, hd + h * DH, k0, n);
  stage_f32(vs, base, ld, 2 * hd + h * DH, k0, n);
  cp_async_commit();
  const int fv = k6_key_tiles<kBwdThreads>(bits, mask + (long)bi * n, n);
  const unsigned long long kw = bits[kt];
  // queries below `dead_end` are dead rows
  const int dead_end =
      maybe_dead ? (causal ? min(fv, n) : (fv >= n ? n : 0)) : 0;
  auto next = [&](int t) {
    for (++t; t < tiles; ++t)
      if (64 * t < dead_end || (kw && !(causal && 64 * t + 63 < k0))) break;
    return t;
  };
  const int first = next(-1);
  // the thread's keys k0 + 4 ty + i: valid, and < n
  int key[4];
  bool kvalid[4], klive[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    key[i] = k0 + 4 * ty + i;
    kvalid[i] = (kw >> (4 * ty + i)) & 1ull;
    klive[i] = key[i] < n;
  }
  // the warp's 16 keys: none at or past n runs a product (the warp still
  // joins the barriers); nor do 16 keys none of which is valid, on a
  // query tile without a dead row (their p and ds are 0)
  const bool wlive = k0 + warp_row0() < n;
  const bool wkeys = (kw >> warp_row0()) & 0xffffull;
  const float inv_n = 1.f / (float)n;
  // term e = 64 w + c (w < 3) is term w of query c of tile u, fetched from
  // global memory by thread e % kBwdThreads: the next tile's during a tile,
  // stored once the tile's own are read
  constexpr int FT = (3 * 64 + kBwdThreads - 1) / kBwdThreads;  // a thread
  auto fetch = [&](int u, int e) {
    const int w = e >> 6, q = 64 * u + (e & 63);
    const long row = (long)bi * n + q;
    if (w >= 3 || u >= tiles) return 0.f;
    if (q >= n) return w == 1 ? 1.f : 0.f;
    if (w == 0)
      return LSE ? stats[row * heads + h] : stats[row * 2 * heads + h];
    if (w == 2) return delta[row * heads + h];
    return LSE ? (q < dead_end ? inv_n : 1.f)
               : 1.f / stats[row * 2 * heads + heads + h];
  };
#pragma unroll
  for (int f = 0; f < FT; ++f) {
    const int e = threadIdx.x + f * kBwdThreads;
    if (e < 3 * 64) terms[e] = fetch(first, e);
  }

  float dk[4][kBwdTN] = {}, dv[4][kBwdTN] = {};
  tile_walk(first, tiles, next, stage, [&](int t, int buf) {
    const float* qt = qs + buf * BT;
    const float* dt = dos + buf * BT;
    const bool wrun = wlive && (wkeys || 64 * t < dead_end);
    const int u = next(t);
    float fetched[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f)
      fetched[f] = fetch(u, threadIdx.x + f * kBwdThreads);
    with_groups<kBwdTN>((n - 64 * t + TX - 1) / TX, [&](auto nj) {
      constexpr int NJ = decltype(nj)::value;
      const float* cm = terms;
      const float* clinv = terms + 64;
      const float* cd = terms + 128;
      // p (sᵀ = k . qᵀ) into its tile, then dv += pᵀ . do; ds (dpᵀ = v .
      // doᵀ) into its tile, then dk += dsᵀ . q
      float a[4][kBwdTN];
      if (wrun) {
        tile_abt<NJ>(a, ks, qt);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int c = tx + TX * j, q = 64 * t + c;
            float num;
            if (q < dead_end) {
              num = klive[i] ? 1.f : 0.f;  // uniform over the n keys
            } else {
              const bool valid = kvalid[i] && q < n && !(causal && key[i] > q);
              num = valid ? bwd_exp(a[i][j] * scale, cm[c]) : 0.f;
            }
            tile_at(ps, i, j) = num * clinv[c];
          }
      }
      if constexpr (kBwdPTiles == 1) {
        __syncthreads();
        if (wrun) tile_ab<NJ * TX / 4>(dv, ps, dt);
      }
      if (wrun) {
        tile_abt<NJ>(a, vs, dt);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int c = tx + TX * j, q = 64 * t + c;
            const float p = tile_at(ps, i, j);  // this thread's own
            float ds = 0.f;
            if (q >= dead_end && p != 0.f)
              ds = LSE ? p * (a[i][j] - cd[c]) * scale
                       : p * (a[i][j] * scale - cd[c]);
            a[i][j] = ds;
          }
      }
      if constexpr (kBwdPTiles == 1) __syncthreads();  // p read
      if (wrun) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) tile_at(dss, i, j) = a[i][j];
      }
      __syncthreads();  // the tile's terms read
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        const int e = threadIdx.x + f * kBwdThreads;
        if (e < 3 * 64) terms[e] = fetched[f];
      }
      if (wrun) {
        if constexpr (kBwdPTiles == 2) tile_ab<NJ * TX / 4>(dv, ps, dt);
        tile_ab<NJ * TX / 4>(dk, dss, qt);
      }
    });
  });
  cp_async_wait<0>();  // k and v have landed even if no tile was walked
  float* dst = dqkv + (long)bi * n * ld + h * DH;
  store_tile(dst + hd, ld, k0, n, dk);
  store_tile(dst + 2 * hd, ld, k0, n, dv);
}

// The fp32 backward's kernels take their shared memory (above the 48 KB
// default) and the SM's largest shared-memory carveout.
template <bool LSE>
cudaError_t attention_bwd_setup() {
  auto setup = [](const void* kernel, size_t smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  };
  cudaError_t e = setup((const void*)attention_bwd_dq_kernel<LSE>, kBwdDqSmem);
  return e == cudaSuccess
             ? setup((const void*)attention_bwd_dkv_kernel<LSE>, kBwdDkvSmem)
             : e;
}

// Blocks an SM of the fp32 backward's dq (`which` 0) or dk/dv (1) kernel,
// as the occupancy calculator gives them for the build's registers and
// the kernels' shared memory; a negative cudaError_t code on failure.
template <bool LSE>
int attention_bwd_blocks(int which) {
  cudaError_t e = attention_bwd_setup<LSE>();
  int blocks = 0;
  if (e == cudaSuccess)
    e = which == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, attention_bwd_dq_kernel<LSE>, kBwdThreads,
                         kBwdDqSmem)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, attention_bwd_dkv_kernel<LSE>, kBwdThreads,
                         kBwdDkvSmem);
  return e == cudaSuccess ? blocks : -(int)e;
}

// fp32: dqkv (b*n x 3hd) from qkv, the row cotangents dattn (b*n x hd),
// the forward's output attnout (b*n x hd) and row statistics (LSE: K6's
// lse; else the megablock's sm); `delta` is b*n x heads scratch (the dq
// kernel writes it, the dk/dv kernel reads it). The tiles are copied 16
// bytes at a time: every pointer 16-byte aligned.
template <bool LSE>
int launch_attention_fma_bwd(const float* qkv, const uint8_t* mask,
                             const float* dattn, const float* attnout,
                             const float* stats, float* dqkv, float* delta,
                             int b, int n, int heads, float scale, int causal,
                             int maybe_dead, cudaStream_t st) {
  using xclip::aligned16;
  if (n > xclip::K6_MAX_N || !aligned16(qkv) || !aligned16(dattn) ||
      !aligned16(attnout) || !aligned16(dqkv))
    return (int)cudaErrorInvalidValue;
  const cudaError_t ce = attention_bwd_setup<LSE>();
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid((n + 63) / 64, heads, b);
  attention_bwd_dq_kernel<LSE><<<grid, kBwdThreads, kBwdDqSmem, st>>>(
      qkv, mask, dattn, attnout, stats, dqkv, delta, n, heads, scale, causal,
      maybe_dead);
  XCLIP_CHECK_LAUNCH();
  attention_bwd_dkv_kernel<LSE><<<grid, kBwdThreads, kBwdDkvSmem, st>>>(
      qkv, mask, dattn, stats, delta, dqkv, n, heads, scale, causal,
      maybe_dead);
  XCLIP_CHECK_LAUNCH();
  return 0;
}

// The megablock's attention backward: dqkv (b*n x 3hd, T) from qkv, its
// fp32 row cotangents dattn (b*n x hd), attnout and sm; delta (b*n x
// heads) fp32 scratch. bf16 runs the megablock mode of
// attention_block_sm90.cuh, whose dq kernel rewrites dattn in place as its
// two bf16 copies (the caller's scratch, read by nothing after this
// launch); fp32 the FMA kernels above.
template <typename T>
int launch_mega_attention_bwd(const T* qkv, const uint8_t* mask, float* dattn,
                              const T* attnout, const float* sm, T* dqkv,
                              float* delta, int b, int n, int heads,
                              float scale, int causal, int maybe_dead,
                              cudaStream_t st) {
  if constexpr (std::is_same<T, xclip::bf16>::value)
    return xclip::launch_k6_bwd<true>(
        qkv, mask, attnout, sm, dattn, reinterpret_cast<xclip::bf16*>(dattn),
        dqkv, delta, b, n, heads, scale, causal, maybe_dead, st);
  else
    return launch_attention_fma_bwd<false>(qkv, mask, dattn, attnout, sm,
                                           dqkv, delta, b, n, heads, scale,
                                           causal, maybe_dead, st);
}

constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90

// Largest sequence length the forward takes in dtype code `dtype`: bf16
// the mma.sync kernels' 64 * K6_MAX_TILES; fp32 as long as the forward
// tile's score rows fit one block's shared memory.
inline int attention_max_n(int dtype) {
  if (dtype != xclip::kF32) return xclip::K6_MAX_N;
  return (int)((kMaxSmem - attention_fma_smem_bytes(0)) /
               (sizeof(float) * QT));
}

// Largest sequence length the backward takes in `dtype`: the mask words
// of K6_MAX_TILES key tiles, 2048, in both dtypes (the fp32 kernels keep
// no score row whole; fp32 training stops at the forward's limit).
inline int attention_bwd_max_n(int dtype) { return xclip::K6_MAX_N; }

// the fp32 backward's blocks an SM: each takes its shared memory and 1 KB
// the card reserves a block, of the SM's 233,472 bytes
static_assert(2 * (kBwdDqSmem + 1024) <= 233472, "two dq blocks an SM");
static_assert(kBwdBlocks * (kBwdDkvSmem + 1024) <= 233472,
              "the dk/dv kernel's blocks an SM");

}  // namespace
