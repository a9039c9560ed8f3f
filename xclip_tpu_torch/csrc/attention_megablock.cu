// The whole attention block,
//     out = x + LN_gout(attention(LN_gpre(x) @ w_qkv) @ w_out):
//   * K-MEGA, the inference forward, in place of the Pallas kernel
//     `_fwd_kernel` (with `_fwd_common`) of
//     xclip_tpu/kernels/attention_megablock.py, reached through `_mega_fwd`
//     with need_residuals=False;
//   * K2, the stored variant that training runs (`store_qkv=True`): the
//     forward in place of `_fwd_kernel_stored` (the same five launches,
//     also keeping the residuals and statistics the backward reads) and
//     the backward in place of `_bwd_kernel_stored` with `_mega_bwd_vjp`'s
//     dW_qkv product (its source note is further down);
//   * K3, the memory-lean variants (`store_qkv=False` / "qkv"): the
//     forward in place of `_fwd_kernel_stats` and `_fwd_kernel_qkv` (the
//     same five launches keeping only the fp32 statistics, and qkv for the
//     second), the backward in place of `_bwd_kernel` and `_bwd_kernel_qkv`
//     (its note is at the end).
//
// Cast order (as the Pallas kernel): LN_pre in fp32, xn cast to the storage
// dtype; qkv = xn @ w_qkv accumulates in fp32 and is cast to the storage
// dtype. Head h takes q from columns [h*64, (h+1)*64), k from hd + h*64 and
// v from 2*hd + h*64. Scores are fp32 (q . k) * scale; keys where the mask
// is 0, and keys past the query when causal, get -inf. With maybe_dead a
// row with no valid key gets m = 0 and p = 1 on every column (uniform
// weights). l = max(sum p, 1e-30); p / l is cast to the storage dtype
// before p @ v (fp32 accumulation), and the head outputs are cast to the
// storage dtype. proj = attnout @ w_out in fp32, LN_out in fp32, cast to
// the storage dtype, then x is added in the storage dtype.
//
// Design: five launches on the caller's stream.
//   1. ln_rows: xn = T(LN_gpre(x))                           (b*n x dim, T)
//   2. mm: qkv = T(xn @ w_qkv)                               (b*n x 3hd, T)
//   3. attention, one block per (32-query tile, head, batch element): the
//      tile's full fp32 score rows (32 x n) live in shared memory, so the
//      softmax is exact rather than online (at n = 257 one head's full
//      score matrix, 264 KB, would not fit one block). bf16: q.k and p.v on
//      the tensor cores (wmma, fp32 accumulation); fp32: FMAs. (b*n x hd, T)
//   4. mm: proj = attnout @ w_out                            (b*n x dim, fp32)
//   5. ln_rows with residual: out = T(LN_gout(proj)) + x     (b*n x dim, T)
//
// What bounds it on the card: the qkv and output products run on wmma
// without wgmma or TMA (common.cuh), and the attention core re-stages k
// and v for every 32-query tile and walks the score rows three times in
// shared memory for the exact softmax. HBM round-trips a later PR removes
// first: qkv (b*n x 3hd) and the fp32 proj, then xn and attnout.
#include "common.cuh"

namespace {

constexpr int QT = 32;       // queries per block
constexpr int KC = 64;       // keys staged per step
constexpr int DH = 64;       // dim_head
constexpr int ALD = DH + 1;  // padded row stride of the staged q/k/v rows

// The training forward keeps each row's softmax max m (0 on a dead row) and
// normaliser l per head: sm is (b*n) x (2*heads), m at column h, l at
// heads + h.
__device__ __forceinline__ void store_softmax_stats(float* sm, int bi, int n,
                                                    int q, int h, int heads,
                                                    float m, float l) {
  float* row = sm + ((long)bi * n + q) * 2 * heads;
  row[h] = m;
  row[heads + h] = l;
}

// --- fp32: FMAs from shared memory

size_t attention_fma_smem_bytes(int n) {
  return sizeof(float) * ((size_t)QT * n + QT * ALD + KC * ALD);
}

template <typename T>
__global__ void __launch_bounds__(xclip::kThreads)
attention_fma_kernel(const T* __restrict__ qkv,
                     const uint8_t* __restrict__ mask, T* __restrict__ attnout,
                     int n, int heads, float scale, int causal,
                     int maybe_dead, float* __restrict__ sm) {
  using namespace xclip;
  // one dynamic shared-memory array per translation unit: every kernel
  // declares it alike and casts
  extern __shared__ __align__(128) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);  // QT x n scores, then probs
  float* qs = s + QT * n;      // QT x ALD
  float* kv = qs + QT * ALD;   // KC x ALD
  const int q0 = blockIdx.x * QT, h = blockIdx.y, bi = blockIdx.z;
  const int hd = heads * DH, ld = 3 * hd;
  const T* base = qkv + (long)bi * n * ld;
  const uint8_t* mrow = mask + (long)bi * n;

  for (int i = threadIdx.x; i < QT * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    qs[r * ALD + d] =
        q0 + r < n ? to_f(base[(long)(q0 + r) * ld + h * DH + d]) : 0.f;
  }
  for (int j0 = 0; j0 < n; j0 += KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < KC * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      kv[r * ALD + d] =
          j0 + r < n ? to_f(base[(long)(j0 + r) * ld + hd + h * DH + d]) : 0.f;
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
    if (sm && lane == 0)
      store_softmax_stats(sm, bi, n, q0 + r, h, heads, mx, l);
    for (int j = lane; j < n; j += 32) sr[j] = round_to<T>(sr[j] / l);
  }

  // o = p @ v; thread t owns outputs (r, d) = divmod(t + i * kThreads, DH)
  constexpr int OPT = QT * DH / kThreads;
  float acc[OPT] = {};
  for (int j0 = 0; j0 < n; j0 += KC) {
    __syncthreads();
    for (int i = threadIdx.x; i < KC * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      kv[r * ALD + d] = j0 + r < n
          ? to_f(base[(long)(j0 + r) * ld + 2 * hd + h * DH + d]) : 0.f;
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
    if (q0 + r < n)
      attnout[((long)bi * n + q0 + r) * hd + h * DH + d] = from_f<T>(acc[t]);
  }
}

// --- bf16: tensor cores. Shared memory: fp32 scores (QT x ldS), bf16
// probabilities (QT x ldP), the q tile and one k or v slice (bf16, KC keys).
constexpr int QLD = DH + 8;  // bf16 row stride of the staged q/k/v rows
constexpr int OLD = DH + 4;  // fp32 row stride of the staged output tile

__host__ __device__ constexpr size_t up128(size_t b) {
  return (b + 127) / 128 * 128;
}

struct TcLayout {
  int n_pad, lds, ldp;
  size_t s, p, q, kv, bytes;  // byte offsets, total
  __host__ __device__ explicit TcLayout(int n) {
    n_pad = (n + KC - 1) / KC * KC;
    lds = n_pad + 4;
    ldp = n_pad + 8;
    s = 0;
    p = up128(s + sizeof(float) * QT * lds);
    q = up128(p + 2 * (size_t)QT * ldp);
    kv = up128(q + 2 * QT * QLD);
    bytes = up128(kv + 2 * KC * QLD);
  }
};

// Stage rows [r0, r0 + rows) of the 64 columns at `col` of head-major qkv
// (row stride ld) as bf16 rows of stride QLD; rows at or past n read as 0.
__device__ __forceinline__ void stage_rows(xclip::bf16* dst,
                                           const xclip::bf16* base, int ld,
                                           int col, int r0, int rows, int n) {
  for (int c = threadIdx.x; c < rows * DH / 8; c += xclip::kThreads) {
    const int r = c / (DH / 8), d = (c % (DH / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      v = *reinterpret_cast<const uint4*>(base + (long)(r0 + r) * ld + col + d);
    *reinterpret_cast<uint4*>(dst + r * QLD + d) = v;
  }
}

__global__ void __launch_bounds__(xclip::kThreads)
attention_tc_kernel(const xclip::bf16* __restrict__ qkv,
                    const uint8_t* __restrict__ mask,
                    xclip::bf16* __restrict__ attnout, int n, int heads,
                    float scale, int causal, int maybe_dead,
                    float* __restrict__ sm) {
  using namespace xclip;
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const TcLayout L(n);
  float* s = reinterpret_cast<float*>(smem + L.s);
  bf16* p = reinterpret_cast<bf16*>(smem + L.p);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* kv = reinterpret_cast<bf16*>(smem + L.kv);
  const int q0 = blockIdx.x * QT, h = blockIdx.y, bi = blockIdx.z;
  const int hd = heads * DH, ld = 3 * hd;
  const bf16* base = qkv + (long)bi * n * ld;
  const uint8_t* mrow = mask + (long)bi * n;
  // warp w owns the 16-row block (w & 1) and 16-column blocks 2(w >> 1),
  // 2(w >> 1) + 1 of each 32 x 64 product tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fr = (warp & 1) * 16, fc = (warp >> 1) * 32;

  stage_rows(qs, base, ld, h * DH, q0, QT, n);
  for (int j0 = 0; j0 < L.n_pad; j0 += KC) {  // s = q . k^T, raw fp32
    __syncthreads();
    stage_rows(kv, base, ld, hd + h * DH, j0, KC, n);
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, qs + fr * QLD + kk, QLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // k^T: column-major view of k rows
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, kv + (fc + 16 * j) * QLD + kk, QLD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s + fr * L.lds + j0 + fc + 16 * j, acc[j], L.lds,
                              wmma::mem_row_major);
  }
  __syncthreads();

  // softmax, one warp per query row: scale, mask, max, exp, sum, p / l
  for (int r = warp; r < QT; r += kThreads / 32) {
    float* sr = s + r * L.lds;
    bf16* pr = p + r * L.ldp;
    if (q0 + r >= n) {
      for (int j = lane; j < L.n_pad; j += 32) pr[j] = from_f<bf16>(0.f);
      continue;
    }
    bool dead = false;
    if (maybe_dead) {
      const int lim = causal ? q0 + r + 1 : n;
      int any = 0;
      for (int j = lane; j < lim; j += 32) any |= mrow[j] != 0;
      dead = !__any_sync(0xffffffffu, any);
    }
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const bool valid = mrow[j] != 0 && !(causal && j > q0 + r);
      const float v = valid ? sr[j] * scale : -INFINITY;
      sr[j] = v;
      mx = fmaxf(mx, v);
    }
    mx = dead ? 0.f : warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = dead ? 1.f : expf(sr[j] - mx);
      sr[j] = e;
      sum += e;
    }
    const float l = fmaxf(warp_sum(sum), 1e-30f);
    if (sm && lane == 0)
      store_softmax_stats(sm, bi, n, q0 + r, h, heads, mx, l);
    for (int j = lane; j < L.n_pad; j += 32)
      pr[j] = from_f<bf16>(j < n ? sr[j] / l : 0.f);
  }

  // o = p @ v
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int j0 = 0; j0 < L.n_pad; j0 += KC) {
    __syncthreads();
    stage_rows(kv, base, ld, 2 * hd + h * DH, j0, KC, n);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, p + fr * L.ldp + j0 + kk, L.ldp);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, kv + kk * QLD + fc + 16 * j, QLD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  // the scores are dead: stage the fp32 output tile in their place
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(s + fr * OLD + fc + 16 * j, acc[j], OLD,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < QT * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    if (q0 + r < n)
      attnout[((long)bi * n + q0 + r) * hd + h * DH + d] =
          from_f<bf16>(s[r * OLD + d]);
  }
}

template <typename T>
int launch_attention(const T* qkv, const uint8_t* mask, T* attnout, int b,
                     int n, int heads, float scale, int causal, int maybe_dead,
                     float* sm, cudaStream_t st) {
  const dim3 grid((n + QT - 1) / QT, heads, b);
  cudaError_t e;
  if constexpr (std::is_same<T, xclip::bf16>::value) {
    const size_t smem = TcLayout(n).bytes;
    e = cudaFuncSetAttribute(attention_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    attention_tc_kernel<<<grid, xclip::kThreads, smem, st>>>(
        qkv, mask, attnout, n, heads, scale, causal, maybe_dead, sm);
  } else {
    const size_t smem = attention_fma_smem_bytes(n);
    e = cudaFuncSetAttribute(attention_fma_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    attention_fma_kernel<T><<<grid, xclip::kThreads, smem, st>>>(
        qkv, mask, attnout, n, heads, scale, causal, maybe_dead, sm);
  }
  XCLIP_CHECK_LAUNCH();
  return 0;
}

// The same five launches serve inference (K-MEGA) and the training
// forwards (K2, `_fwd_kernel_stored`; K3, `_fwd_kernel_stats` and
// `_fwd_kernel_qkv`): with `sm`, the attention kernel also keeps its
// softmax statistics; with `ln_stats` (statistic k of row r at
// ln_stats[k * stats_ld + r]: mean_pre, inv_pre, mean_o, inv_o) the two
// LayerNorm launches keep theirs, and with `proj_s` the out-LN launch
// writes proj rounded to T there (the statistics come from the fp32 proj,
// as in the Pallas kernel). qkv and attnout are K2's residuals as they
// stand, and qkv K3's "qkv" residual; K3 "stats" keeps neither. A batch
// chunk of a longer call writes into its columns of the caller's
// statistics (stats_ld the caller's rows).
template <typename T>
int attention_block_fwd(const T* x, const T* g_pre, const T* w_qkv,
                        const T* w_out, const T* g_out, const uint8_t* mask,
                        T* out, T* xn, T* qkv, T* attnout, float* proj, int b,
                        int n, int dim, int heads, float scale, int causal,
                        int maybe_dead, float eps, cudaStream_t st,
                        T* proj_s = nullptr, float* sm = nullptr,
                        float* ln_stats = nullptr, long stats_ld = 0) {
  using namespace xclip;
  const int rows = b * n, hd = heads * DH;
  float* ls = ln_stats;
  const long ld = stats_ld;
  int e;
  if ((e = launch_ln_rows<T, T>(x, g_pre, nullptr, xn, rows, dim, eps, st,
                                ls, ls ? ls + ld : nullptr)))
    return e;
  if ((e = launch_mm<T, kStore>(xn, w_qkv, nullptr, qkv, rows, 3 * hd, dim, st)))
    return e;
  if ((e = launch_attention<T>(qkv, mask, attnout, b, n, heads, scale, causal,
                               maybe_dead, sm, st)))
    return e;
  if ((e = launch_mm<T, kStoreF32>(attnout, w_out, nullptr, proj, rows, dim,
                                   hd, st)))
    return e;
  return launch_ln_rows<float, T>(proj, g_out, x, out, rows, dim, eps, st,
                                  ls ? ls + 2 * ld : nullptr,
                                  ls ? ls + 3 * ld : nullptr, proj_s);
}

// ------------------------------------------------------------ K2 backward
//
// In place of `_bwd_kernel_stored` (with `_mega_bwd_vjp`'s dW_qkv product)
// of xclip_tpu/kernels/attention_megablock.py. From the forward's stored
// qkv, attnout, proj (T) and fp32 statistics, per batch element:
//   dproj = T(LN_out vjp of do)           dg_out = sum of do * xhat_o
//   dattn = dproj · w_outᵀ (fp32)          dW_out = attnoutᵀ · dproj
//   per head: p = (dead ? 1 : exp(s - m)) / l from the stored m, l (not
//   re-reduced), delta = scale * sum_d dattn * attnout, dp = T(dattn *
//   scale) · vᵀ, ds = T(dead ? 0 : p * (dp - delta)), dq = ds · k,
//   dk = dsᵀ · q, dv = T(p)ᵀ · T(dattn), each cast to T once
//   dxn = dqkv · w_qkvᵀ (fp32), dx = T(LN_pre vjp + do), dg_pre
//   dW_qkv = xnᵀ · dqkv, xn rebuilt from the stored mean_pre / inv_pre.
// One head's 257 x 257 fp32 scores exceed a block's shared memory, and dk,
// dv sum over every query while dq sums over every key. So the attention
// part is two kernels, each owning its outputs (no atomics): a query-tile
// kernel (32 queries x all keys, as the forward) gives dq and the row terms
// delta; a key-tile kernel (64 keys, walking all queries 32 at a time)
// recomputes s and dp for its keys and gives dk and dv. The products, LN
// backwards and column sums are common.cuh's, dW through ordered split
// partials, so two runs agree bit for bit.
//
// What bounds it on the card: s and dp are computed twice (once per
// attention kernel), all on wmma 16x16x16 from shared memory; the
// surrounding products on the wmma tiling; the fp32 dattn and dxn round
// trips through HBM.
constexpr int BQ = 32;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int PLD = BK + 8;   // row stride of the T key-tile rows (p, ds)

// C (M x N, fp32, row stride ldc) (+)= opA · opB over K, in shared memory,
// by the block's kThreads threads. opA(i, k) = ACOL ? a[i + k * lda] :
// a[i * lda + k]; opB(k, j) = BCOL ? b[k + j * ldb] : b[k * ldb + j]. bf16:
// wmma 16x16x16 tiles, one warp per output tile in turn; fp32: FMAs in k
// order. The caller synchronises around it.
template <int M, int N, bool ACOL, bool BCOL, typename T>
__device__ void block_mma(float* C, int ldc, const T* a, int lda, const T* b,
                          int ldb, int K, bool accumulate) {
  if constexpr (std::is_same<T, xclip::bf16>::value) {
    using namespace nvcuda;
    using LA = typename std::conditional<ACOL, wmma::col_major,
                                         wmma::row_major>::type;
    using LB = typename std::conditional<BCOL, wmma::col_major,
                                         wmma::row_major>::type;
    constexpr int TN = N / 16;
    for (int t = threadIdx.x >> 5; t < (M / 16) * TN;
         t += xclip::kThreads / 32) {
      const int ti = t / TN, tj = t % TN;
      float* cp = C + ti * 16 * ldc + tj * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (accumulate)
        wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, xclip::bf16, LA> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, xclip::bf16, LB> fb;
        wmma::load_matrix_sync(
            fa, ACOL ? a + ti * 16 + k0 * lda : a + ti * 16 * lda + k0, lda);
        wmma::load_matrix_sync(
            fb, BCOL ? b + k0 + tj * 16 * ldb : b + k0 * ldb + tj * 16, ldb);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += xclip::kThreads) {
      const int i = idx / N, j = idx % N;
      float s = accumulate ? C[i * ldc + j] : 0.f;
      for (int k = 0; k < K; ++k)
        s = fmaf(ACOL ? a[i + k * lda] : a[i * lda + k],
                 BCOL ? b[k + j * ldb] : b[k * ldb + j], s);
      C[i * ldc + j] = s;
    }
  }
}

// Stage rows [r0, r0 + rows) of the 64 columns at `col` (row stride ld) as
// rows of stride QLD; rows at or past n read as 0.
template <typename T>
__device__ __forceinline__ void stage_head(T* dst, const T* base, int ld,
                                           int col, int r0, int rows, int n) {
  if constexpr (std::is_same<T, xclip::bf16>::value) {
    stage_rows(dst, base, ld, col, r0, rows, n);
  } else {
    for (int i = threadIdx.x; i < rows * DH; i += xclip::kThreads) {
      const int r = i / DH, d = i % DH;
      dst[r * QLD + d] = r0 + r < n ? base[(long)(r0 + r) * ld + col + d] : 0.f;
    }
  }
}

// The first valid key of a batch element's mask (n if none): a row q is
// dead when no key up to q (causal) or none at all is valid.
__device__ int first_valid_key(const uint8_t* mrow, int n) {
  __shared__ int fv;
  if (threadIdx.x == 0) fv = n;
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += xclip::kThreads)
    if (mrow[j]) {
      atomicMin(&fv, j);  // integer minimum: the same result in any order
      break;
    }
  __syncthreads();
  return fv;
}

struct DqLayout {
  int n_pad, lds, ldp;
  size_t sp, ds, qs, dos, kv, dpc, dqa, info, bytes;
  __host__ __device__ DqLayout(int n, int tsize) {
    n_pad = (n + BK - 1) / BK * BK;
    lds = n_pad + 4;
    ldp = n_pad + 8;
    sp = 0;
    ds = up128(sp + sizeof(float) * BQ * lds);
    qs = up128(ds + (size_t)tsize * BQ * ldp);
    dos = up128(qs + (size_t)tsize * BQ * QLD);
    kv = up128(dos + (size_t)tsize * BQ * QLD);
    dpc = up128(kv + (size_t)tsize * BK * QLD);
    dqa = up128(dpc + sizeof(float) * BQ * OLD);
    info = up128(dqa + sizeof(float) * BQ * OLD);
    bytes = up128(info + sizeof(float) * 4 * BQ);
  }
};

// dq for one (32-query tile, head, batch element), and delta for its rows.
template <typename T>
__global__ void __launch_bounds__(xclip::kThreads)
attention_bwd_dq_kernel(const T* __restrict__ qkv,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ dattn,
                        const T* __restrict__ attnout,
                        const float* __restrict__ sm, T* __restrict__ dqkv,
                        float* __restrict__ delta, int n, int heads,
                        float scale, int causal, int maybe_dead) {
  using namespace xclip;
  extern __shared__ __align__(128) unsigned char smem[];
  const DqLayout L(n, sizeof(T));
  float* sp = reinterpret_cast<float*>(smem + L.sp);
  T* ds = reinterpret_cast<T*>(smem + L.ds);
  T* qs = reinterpret_cast<T*>(smem + L.qs);
  T* dos = reinterpret_cast<T*>(smem + L.dos);
  T* kv = reinterpret_cast<T*>(smem + L.kv);
  float* dpc = reinterpret_cast<float*>(smem + L.dpc);
  float* dqa = reinterpret_cast<float*>(smem + L.dqa);
  float* rm = reinterpret_cast<float*>(smem + L.info);
  float* rl = rm + BQ;
  float* rdelta = rl + BQ;
  float* rdead = rdelta + BQ;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bi = blockIdx.z;
  const int hd = heads * DH, ld = 3 * hd;
  const T* base = qkv + (long)bi * n * ld;
  const uint8_t* mrow = mask + (long)bi * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fv = first_valid_key(mrow, n);

  stage_head(qs, base, ld, h * DH, q0, BQ, n);
  for (int i = threadIdx.x; i < BQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH, q = q0 + r;
    dos[r * QLD + d] = from_f<T>(
        q < n ? dattn[((long)bi * n + q) * hd + h * DH + d] * scale : 0.f);
  }
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const int q = q0 + r;
    float dl = 0.f;
    if (q < n)
      for (int d = lane; d < DH; d += 32) {
        const long o = ((long)bi * n + q) * hd + h * DH + d;
        dl += dattn[o] * to_f(attnout[o]) * scale;
      }
    dl = warp_sum(dl);
    if (lane == 0) {
      const float* srow = sm + ((long)bi * n + (q < n ? q : 0)) * 2 * heads;
      rm[r] = q < n ? srow[h] : 0.f;
      rl[r] = q < n ? srow[heads + h] : 1.f;
      rdelta[r] = dl;
      rdead[r] = maybe_dead && (causal ? fv > q : fv >= n);
      if (q < n) delta[((long)bi * n + q) * heads + h] = dl;
    }
  }
  for (int j0 = 0; j0 < L.n_pad; j0 += BK) {  // s = q · kᵀ, raw fp32
    __syncthreads();
    stage_head(kv, base, ld, hd + h * DH, j0, BK, n);
    __syncthreads();
    block_mma<BQ, BK, false, true>(sp + j0, L.lds, qs, QLD, kv, QLD, DH,
                                   false);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * L.n_pad; i += kThreads) {
    const int r = i / L.n_pad, j = i % L.n_pad, q = q0 + r;
    float p = 0.f;
    if (q < n && j < n) {
      const bool valid = mrow[j] != 0 && !(causal && j > q);
      const float v = valid ? sp[r * L.lds + j] * scale : -INFINITY;
      p = (rdead[r] != 0.f ? 1.f : expf(v - rm[r])) / rl[r];
    }
    sp[r * L.lds + j] = p;
  }
  for (int j0 = 0; j0 < L.n_pad; j0 += BK) {  // dp, ds
    __syncthreads();
    stage_head(kv, base, ld, 2 * hd + h * DH, j0, BK, n);
    __syncthreads();
    block_mma<BQ, BK, false, true>(dpc, OLD, dos, QLD, kv, QLD, DH, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK, j = j0 + c, q = q0 + r;
      float v = 0.f;
      if (q < n && j < n && rdead[r] == 0.f)
        v = sp[r * L.lds + j] * (dpc[r * OLD + c] - rdelta[r]);
      ds[r * L.ldp + j] = from_f<T>(v);
    }
  }
  for (int j0 = 0; j0 < L.n_pad; j0 += BK) {  // dq = ds · k
    __syncthreads();
    stage_head(kv, base, ld, hd + h * DH, j0, BK, n);
    __syncthreads();
    block_mma<BQ, DH, false, false>(dqa, OLD, ds + j0, L.ldp, kv, QLD, BK,
                                    j0 > 0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    if (q0 + r < n)
      dqkv[((long)bi * n + q0 + r) * ld + h * DH + d] =
          from_f<T>(dqa[r * OLD + d]);
  }
}

struct DkvLayout {
  size_t ks, vs, qs, dos, dov, sc, dpc, pT, dsT, dka, dva, info, bytes;
  __host__ __device__ explicit DkvLayout(int tsize) {
    ks = 0;
    vs = up128(ks + (size_t)tsize * BK * QLD);
    qs = up128(vs + (size_t)tsize * BK * QLD);
    dos = up128(qs + (size_t)tsize * BQ * QLD);
    dov = up128(dos + (size_t)tsize * BQ * QLD);
    sc = up128(dov + (size_t)tsize * BQ * QLD);
    dpc = up128(sc + sizeof(float) * BQ * OLD);
    pT = up128(dpc + sizeof(float) * BQ * OLD);
    dsT = up128(pT + (size_t)tsize * BQ * PLD);
    dka = up128(dsT + (size_t)tsize * BQ * PLD);
    dva = up128(dka + sizeof(float) * BK * OLD);
    info = up128(dva + sizeof(float) * BK * OLD);
    bytes = up128(info + sizeof(float) * 4 * BQ);
  }
};

// dk and dv for one (64-key tile, head, batch element), over every query.
template <typename T>
__global__ void __launch_bounds__(xclip::kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ qkv,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ dattn,
                         const float* __restrict__ sm,
                         const float* __restrict__ delta, T* __restrict__ dqkv,
                         int n, int heads, float scale, int causal,
                         int maybe_dead) {
  using namespace xclip;
  extern __shared__ __align__(128) unsigned char smem[];
  const DkvLayout L(sizeof(T));
  T* ks = reinterpret_cast<T*>(smem + L.ks);
  T* vs = reinterpret_cast<T*>(smem + L.vs);
  T* qs = reinterpret_cast<T*>(smem + L.qs);
  T* dos = reinterpret_cast<T*>(smem + L.dos);
  T* dov = reinterpret_cast<T*>(smem + L.dov);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* dpc = reinterpret_cast<float*>(smem + L.dpc);
  T* pT = reinterpret_cast<T*>(smem + L.pT);
  T* dsT = reinterpret_cast<T*>(smem + L.dsT);
  float* dka = reinterpret_cast<float*>(smem + L.dka);
  float* dva = reinterpret_cast<float*>(smem + L.dva);
  float* rm = reinterpret_cast<float*>(smem + L.info);
  float* rl = rm + BQ;
  float* rdelta = rl + BQ;
  float* rdead = rdelta + BQ;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, bi = blockIdx.z;
  const int hd = heads * DH, ld = 3 * hd;
  const T* base = qkv + (long)bi * n * ld;
  const uint8_t* mrow = mask + (long)bi * n;
  const int fv = first_valid_key(mrow, n);

  stage_head(ks, base, ld, hd + h * DH, k0, BK, n);
  stage_head(vs, base, ld, 2 * hd + h * DH, k0, BK, n);
  for (int r0 = 0; r0 < n; r0 += BQ) {
    __syncthreads();
    stage_head(qs, base, ld, h * DH, r0, BQ, n);
    for (int i = threadIdx.x; i < BQ * DH; i += kThreads) {
      const int r = i / DH, d = i % DH, q = r0 + r;
      const float a =
          q < n ? dattn[((long)bi * n + q) * hd + h * DH + d] : 0.f;
      dos[r * QLD + d] = from_f<T>(a * scale);
      dov[r * QLD + d] = from_f<T>(a);
    }
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const int q = r0 + r;
      const long row = (long)bi * n + (q < n ? q : 0);
      rm[r] = q < n ? sm[row * 2 * heads + h] : 0.f;
      rl[r] = q < n ? sm[row * 2 * heads + heads + h] : 1.f;
      rdelta[r] = q < n ? delta[row * heads + h] : 0.f;
      rdead[r] = maybe_dead && (causal ? fv > q : fv >= n);
    }
    __syncthreads();
    block_mma<BQ, BK, false, true>(sc, OLD, qs, QLD, ks, QLD, DH, false);
    block_mma<BQ, BK, false, true>(dpc, OLD, dos, QLD, vs, QLD, DH, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK, q = r0 + r, j = k0 + c;
      float p = 0.f, v = 0.f;
      if (q < n && j < n) {
        const bool valid = mrow[j] != 0 && !(causal && j > q);
        const float s = valid ? sc[r * OLD + c] * scale : -INFINITY;
        p = (rdead[r] != 0.f ? 1.f : expf(s - rm[r])) / rl[r];
        if (rdead[r] == 0.f) v = p * (dpc[r * OLD + c] - rdelta[r]);
      }
      pT[r * PLD + c] = from_f<T>(p);
      dsT[r * PLD + c] = from_f<T>(v);
    }
    __syncthreads();
    block_mma<BK, DH, true, false>(dka, OLD, dsT, PLD, qs, QLD, BQ, r0 > 0);
    block_mma<BK, DH, true, false>(dva, OLD, pT, PLD, dov, QLD, BQ, r0 > 0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BK * DH; i += kThreads) {
    const int c = i / DH, d = i % DH, j = k0 + c;
    if (j < n) {
      const long o = ((long)bi * n + j) * ld + h * DH + d;
      dqkv[o + hd] = from_f<T>(dka[c * OLD + d]);
      dqkv[o + 2 * hd] = from_f<T>(dva[c * OLD + d]);
    }
  }
}

template <typename T>
struct MegaBwdBuffers {
  T* dproj;
  float* dattn;
  float* delta;
  float* dxn;
  T* xn;
  float* part_out;
  float* part_pre;
  float* wpart;
  MegaBwdBuffers(xclip::Workspace& ws, int b, int n, int dim, int heads) {
    using namespace xclip;
    const int rows = b * n, hd = heads * DH;
    const bool tc = std::is_same<T, bf16>::value;
    dproj = ws.take<T>((size_t)rows * dim);
    dattn = ws.take<float>((size_t)rows * hd);
    delta = ws.take<float>((size_t)rows * heads);
    dxn = ws.take<float>((size_t)rows * dim);
    xn = ws.take<T>((size_t)rows * dim);
    part_out = ws.take<float>((size_t)ln_bwd_blocks(rows) * dim);
    part_pre = ws.take<float>((size_t)ln_bwd_blocks(rows) * dim);
    wpart = ws.take<float>(
        std::max(weight_grad_part_bytes(hd, dim, rows, tc),
                 weight_grad_part_bytes(dim, 3 * hd, rows, tc)) /
        sizeof(float));
  }
};

// The backward from qkv, attnout, proj (T for K2's stored proj, fp32 for
// K3's recomputed one) and the statistics (`ln_stats` with row stride
// stats_ld), into dx and dqkv; dW_qkv, dW_out, dg_pre and dg_out are
// emitted as launch_emit_sum's `acc` says (0: T, K2; 1, 2: fp32 chunk sums,
// K3).
template <typename T, typename Tp>
int attention_block_bwd_core(const T* x, const T* g_pre, const T* w_qkv,
                             const T* w_out, const T* g_out,
                             const uint8_t* mask, const T* dout,
                             const T* qkv, const T* attnout, const Tp* proj,
                             const float* sm, const float* ln_stats,
                             long stats_ld, T* dx, T* dqkv, void* dw_qkv,
                             void* dw_out, void* dg_pre, void* dg_out,
                             MegaBwdBuffers<T>& w, int b, int n, int dim,
                             int heads, float scale, int causal,
                             int maybe_dead, int acc, cudaStream_t st) {
  using namespace xclip;
  const int rows = b * n, hd = heads * DH, nblk = ln_bwd_blocks(rows);
  const long ld = stats_ld;
  int e;
  if ((e = launch_ln_bwd_rows<T, Tp, T, kLnBwd>(
           dout, proj, ln_stats + 2 * ld, ln_stats + 3 * ld, g_out, nullptr,
           w.dproj, w.part_out, rows, dim, st)))
    return e;
  if ((e = launch_emit_sum<T>(w.part_out, dg_out, nblk, dim, acc, st)))
    return e;
  if ((e = launch_gemm<T, false, true>(w.dproj, w_out, w.dattn, rows, hd, dim,
                                       st)))
    return e;
  if ((e = launch_weight_grad<T>(attnout, w.dproj, dw_out, w.wpart, hd, dim,
                                 rows, st, acc)))
    return e;
  const size_t dq_smem = DqLayout(n, sizeof(T)).bytes;
  const size_t dkv_smem = DkvLayout(sizeof(T)).bytes;
  cudaError_t ce = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem);
  if (ce == cudaSuccess)
    ce = cudaFuncSetAttribute(attention_bwd_dkv_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)dkv_smem);
  if (ce != cudaSuccess) return (int)ce;
  attention_bwd_dq_kernel<T>
      <<<dim3((n + BQ - 1) / BQ, heads, b), kThreads, dq_smem, st>>>(
          qkv, mask, w.dattn, attnout, sm, dqkv, w.delta, n, heads, scale,
          causal, maybe_dead);
  XCLIP_CHECK_LAUNCH();
  attention_bwd_dkv_kernel<T>
      <<<dim3((n + BK - 1) / BK, heads, b), kThreads, dkv_smem, st>>>(
          qkv, mask, w.dattn, sm, w.delta, dqkv, n, heads, scale, causal,
          maybe_dead);
  XCLIP_CHECK_LAUNCH();
  if ((e = launch_gemm<T, false, true>(dqkv, w_qkv, w.dxn, rows, dim, 3 * hd,
                                       st)))
    return e;
  if ((e = launch_ln_bwd_rows<float, T, T, kLnBwd>(
           w.dxn, x, ln_stats, ln_stats + ld, g_pre, dout, dx, w.part_pre,
           rows, dim, st, w.xn)))
    return e;
  if ((e = launch_emit_sum<T>(w.part_pre, dg_pre, nblk, dim, acc, st)))
    return e;
  return launch_weight_grad<T>(w.xn, dqkv, dw_qkv, w.wpart, dim, 3 * hd, rows,
                               st, acc);
}

template <typename T>
int attention_block_bwd(const T* x, const T* g_pre, const T* w_qkv,
                        const T* w_out, const T* g_out, const uint8_t* mask,
                        const T* dout, const T* qkv, const T* attnout,
                        const T* proj_s, const float* sm,
                        const float* ln_stats, T* dx, T* dqkv, T* dw_qkv,
                        T* dw_out, T* dg_pre, T* dg_out, void* workspace,
                        int b, int n, int dim, int heads, float scale,
                        int causal, int maybe_dead, cudaStream_t st) {
  xclip::Workspace ws(workspace);
  MegaBwdBuffers<T> w(ws, b, n, dim, heads);
  return attention_block_bwd_core<T, T>(
      x, g_pre, w_qkv, w_out, g_out, mask, dout, qkv, attnout, proj_s, sm,
      ln_stats, (long)b * n, dx, dqkv, dw_qkv, dw_out, dg_pre, dg_out, w, b,
      n, dim, heads, scale, causal, maybe_dead, 0, st);
}

// ------------------------------------------------ K3 recompute backward
//
// In place of `_bwd_kernel` (recompute) and `_bwd_kernel_qkv` (qkv kept).
// One call handles one chunk of batch elements; the wrapper walks the
// batch in chunks whose transients stay under its bound and sums the
// chunks' dW and dg in chunk order (`acc` 1 for the first chunk, 2 after),
// as the Pallas grid accumulates them over batch elements. Per chunk:
//   1. ln_rows: xn = T(LN_gpre(x)); 2. mm: qkv = T(xn · w_qkv) — skipped
//      when the forward kept qkv (then xn for dW_qkv comes from the stored
//      statistics in the pre-LN backward rows, `_bwd_kernel_qkv`:628-630);
//   3. attention: attnout in T (p from the kernel's own m and l, which are
//      the stored ones: the same launch on the same qkv);
//   4. mm: proj = attnout · w_out in fp32, NOT rounded (`_bwd_kernel`
//      :512-518, unlike K2, which reads the rounded stored proj);
//   then K2's backward launches (attention_block_bwd_core) with the fp32
//   proj: xhat_o = (proj - mean_o) * inv_o, dproj rounded, delta from the
//   fp32 dattn, p rebuilt from the stored m and l, ds zeroed on dead rows
//   then rounded, dqkv rounded once; dW and dg in fp32 across the batch.
// The recompute launches are the forward's own, on the same inputs, so
// qkv, attnout and proj are bit for bit what the forward computed.
//
// What bounds it on the card: K2's backward plus the forward's qkv, p·v
// and projection products again; transients of one chunk cross HBM (xn,
// qkv, attnout, the fp32 proj, dqkv and K2's workspace, ~16 KB per row at
// dim 512).
template <typename T>
struct RecomputeBuffers {
  T* xn;
  T* qkv;
  T* attnout;
  float* proj;
  T* dqkv;
  RecomputeBuffers(xclip::Workspace& ws, int b, int n, int dim, int heads,
                   bool keep_qkv) {
    const size_t rows = (size_t)b * n, hd = (size_t)heads * DH;
    xn = keep_qkv ? nullptr : ws.take<T>(rows * dim);
    qkv = keep_qkv ? nullptr : ws.take<T>(rows * 3 * hd);
    attnout = ws.take<T>(rows * hd);
    proj = ws.take<float>(rows * dim);
    dqkv = ws.take<T>(rows * 3 * hd);
  }
};

template <typename T>
int attention_block_bwd_recompute(
    const T* x, const T* g_pre, const T* w_qkv, const T* w_out,
    const T* g_out, const uint8_t* mask, const T* dout, const T* kept_qkv,
    const float* sm, const float* ln_stats, long stats_ld, T* dx,
    float* dw_qkv, float* dw_out, float* dg_pre, float* dg_out,
    void* workspace, int b, int n, int dim, int heads, float scale,
    int causal, int maybe_dead, float eps, int acc, cudaStream_t st) {
  using namespace xclip;
  const int rows = b * n, hd = heads * DH;
  Workspace ws(workspace);
  RecomputeBuffers<T> r(ws, b, n, dim, heads, kept_qkv != nullptr);
  MegaBwdBuffers<T> w(ws, b, n, dim, heads);
  const T* qkv = kept_qkv;
  int e;
  if (!qkv) {
    if ((e = launch_ln_rows<T, T>(x, g_pre, nullptr, r.xn, rows, dim, eps,
                                  st)))
      return e;
    if ((e = launch_mm<T, kStore>(r.xn, w_qkv, nullptr, r.qkv, rows, 3 * hd,
                                  dim, st)))
      return e;
    qkv = r.qkv;
  }
  if ((e = launch_attention<T>(qkv, mask, r.attnout, b, n, heads, scale,
                               causal, maybe_dead, nullptr, st)))
    return e;
  if ((e = launch_mm<T, kStoreF32>(r.attnout, w_out, nullptr, r.proj, rows,
                                   dim, hd, st)))
    return e;
  return attention_block_bwd_core<T, float>(
      x, g_pre, w_qkv, w_out, g_out, mask, dout, qkv, r.attnout, r.proj, sm,
      ln_stats, stats_ld, dx, r.dqkv, dw_qkv, dw_out, dg_pre, dg_out, w, b, n,
      dim, heads, scale, causal, maybe_dead, acc, st);
}

}  // namespace

// Largest sequence length whose attention tile fits one block's shared
// memory (232,448 bytes on sm_90), for dtype code `dtype`.
extern "C" int xclip_attention_block_max_n(int dtype) {
  constexpr size_t kMax = 232448;
  if (dtype == xclip::kF32)
    return (int)((kMax - attention_fma_smem_bytes(0)) / (sizeof(float) * QT));
  int n = KC;
  while (TcLayout(n + KC).bytes <= kMax) n += KC;
  return n;
}

// Largest sequence length the K2 backward takes in `dtype` (its query-tile
// kernel keeps 32 full score rows in shared memory).
extern "C" int xclip_attention_block_bwd_max_n(int dtype) {
  constexpr size_t kMax = 232448;
  const int tsize = dtype == xclip::kF32 ? 4 : 2;
  if (DkvLayout(tsize).bytes > kMax) return 0;
  int n = BK;
  while (DqLayout(n + BK, tsize).bytes <= kMax) n += BK;
  return n;
}

static bool mega_args_ok(int dtype, int b, int n, int dim, int heads) {
  return !(dim % 64 || b < 0 || n < 0 || heads <= 0 ||
           n > xclip_attention_block_max_n(dtype));
}

// Returns a cudaError_t code (0 on success). x/out are (b, n, dim), mask is
// (b, n) uint8 (nonzero = valid key); w_qkv (dim, 3*heads*64), w_out
// (heads*64, dim), gains (dim). Scratch: xn (b*n, dim) and proj (b*n, dim)
// fp32; qkv (b*n, 3hd) and attnout (b*n, hd) of the storage dtype, which
// K2 keeps as residuals (K3 "qkv" keeps qkv). K-MEGA passes null residual
// pointers; K2 passes proj_s (b*n x dim, dtype), sm (b*n x 2*heads, fp32: m
// then l per head) and ln_stats (4 x stats_ld, fp32: mean_pre, inv_pre,
// mean_o, inv_o); K3 passes sm and ln_stats.
extern "C" int xclip_attention_block_fwd(
    int dtype, const void* x, const void* g_pre, const void* w_qkv,
    const void* w_out, const void* g_out, const void* mask, void* out,
    void* xn, void* qkv, void* attnout, void* proj, void* proj_s, void* sm,
    void* ln_stats, long long stats_ld, int b, int n, int dim, int heads,
    float scale, int causal, int maybe_dead, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mega_args_ok(dtype, b, n, dim, heads) ||
      (ln_stats && stats_ld < (long long)b * n))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return 0;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  XCLIP_DISPATCH(dtype, attention_block_fwd<T>(
      XCLIP_PTR(const T*, x), XCLIP_PTR(const T*, g_pre),
      XCLIP_PTR(const T*, w_qkv), XCLIP_PTR(const T*, w_out),
      XCLIP_PTR(const T*, g_out), m, XCLIP_PTR(T*, out), XCLIP_PTR(T*, xn),
      XCLIP_PTR(T*, qkv), XCLIP_PTR(T*, attnout), XCLIP_PTR(float*, proj), b,
      n, dim, heads, scale, causal, maybe_dead, eps, st,
      XCLIP_PTR(T*, proj_s), XCLIP_PTR(float*, sm),
      XCLIP_PTR(float*, ln_stats), (long)stats_ld));
}

// Bytes of the workspace the K2 backward takes.
extern "C" long long xclip_attention_block_bwd_workspace(int dtype, int b,
                                                         int n, int dim,
                                                         int heads) {
  xclip::Workspace ws(nullptr);
  if (dtype == xclip::kBF16) {
    MegaBwdBuffers<__nv_bfloat16> sizes(ws, b, n, dim, heads);
  } else {
    MegaBwdBuffers<float> sizes(ws, b, n, dim, heads);
  }
  return (long long)ws.used;
}

// K2 backward. Inputs as saved by the forward plus dout (b*n x dim);
// outputs dx (b*n x dim), dqkv (b*n x 3*heads*64), dw_qkv, dw_out, dg_pre,
// dg_out, all of the dtype.
extern "C" int xclip_attention_block_bwd(
    int dtype, const void* x, const void* g_pre, const void* w_qkv,
    const void* w_out, const void* g_out, const void* mask, const void* dout,
    const void* qkv, const void* attnout, const void* proj_s, const void* sm,
    const void* ln_stats, void* dx, void* dqkv, void* dw_qkv, void* dw_out,
    void* dg_pre, void* dg_out, void* workspace, int b, int n, int dim,
    int heads, float scale, int causal, int maybe_dead, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mega_args_ok(dtype, b, n, dim, heads) || b == 0 || n == 0 ||
      n > xclip_attention_block_bwd_max_n(dtype))
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  XCLIP_DISPATCH(dtype, attention_block_bwd<T>(
      XCLIP_PTR(const T*, x), XCLIP_PTR(const T*, g_pre),
      XCLIP_PTR(const T*, w_qkv), XCLIP_PTR(const T*, w_out),
      XCLIP_PTR(const T*, g_out), m, XCLIP_PTR(const T*, dout),
      XCLIP_PTR(const T*, qkv), XCLIP_PTR(const T*, attnout),
      XCLIP_PTR(const T*, proj_s), XCLIP_PTR(const float*, sm),
      XCLIP_PTR(const float*, ln_stats), XCLIP_PTR(T*, dx),
      XCLIP_PTR(T*, dqkv), XCLIP_PTR(T*, dw_qkv), XCLIP_PTR(T*, dw_out),
      XCLIP_PTR(T*, dg_pre), XCLIP_PTR(T*, dg_out), workspace, b, n, dim,
      heads, scale, causal, maybe_dead, st));
}

// Bytes of the workspace the K3 recompute backward takes for b elements.
extern "C" long long xclip_attention_block_bwd_recompute_workspace(
    int dtype, int b, int n, int dim, int heads, int keep_qkv) {
  xclip::Workspace ws(nullptr);
  if (dtype == xclip::kBF16) {
    RecomputeBuffers<__nv_bfloat16> r(ws, b, n, dim, heads, keep_qkv);
    MegaBwdBuffers<__nv_bfloat16> w(ws, b, n, dim, heads);
  } else {
    RecomputeBuffers<float> r(ws, b, n, dim, heads, keep_qkv);
    MegaBwdBuffers<float> w(ws, b, n, dim, heads);
  }
  return (long long)ws.used;
}

// The K3 backward of one chunk of b batch elements: x, dout, dx (b*n x
// dim), qkv (b*n x 3*heads*64, the forward's, or null to recompute it) and
// sm (b*n x 2*heads) of the chunk, its columns of the forward's fp32
// ln_stats (4 x stats_ld); dw_qkv, dw_out, dg_pre, dg_out fp32, written
// when acc is 1 and added to when 2.
extern "C" int xclip_attention_block_bwd_recompute(
    int dtype, const void* x, const void* g_pre, const void* w_qkv,
    const void* w_out, const void* g_out, const void* mask, const void* dout,
    const void* qkv, const void* sm, const void* ln_stats,
    long long stats_ld, void* dx, void* dw_qkv, void* dw_out, void* dg_pre,
    void* dg_out, void* workspace, int b, int n, int dim, int heads,
    float scale, int causal, int maybe_dead, float eps, int acc,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mega_args_ok(dtype, b, n, dim, heads) || b == 0 || n == 0 ||
      n > xclip_attention_block_bwd_max_n(dtype) ||
      stats_ld < (long long)b * n || (acc != 1 && acc != 2))
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  XCLIP_DISPATCH(dtype, attention_block_bwd_recompute<T>(
      XCLIP_PTR(const T*, x), XCLIP_PTR(const T*, g_pre),
      XCLIP_PTR(const T*, w_qkv), XCLIP_PTR(const T*, w_out),
      XCLIP_PTR(const T*, g_out), m, XCLIP_PTR(const T*, dout),
      XCLIP_PTR(const T*, qkv), XCLIP_PTR(const float*, sm),
      XCLIP_PTR(const float*, ln_stats), (long)stats_ld, XCLIP_PTR(T*, dx),
      XCLIP_PTR(float*, dw_qkv), XCLIP_PTR(float*, dw_out),
      XCLIP_PTR(float*, dg_pre), XCLIP_PTR(float*, dg_out), workspace, b, n,
      dim, heads, scale, causal, maybe_dead, eps, acc, st));
}
