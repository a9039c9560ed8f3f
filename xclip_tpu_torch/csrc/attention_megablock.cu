// K-MEGA: the whole attention block forward,
//     out = x + LN_gout(attention(LN_gpre(x) @ w_qkv) @ w_out),
// in place of the Pallas kernel `_fwd_kernel` (with `_fwd_common`) of
// xclip_tpu/kernels/attention_megablock.py, reached through `_mega_fwd`
// with need_residuals=False (the inference forward of `attention_block`).
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

// --- fp32: FMAs from shared memory

size_t attention_fma_smem_bytes(int n) {
  return sizeof(float) * ((size_t)QT * n + QT * ALD + KC * ALD);
}

template <typename T>
__global__ void __launch_bounds__(xclip::kThreads)
attention_fma_kernel(const T* __restrict__ qkv,
                     const uint8_t* __restrict__ mask, T* __restrict__ attnout,
                     int n, int heads, float scale, int causal,
                     int maybe_dead) {
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
                    float scale, int causal, int maybe_dead) {
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
                     cudaStream_t st) {
  const dim3 grid((n + QT - 1) / QT, heads, b);
  cudaError_t e;
  if constexpr (std::is_same<T, xclip::bf16>::value) {
    const size_t smem = TcLayout(n).bytes;
    e = cudaFuncSetAttribute(attention_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    attention_tc_kernel<<<grid, xclip::kThreads, smem, st>>>(
        qkv, mask, attnout, n, heads, scale, causal, maybe_dead);
  } else {
    const size_t smem = attention_fma_smem_bytes(n);
    e = cudaFuncSetAttribute(attention_fma_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    attention_fma_kernel<T><<<grid, xclip::kThreads, smem, st>>>(
        qkv, mask, attnout, n, heads, scale, causal, maybe_dead);
  }
  XCLIP_CHECK_LAUNCH();
  return 0;
}

template <typename T>
int attention_block_fwd(const T* x, const T* g_pre, const T* w_qkv,
                        const T* w_out, const T* g_out, const uint8_t* mask,
                        T* out, T* xn, T* qkv, T* attnout, float* proj, int b,
                        int n, int dim, int heads, float scale, int causal,
                        int maybe_dead, float eps, cudaStream_t st) {
  using namespace xclip;
  const int rows = b * n, hd = heads * DH;
  int e;
  if ((e = launch_ln_rows<T, T>(x, g_pre, nullptr, xn, rows, dim, eps, st)))
    return e;
  if ((e = launch_mm<T, kStore>(xn, w_qkv, nullptr, qkv, rows, 3 * hd, dim, st)))
    return e;
  if ((e = launch_attention<T>(qkv, mask, attnout, b, n, heads, scale, causal,
                               maybe_dead, st)))
    return e;
  if ((e = launch_mm<T, kStoreF32>(attnout, w_out, nullptr, proj, rows, dim,
                                   hd, st)))
    return e;
  return launch_ln_rows<float, T>(proj, g_out, x, out, rows, dim, eps, st);
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

// Returns a cudaError_t code (0 on success). x/out are (b, n, dim), mask is
// (b, n) uint8 (nonzero = valid key); w_qkv (dim, 3*heads*64), w_out
// (heads*64, dim), gains (dim). Scratch: xn (b*n, dim) and qkv (b*n, 3hd)
// and attnout (b*n, hd) of the storage dtype, proj (b*n, dim) fp32.
extern "C" int xclip_attention_block_fwd(
    int dtype, const void* x, const void* g_pre, const void* w_qkv,
    const void* w_out, const void* g_out, const void* mask, void* out,
    void* xn, void* qkv, void* attnout, void* proj, int b, int n, int dim,
    int heads, float scale, int causal, int maybe_dead, float eps,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim % 64 || b < 0 || n < 0 || heads <= 0 ||
      n > xclip_attention_block_max_n(dtype))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return 0;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == xclip::kBF16) {
    using T = __nv_bfloat16;
    return attention_block_fwd<T>(
        static_cast<const T*>(x), static_cast<const T*>(g_pre),
        static_cast<const T*>(w_qkv), static_cast<const T*>(w_out),
        static_cast<const T*>(g_out), m, static_cast<T*>(out),
        static_cast<T*>(xn), static_cast<T*>(qkv), static_cast<T*>(attnout),
        static_cast<float*>(proj), b, n, dim, heads, scale, causal,
        maybe_dead, eps, st);
  }
  if (dtype == xclip::kF32) {
    using T = float;
    return attention_block_fwd<T>(
        static_cast<const T*>(x), static_cast<const T*>(g_pre),
        static_cast<const T*>(w_qkv), static_cast<const T*>(w_out),
        static_cast<const T*>(g_out), m, static_cast<T*>(out),
        static_cast<T*>(xn), static_cast<T*>(qkv), static_cast<T*>(attnout),
        static_cast<float*>(proj), b, n, dim, heads, scale, causal,
        maybe_dead, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}
