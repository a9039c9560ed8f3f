// K7: FlashAttention-2 forward and backward, in place of the Pallas kernels
// of xclip_tpu/kernels/flash_attention.py: the forward `_fwd_kernel`
// (reached through `_flash_forward`) and the backward `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (through `_flash_backward`). The route of
// `attn_impl='flash'`, and the long-sequence one: no score row is ever
// whole, so the length has no limit.
//
// Shapes: q, k, v, out (bh, n, d) of the storage dtype, q pre-scaled (d
// 64; in bf16 also 128, a head of two 64-column halves); the
// key mask (bh, n) uint8 (nonzero = valid), already repeated per head; n a
// multiple of 64 (the wrapper pads, masking the padded keys); lse and
// delta (bh, n) fp32.
//
// Forward, one block per (bh, 64-query tile): a loop over 64-key tiles
// staged in shared memory with the online softmax in fp32, as the Pallas
// kernel's (per row: m_new = max(m, max s), m_safe = 0 where m_new = -inf,
// p = exp(s - m_safe) and 0 on masked entries, correction = 0 where m =
// -inf else exp(m - m_safe), l = l * correction + sum p, acc = acc *
// correction + T(p) . v). At the end l = max(l, 1e-30), out = T(acc / l),
// lse = m_safe + log l: a row with no valid key gives 0 and log 1e-30.
// Causal: key tiles wholly past the query tile are skipped (their p is 0,
// so they would change nothing).
// Backward: p = exp(s - lse), 0 on masked entries; ds = p (dp - delta),
// dp = dO . vᵀ, delta = sum dO * O per row.
//   * dq kernel, one block per (bh, 64-query tile), looping over key
//     tiles: dq = sum T(ds) . k;
//   * dk/dv kernel, one block per (bh, 64-key tile), looping over query
//     tiles: dv = sum T(p)ᵀ . dO, dk = sum T(ds)ᵀ . q.
// Each owns its outputs: no atomics, two runs agree bit for bit.
//
// bf16 runs the kernels of flash_attention_sm90.cuh (register-resident
// mma.sync tiles on a cp.async ring that skip causal and all-masked key
// tiles, delta computed in the dq kernel; their note gives the design and
// what bounds it). fp32 runs the kernels below, on FMAs (common.cuh's
// block_mma), with delta given by PyTorch (as the Pallas wrapper's
// `:186-187`): tiles staged in shared memory by plain loads, the scores
// and the accumulator kept in shared memory between tiles.
#include "flash_attention_sm90.cuh"

namespace {

using xclip::bf16;
using xclip::kThreads;
using xclip::up128;

constexpr int FQ = 64;        // queries per tile
constexpr int FK = 64;        // keys per tile
constexpr int FD = 64;        // head width
constexpr int TLD = FD + 8;   // row stride of staged storage-dtype tiles
constexpr int SLD = FK + 4;   // row stride of fp32 score tiles
constexpr int ALD = FD + 4;   // row stride of fp32 accumulators
static_assert(FQ * 2 == kThreads, "two threads per query row");

// rows x 64 of a contiguous (·, 64) tensor → shared memory, row stride TLD
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int rows) {
  constexpr int V = 16 / sizeof(T);  // values per 16-byte load
  for (int c = threadIdx.x; c < rows * FD / V; c += kThreads) {
    const int r = c / (FD / V), d = (c % (FD / V)) * V;
    *reinterpret_cast<uint4*>(dst + r * TLD + d) =
        *reinterpret_cast<const uint4*>(src + (long)r * FD + d);
  }
}

struct FwdLayout {
  size_t q, k, v, s, p, o, st, bytes;
  __host__ __device__ explicit FwdLayout(int tsize) {
    q = 0;
    k = up128(q + (size_t)tsize * FQ * TLD);
    v = up128(k + (size_t)tsize * FK * TLD);
    s = up128(v + (size_t)tsize * FK * TLD);
    p = up128(s + sizeof(float) * FQ * SLD);
    o = up128(p + (size_t)tsize * FQ * TLD);
    st = up128(o + sizeof(float) * FQ * ALD);
    bytes = up128(st + sizeof(float) * (2 * FQ + FK));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, int n,
                 int causal) {
  using namespace xclip;
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L(sizeof(T));
  T* qs = reinterpret_cast<T*>(smem + L.q);
  T* ks = reinterpret_cast<T*>(smem + L.k);
  T* vs = reinterpret_cast<T*>(smem + L.v);
  float* s = reinterpret_cast<float*>(smem + L.s);
  T* p = reinterpret_cast<T*>(smem + L.p);
  float* o = reinterpret_cast<float*>(smem + L.o);
  float* rm = reinterpret_cast<float*>(smem + L.st);  // running max per row
  float* rl = rm + FQ;                                // running sum per row
  float* kvalid = rl + FQ;                            // the tile's key mask
  const int q0 = blockIdx.y * FQ;
  const long bh = blockIdx.x, base = bh * n;
  const uint8_t* mrow = mask + base;
  // thread t owns row r = t / 2 of the tile, columns [half, half + 32)
  const int r = threadIdx.x >> 1, half = (threadIdx.x & 1) * 32;
  const int qi = q0 + r;

  stage_tile(qs, q + (base + q0) * FD, FQ);
  for (int i = threadIdx.x; i < FQ * FD; i += kThreads)
    o[(i / FD) * ALD + i % FD] = 0.f;
  if (threadIdx.x < FQ) {
    rm[threadIdx.x] = -INFINITY;
    rl[threadIdx.x] = 0.f;
  }
  const int kend = causal ? min(n, q0 + FQ) : n;
  for (int j0 = 0; j0 < kend; j0 += FK) {
    __syncthreads();  // the previous tile's readers are done
    stage_tile(ks, k + (base + j0) * FD, FK);
    stage_tile(vs, v + (base + j0) * FD, FK);
    if (threadIdx.x < FK) kvalid[threadIdx.x] = mrow[j0 + threadIdx.x] != 0;
    __syncthreads();
    block_mma<FQ, FK, false, true>(s, SLD, qs, TLD, ks, TLD, FD, false);
    __syncthreads();
    float* sr = s + r * SLD + half;
    const float m_prev = rm[r], l_prev = rl[r];
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int j = j0 + half + c;
      const bool ok = kvalid[half + c] != 0.f && !(causal && j > qi);
      const float x = ok ? sr[c] : -INFINITY;
      sr[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_prev, mx);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    T* pr = p + r * TLD + half;
    float sum = 0.f;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float e = expf(sr[c] - m_safe);  // exp(-inf) = 0: masked
      pr[c] = from_f<T>(e);
      sum += e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - m_safe);
    float* orow = o + r * ALD + half;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) orow[c] *= corr;
    __syncwarp();  // both threads of the row have read rm, rl
    if (half == 0) {
      rm[r] = m_new;
      rl[r] = l_prev * corr + sum;
    }
    __syncthreads();
    block_mma<FQ, FD, false, false>(o, ALD, p, TLD, vs, TLD, FK, true);
  }
  __syncthreads();
  const float l = fmaxf(rl[r], 1e-30f);
  T* orow_out = out + (base + qi) * FD + half;
  for (int c = 0; c < 32; ++c)
    orow_out[c] = from_f<T>(o[r * ALD + half + c] / l);
  if (half == 0)
    lse[base + qi] = (rm[r] == -INFINITY ? 0.f : rm[r]) + logf(l);
}

// The tiles both backward kernels stage: q, dO (FQ rows), k, v (FK rows),
// the fp32 products s = q . kᵀ and dp = dO . vᵀ (FQ x FK), and per query
// row its lse and delta, per key its mask.
struct BwdLayout {
  size_t q, dO, k, v, s, dp, a, b, acc1, acc2, st, bytes;
  __host__ __device__ BwdLayout(int tsize, bool dkv) {
    q = 0;
    dO = up128(q + (size_t)tsize * FQ * TLD);
    k = up128(dO + (size_t)tsize * FQ * TLD);
    v = up128(k + (size_t)tsize * FK * TLD);
    s = up128(v + (size_t)tsize * FK * TLD);
    dp = up128(s + sizeof(float) * FQ * SLD);
    a = up128(dp + sizeof(float) * FQ * SLD);       // T(ds)
    b = up128(a + (size_t)tsize * FQ * TLD);        // T(p) (dk/dv only)
    acc1 = up128(b + (dkv ? (size_t)tsize * FQ * TLD : 0));
    acc2 = up128(acc1 + sizeof(float) * FQ * ALD);  // (dk/dv only)
    st = up128(acc2 + (dkv ? sizeof(float) * FK * ALD : 0));
    bytes = up128(st + sizeof(float) * (2 * FQ + FK));
  }
};

// p and ds of one (FQ x FK) tile from s, dp, the rows' lse and delta and
// the keys' mask, into T tiles (ds always, p when `pt`).
template <typename T>
__device__ __forceinline__ void tile_p_ds(const float* s, const float* dp,
                                          const float* lse_r,
                                          const float* delta_r,
                                          const float* kvalid, int q0, int j0,
                                          int causal, T* ds, T* pt) {
  using namespace xclip;
  for (int i = threadIdx.x; i < FQ * FK; i += kThreads) {
    const int r = i / FK, c = i % FK;
    const bool ok = kvalid[c] != 0.f && !(causal && j0 + c > q0 + r);
    const float pv = ok ? expf(s[r * SLD + c] - lse_r[r]) : 0.f;
    ds[r * TLD + c] = from_f<T>(pv * (dp[r * SLD + c] - delta_r[r]));
    if (pt) pt[r * TLD + c] = from_f<T>(pv);
  }
}

// dq for one (bh, 64-query tile): dq = sum over key tiles of T(ds) . k.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ mask,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int n, int causal) {
  using namespace xclip;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L(sizeof(T), false);
  T* qs = reinterpret_cast<T*>(smem + L.q);
  T* dos = reinterpret_cast<T*>(smem + L.dO);
  T* ks = reinterpret_cast<T*>(smem + L.k);
  T* vs = reinterpret_cast<T*>(smem + L.v);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* dp = reinterpret_cast<float*>(smem + L.dp);
  T* ds = reinterpret_cast<T*>(smem + L.a);
  float* acc = reinterpret_cast<float*>(smem + L.acc1);
  float* lse_r = reinterpret_cast<float*>(smem + L.st);
  float* delta_r = lse_r + FQ;
  float* kvalid = delta_r + FQ;
  const int q0 = blockIdx.y * FQ;
  const long bh = blockIdx.x, base = bh * n;
  const uint8_t* mrow = mask + base;

  stage_tile(qs, q + (base + q0) * FD, FQ);
  stage_tile(dos, dout + (base + q0) * FD, FQ);
  for (int i = threadIdx.x; i < FQ * FD; i += kThreads)
    acc[(i / FD) * ALD + i % FD] = 0.f;
  if (threadIdx.x < FQ) {
    lse_r[threadIdx.x] = lse[base + q0 + threadIdx.x];
    delta_r[threadIdx.x] = delta[base + q0 + threadIdx.x];
  }
  const int kend = causal ? min(n, q0 + FQ) : n;
  for (int j0 = 0; j0 < kend; j0 += FK) {
    __syncthreads();
    stage_tile(ks, k + (base + j0) * FD, FK);
    stage_tile(vs, v + (base + j0) * FD, FK);
    if (threadIdx.x < FK) kvalid[threadIdx.x] = mrow[j0 + threadIdx.x] != 0;
    __syncthreads();
    block_mma<FQ, FK, false, true>(s, SLD, qs, TLD, ks, TLD, FD, false);
    block_mma<FQ, FK, false, true>(dp, SLD, dos, TLD, vs, TLD, FD, false);
    __syncthreads();
    tile_p_ds<T>(s, dp, lse_r, delta_r, kvalid, q0, j0, causal, ds, nullptr);
    __syncthreads();
    block_mma<FQ, FD, false, false>(acc, ALD, ds, TLD, ks, TLD, FK, true);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < FQ * FD; i += kThreads)
    dq[(base + q0) * FD + i] = from_f<T>(acc[(i / FD) * ALD + i % FD]);
}

// dk, dv for one (bh, 64-key tile): sums over query tiles of T(ds)ᵀ . q and
// T(p)ᵀ . dO.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ mask,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int n, int causal) {
  using namespace xclip;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L(sizeof(T), true);
  T* qs = reinterpret_cast<T*>(smem + L.q);
  T* dos = reinterpret_cast<T*>(smem + L.dO);
  T* ks = reinterpret_cast<T*>(smem + L.k);
  T* vs = reinterpret_cast<T*>(smem + L.v);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* dp = reinterpret_cast<float*>(smem + L.dp);
  T* ds = reinterpret_cast<T*>(smem + L.a);
  T* pt = reinterpret_cast<T*>(smem + L.b);
  float* dka = reinterpret_cast<float*>(smem + L.acc1);
  float* dva = reinterpret_cast<float*>(smem + L.acc2);
  float* lse_r = reinterpret_cast<float*>(smem + L.st);
  float* delta_r = lse_r + FQ;
  float* kvalid = delta_r + FQ;
  const int j0 = blockIdx.y * FK;
  const long bh = blockIdx.x, base = bh * n;

  stage_tile(ks, k + (base + j0) * FD, FK);
  stage_tile(vs, v + (base + j0) * FD, FK);
  for (int i = threadIdx.x; i < FK * FD; i += kThreads) {
    dka[(i / FD) * ALD + i % FD] = 0.f;
    dva[(i / FD) * ALD + i % FD] = 0.f;
  }
  if (threadIdx.x < FK) kvalid[threadIdx.x] = mask[base + j0 + threadIdx.x] != 0;
  // causal: query tiles wholly before the key tile see none of its keys
  for (int q0 = causal ? j0 / FQ * FQ : 0; q0 < n; q0 += FQ) {
    __syncthreads();
    stage_tile(qs, q + (base + q0) * FD, FQ);
    stage_tile(dos, dout + (base + q0) * FD, FQ);
    if (threadIdx.x < FQ) {
      lse_r[threadIdx.x] = lse[base + q0 + threadIdx.x];
      delta_r[threadIdx.x] = delta[base + q0 + threadIdx.x];
    }
    __syncthreads();
    block_mma<FQ, FK, false, true>(s, SLD, qs, TLD, ks, TLD, FD, false);
    block_mma<FQ, FK, false, true>(dp, SLD, dos, TLD, vs, TLD, FD, false);
    __syncthreads();
    tile_p_ds<T>(s, dp, lse_r, delta_r, kvalid, q0, j0, causal, ds, pt);
    __syncthreads();
    block_mma<FK, FD, true, false>(dva, ALD, pt, TLD, dos, TLD, FQ, true);
    block_mma<FK, FD, true, false>(dka, ALD, ds, TLD, qs, TLD, FQ, true);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < FK * FD; i += kThreads) {
    const long o = (base + j0) * FD + i;
    dk[o] = from_f<T>(dka[(i / FD) * ALD + i % FD]);
    dv[o] = from_f<T>(dva[(i / FD) * ALD + i % FD]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int flash_fwd(const T* q, const T* k, const T* v, const uint8_t* mask,
              T* out, float* lse, int bh, int n, int causal, cudaStream_t st) {
  const size_t smem = FwdLayout(sizeof(T)).bytes;
  cudaError_t e = allow_smem(flash_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_kernel<T><<<dim3(bh, n / FQ), kThreads, smem, st>>>(
      q, k, v, mask, out, lse, n, causal);
  XCLIP_CHECK_LAUNCH();
  return 0;
}

template <typename T>
int flash_bwd(const T* q, const T* k, const T* v, const uint8_t* mask,
              const T* dout, const float* lse, const float* delta, T* dq,
              T* dk, T* dv, int bh, int n, int causal, cudaStream_t st) {
  const size_t dq_smem = BwdLayout(sizeof(T), false).bytes;
  const size_t dkv_smem = BwdLayout(sizeof(T), true).bytes;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T>, dq_smem);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dkv_kernel<T>, dkv_smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T><<<dim3(bh, n / FQ), kThreads, dq_smem, st>>>(
      q, k, v, mask, dout, lse, delta, dq, n, causal);
  XCLIP_CHECK_LAUNCH();
  flash_bwd_dkv_kernel<T><<<dim3(bh, n / FK), kThreads, dkv_smem, st>>>(
      q, k, v, mask, dout, lse, delta, dk, dv, n, causal);
  XCLIP_CHECK_LAUNCH();
  return 0;
}

}  // namespace

static bool flash_args_ok(int bh, int n) {
  // b·h on the grid's x axis, the tiles on y (at most 65,535 of them)
  return bh > 0 && n > 0 && n % FQ == 0 && n % FK == 0 &&
         n / FQ <= 65535;
}

// Returns a cudaError_t code (0 on success). q (pre-scaled), k, v, out
// (bh, n, d) of the storage dtype, d 64 (fp32) or 64 or 128 (bf16); mask
// (bh, n) uint8; lse (bh, n) fp32.
extern "C" int xclip_flash_fwd(int dtype, const void* q, const void* k,
                               const void* v, const void* mask, void* out,
                               void* lse, int bh, int n, int d, int causal,
                               void* stream) {
  if (!flash_args_ok(bh, n) || (dtype == xclip::kF32 && d != FD))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == xclip::kBF16)
    return xclip::launch_k7_fwd(
        XCLIP_PTR(const bf16*, q), XCLIP_PTR(const bf16*, k),
        XCLIP_PTR(const bf16*, v), m, XCLIP_PTR(bf16*, out),
        XCLIP_PTR(float*, lse), bh, n, d, causal, st);
  if (dtype != xclip::kF32) return (int)cudaErrorInvalidValue;
  return flash_fwd<float>(XCLIP_PTR(const float*, q),
                          XCLIP_PTR(const float*, k),
                          XCLIP_PTR(const float*, v), m,
                          XCLIP_PTR(float*, out), XCLIP_PTR(float*, lse), bh,
                          n, causal, st);
}

// The backward: q, k, v, mask, lse, d as the forward's; out and dout (bh,
// n, d); delta (bh, n) fp32: for bf16 scratch the kernels fill with sum
// dout * out, for fp32 that sum, given; dq, dk, dv (bh, n, d).
extern "C" int xclip_flash_bwd(int dtype, const void* q, const void* k,
                               const void* v, const void* mask,
                               const void* out, const void* dout,
                               const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int bh, int n, int d,
                               int causal, void* stream) {
  if (!flash_args_ok(bh, n) || (dtype == xclip::kF32 && d != FD))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == xclip::kBF16)
    return xclip::launch_k7_bwd(
        XCLIP_PTR(const bf16*, q), XCLIP_PTR(const bf16*, k),
        XCLIP_PTR(const bf16*, v), m, XCLIP_PTR(const bf16*, out),
        XCLIP_PTR(const float*, lse), XCLIP_PTR(const bf16*, dout),
        XCLIP_PTR(bf16*, dq), XCLIP_PTR(bf16*, dk), XCLIP_PTR(bf16*, dv),
        XCLIP_PTR(float*, delta), bh, n, d, causal, st);
  if (dtype != xclip::kF32) return (int)cudaErrorInvalidValue;
  return flash_bwd<float>(
      XCLIP_PTR(const float*, q), XCLIP_PTR(const float*, k),
      XCLIP_PTR(const float*, v), m, XCLIP_PTR(const float*, dout),
      XCLIP_PTR(const float*, lse), XCLIP_PTR(const float*, delta),
      XCLIP_PTR(float*, dq), XCLIP_PTR(float*, dk), XCLIP_PTR(float*, dv), bh,
      n, causal, st);
}
