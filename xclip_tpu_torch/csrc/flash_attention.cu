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
// what bounds it). The fp32 backward runs the attention core's tiled FMA
// kernels (attention_core.cuh) in their K7 mode: K6's lse backward with
// scale 1 and no dead-row rule, on the separate (bh, n, 64) tensors, delta
// computed in the dq kernel, causal and all-masked tiles skipped, no length
// limit (that file's note gives the design and what bounds it). The fp32
// forward is the FMA kernel below (common.cuh's block_mma): tiles staged in
// shared memory by plain loads, the scores and the accumulator kept in
// shared memory between tiles.
#include "attention_core.cuh"
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
// n, d); delta (bh, n) fp32 scratch the dq kernel fills with sum dout * out
// for the dk/dv kernel; dq, dk, dv (bh, n, d). fp32: every tensor 16-byte
// aligned, the mask 8-byte aligned.
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
  return launch_fma_bwd<kK7>(
      XCLIP_PTR(const float*, q), XCLIP_PTR(const float*, k),
      XCLIP_PTR(const float*, v), FD, m, XCLIP_PTR(const float*, dout),
      XCLIP_PTR(const float*, out), XCLIP_PTR(const float*, lse),
      XCLIP_PTR(float*, dq), XCLIP_PTR(float*, dk), XCLIP_PTR(float*, dv),
      XCLIP_PTR(float*, delta), bh, n, 1, 1.f, causal, 0, st);
}

// Blocks an SM of the fp32 backward's dq (`which` 0) or dk/dv (1) kernel
// in K7's mode; a negative cudaError_t code on failure.
extern "C" int xclip_flash_bwd_blocks(int which) {
  return attention_bwd_blocks<kK7>(which);
}
