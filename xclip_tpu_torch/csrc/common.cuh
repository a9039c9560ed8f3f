// Device code shared by the hand-written Hopper kernels of xclip_tpu_torch.
//
//   * dtype helpers: storage is fp32 or bf16; every statistic, softmax and
//     product accumulates in fp32, and a value is rounded to the storage
//     dtype exactly where the JAX kernels cast (`.astype(x.dtype)`).
//   * ln_rows_kernel: gain-only LayerNorm over rows with two-pass fp32
//     statistics (xclip_tpu/kernels/_common.py ln_fp32), optionally followed
//     by a residual add in the storage dtype.
//   * launch_mm: a shared-memory tiled matrix product with fused epilogues.
//     bf16 operands go through the tensor cores (nvcuda::wmma 16x16x16
//     tiles fed by a cp.async ring); fp32 operands through an FMA tiling in
//     full fp32 (no TF32).
//
// Everything sits in an anonymous namespace: each .cu file gets its own
// copies of the template kernels, so linking several of them into one
// shared library cannot merge their launch stubs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace xclip {
namespace {

using bf16 = __nv_bfloat16;

// dtype codes passed by the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

#define XCLIP_CHECK_LAUNCH()                         \
  do {                                               \
    cudaError_t e_ = cudaGetLastError();             \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bfloat16)
}

// v cast to the storage dtype T, held in fp32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------- LayerNorm

constexpr int kLnRowsPerBlock = 4;  // one warp per row

// out[r] = T((in[r] - mean) * rsqrt(var + eps) * g), fp32 statistics; with
// `resid`, out[r] = that value (cast to T) + resid[r], the add in T.
template <typename Tin, typename T>
__global__ void __launch_bounds__(32 * kLnRowsPerBlock)
ln_rows_kernel(const Tin* __restrict__ in, const T* __restrict__ g,
               const T* __restrict__ resid, T* __restrict__ out, int rows,
               int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kLnRowsPerBlock + warp;
  if (row >= rows) return;
  const Tin* x = in + row * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += to_f(x[i]);
  const float mean = warp_sum(s) / (float)d;
  float v = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float c = to_f(x[i]) - mean;
    v += c * c;
  }
  const float inv = rsqrtf(warp_sum(v) / (float)d + eps);
  T* o = out + row * d;
  const T* rr = resid ? resid + row * d : nullptr;
  for (int i = lane; i < d; i += 32) {
    const float y = ((to_f(x[i]) - mean) * inv) * to_f(g[i]);
    o[i] = rr ? from_f<T>(round_to<T>(y) + to_f(rr[i])) : from_f<T>(y);
  }
}

template <typename Tin, typename T>
int launch_ln_rows(const Tin* in, const T* g, const T* resid, T* out,
                   int rows, int d, float eps, cudaStream_t st) {
  const int grid = (rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock;
  ln_rows_kernel<Tin, T><<<grid, 32 * kLnRowsPerBlock, 0, st>>>(
      in, g, resid, out, rows, d, eps);
  XCLIP_CHECK_LAUNCH();
  return 0;
}

// ------------------------------------------------------- matrix product
//
// out (m x n) = epilogue(A (m x k) @ B (k x n)), all row-major and dense,
// k a multiple of 32 and n of 64. Epilogues (acc is the fp32 product):
constexpr int kStore = 0;     // out (T)    = T(acc)
constexpr int kStoreF32 = 1;  // out (fp32) = acc
constexpr int kGeglu = 2;     // out (fp32) = a * gelu(b): B is (k, 2n),
                              //   a from columns [0, n), b from [n, 2n)
constexpr int kResidual = 3;  // out (T)    = T(acc) + resid, added in T

// Writes one tile of `out` from the fp32 tile C (shared, row stride cld).
// C's columns [0, 64) are output columns [c0, c0 + 64) and, when c1 >= 0,
// C's columns [64, 128) are output columns [c1, c1 + 64). For kGeglu, C's
// columns [64, 128) hold the gate b of columns [0, 64) instead.
template <typename T, int EPI, int NT>
__device__ __forceinline__ void store_tile(const float* C, int cld, int bm,
                                           int row0, int m, int n, int c0,
                                           int c1, void* out,
                                           const T* resid) {
  const int width = (EPI == kGeglu || c1 < 0) ? 64 : 128;
  for (int i = threadIdx.x; i < bm * width; i += NT) {
    const int r = i / width, c = i % width;
    if (row0 + r >= m) break;  // rows only grow with i
    const long o = (long)(row0 + r) * n + (c < 64 ? c0 + c : c1 + c - 64);
    const float v = C[r * cld + c];
    if (EPI == kStore) {
      static_cast<T*>(out)[o] = from_f<T>(v);
    } else if (EPI == kStoreF32) {
      static_cast<float*>(out)[o] = v;
    } else if (EPI == kGeglu) {
      const float b = C[r * cld + 64 + c];
      // exact (erf) GELU, as jax.nn.gelu(approximate=False)
      static_cast<float*>(out)[o] =
          v * (0.5f * b * (1.f + erff(b * 0.70710678118654752f)));
    } else {
      static_cast<T*>(out)[o] = from_f<T>(round_to<T>(v) + to_f(resid[o]));
    }
  }
}

// --- bf16: tensor cores. 128x128 block tiles, 8 warps of 32x64 (2x4 wmma
// 16x16x16 accumulators), a 3-stage cp.async ring of 32-deep k slices.
// The tile's 128 columns are two 64-wide panels of B: [c0, c0+64) and
// [c1, c1+64) — for kGeglu the a and b halves of the same output columns.
constexpr int TBM = 128, TBK = 32, TSTAGES = 3, kTcThreads = 256;
constexpr int TLDA = TBK + 8, TLDB = 128 + 8, TCLD = 128 + 4;
constexpr int kTcStageBytes = (TBM * TLDA + TBK * TLDB) * 2;
constexpr int kTcSmemBytes = TSTAGES * kTcStageBytes > TBM * TCLD * 4
                                 ? TSTAGES * kTcStageBytes
                                 : TBM * TCLD * 4;

// 16-byte global → shared copy; zero-fills when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int EPI>
__global__ void __launch_bounds__(kTcThreads)
mm_tc_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
             const bf16* __restrict__ resid, void* __restrict__ out, int m,
             int n, int k) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int row0 = blockIdx.x * TBM;
  int c0, c1, ldb;
  if (EPI == kGeglu) {
    c0 = blockIdx.y * 64;
    c1 = n + c0;
    ldb = 2 * n;
  } else {
    c0 = blockIdx.y * 128;
    c1 = c0 + 64 < n ? c0 + 64 : -1;
    ldb = n;
  }
  auto stage_a = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * kTcStageBytes);
  };
  auto stage_b = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * kTcStageBytes + TBM * TLDA * 2);
  };
  auto load = [&](int s, int k0) {
    bf16* as = stage_a(s);
    bf16* bs = stage_b(s);
    for (int c = threadIdx.x; c < TBM * TBK / 8; c += kTcThreads) {
      const int r = c / (TBK / 8), kk = (c % (TBK / 8)) * 8;
      const bool ok = row0 + r < m;
      cp_async16(as + r * TLDA + kk, A + (long)(ok ? row0 + r : 0) * k + k0 + kk,
                 ok);
    }
    for (int c = threadIdx.x; c < TBK * 128 / 8; c += kTcThreads) {
      const int r = c / 16, cc = (c % 16) * 8;
      const bool ok = cc < 64 || c1 >= 0;
      const int col = !ok ? 0 : cc < 64 ? c0 + cc : c1 + cc - 64;
      cp_async16(bs + r * TLDB + cc, B + (long)(k0 + r) * ldb + col, ok);
    }
  };

  const int warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = k / TBK;
#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < nk) load(s, s * TBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TSTAGES - 2>();  // slice kt has landed
    __syncthreads();               // ... for every thread; slot kt-1 is free
    if (kt + TSTAGES - 1 < nk)
      load((kt + TSTAGES - 1) % TSTAGES, (kt + TSTAGES - 1) * TBK);
    cp_async_commit();
    const bf16* as = stage_a(kt % TSTAGES);
    const bf16* bs = stage_b(kt % TSTAGES);
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wr + 16 * i) * TLDA + kk, TLDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * TLDB + wc + 16 * j, TLDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is dead; its memory becomes the result tile
  float* C = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(C + (wr + 16 * i) * TCLD + wc + 16 * j,
                              acc[i][j], TCLD, wmma::mem_row_major);
  __syncthreads();
  store_tile<bf16, EPI, kTcThreads>(C, TCLD, TBM, row0, m, n, c0, c1, out,
                                    resid);
}

// --- fp32: FMA tiling in full fp32 (no TF32). 64x64 block tiles, each
// thread an 8x4 block, 16-deep k slices staged synchronously.
constexpr int kThreads = 128;  // also the attention kernels' block size
constexpr int FBM = 64, FBK = 16, FLDA = FBK + 4, FLDB = 64 + 4,
              FCLD = 128 + 4;

struct FmaSmem {
  __align__(16) float a[FBM][FLDA];
  __align__(16) float b[FBK][FLDB];
};

// C[:, 0:64] (shared, row stride FCLD) = A[row0:row0+64, :k] @ B[:k, col:col+64]
__device__ void fma_tile(FmaSmem& sm, float* C, const float* A, int m,
                         int row0, const float* B, int ldb, int col, int k) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][4] = {};
  for (int k0 = 0; k0 < k; k0 += FBK) {
    for (int c = threadIdx.x; c < FBM * FBK / 4; c += kThreads) {
      const int r = c / (FBK / 4), kk = (c % (FBK / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < m)
        v = *reinterpret_cast<const float4*>(A + (long)(row0 + r) * k + k0 + kk);
      *reinterpret_cast<float4*>(&sm.a[r][kk]) = v;
    }
    for (int c = threadIdx.x; c < FBK * 64 / 4; c += kThreads) {
      const int r = c / 16, cc = (c % 16) * 4;
      *reinterpret_cast<float4*>(&sm.b[r][cc]) =
          *reinterpret_cast<const float4*>(B + (long)(k0 + r) * ldb + col + cc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sm.a[ty * 8 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.b[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) C[(ty * 8 + i) * FCLD + tx * 4 + j] = acc[i][j];
  __syncthreads();
}

template <int EPI>
__global__ void __launch_bounds__(kThreads)
mm_fma_kernel(const float* __restrict__ A, const float* __restrict__ B,
              const float* __restrict__ resid, void* __restrict__ out, int m,
              int n, int k) {
  __shared__ FmaSmem sm;
  __shared__ __align__(16) float C[FBM * FCLD];
  const int row0 = blockIdx.x * FBM, c0 = blockIdx.y * 64;
  const int ldb = EPI == kGeglu ? 2 * n : n;
  fma_tile(sm, C, A, m, row0, B, ldb, c0, k);
  if (EPI == kGeglu) fma_tile(sm, C + 64, A, m, row0, B, ldb, n + c0, k);
  store_tile<float, EPI, kThreads>(C, FCLD, FBM, row0, m, n, c0, -1, out,
                                   resid);
}

template <typename T, int EPI>
int launch_mm(const T* A, const T* B, const T* resid, void* out, int m, int n,
              int k, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    cudaError_t e = cudaFuncSetAttribute(
        mm_tc_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTcSmemBytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((m + TBM - 1) / TBM,
                    EPI == kGeglu ? n / 64 : (n + 127) / 128);
    mm_tc_kernel<EPI><<<grid, kTcThreads, kTcSmemBytes, st>>>(A, B, resid,
                                                             out, m, n, k);
  } else {
    const dim3 grid((m + FBM - 1) / FBM, n / 64);
    mm_fma_kernel<EPI><<<grid, kThreads, 0, st>>>(A, B, resid, out, m, n, k);
  }
  XCLIP_CHECK_LAUNCH();
  return 0;
}

}  // namespace
}  // namespace xclip
