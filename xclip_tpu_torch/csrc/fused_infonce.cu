// K5, the streaming row log-sum-exp of the InfoNCE loss,
//     lse[r] = log sum_c exp(x[r] . y[c])   (with DCL, c == r + row_offset
//                                            is left out of the sum),
// in place of the Pallas kernels of xclip_tpu/kernels/fused_infonce.py: the
// forward `_lse_kernel` (through `_lse_forward`) and the backward
// `_dx_kernel` and `_dy_kernel` (through `_lse_backward`):
//     p[r, c] = exp(x[r] . y[c] - lse[r])  (0 where masked),
//     dx[r] = dlse[r] * sum_c p[r, c] y[c],
//     dy[c] = sum_r p[r, c] (dlse[r] x[r]).
// Everything is fp32 (the wrapper casts the inputs, as `_streaming_lse_fwd`
// does); the products are fp32 FMAs, no TF32. A row whose every column is
// masked gets m = 0, lse = log(1e-30), as `_lse_kernel`'s finalize.
//
// Design: a block of 256 threads owns 16 rows (forward, dx) or 16 columns
// (dy) and walks the other side in tiles of 32. Each tile's 16 x 32 scores
// come from both sides staged in 32-deep k-slices in shared memory, each
// score a sequential fp32 sum over k. The forward folds them into a running
// max and normaliser per row (the online softmax of `_lse_kernel`, one warp
// per two rows, one lane per column). The backward kernels turn them into
// p and add p . y (dx) or p^T . (dlse x) (dy) to an fp32 accumulator of the
// block's 16 rows x d in shared memory, from the other side's 32 rows
// staged whole. dy walks every row tile for its own columns (the
// column-block-major order of `_dy_kernel`), so every output has one
// writer: no float atomics, and two runs agree bit for bit. Rows and
// columns need not be a multiple of any tile; d is at most 1024.
//
// What bounds it on the card: the products, 2 R C d FLOPs for the scores of
// each kernel and as many again for each backward product, on the fp32
// FMA units (no tensor cores in full fp32); the inputs, (R + C) d fp32, are
// read from HBM once and then from L2. This first version feeds its FMAs
// from shared memory, two loads per FMA, and runs well short of that bound.
#include "common.cuh"

namespace {

using xclip::warp_max;
using xclip::warp_sum;

constexpr int kT = 256;     // threads per block
constexpr int OWN = 16;     // rows (forward, dx) or columns (dy) per block
constexpr int OTHER = 32;   // rows of the other side per tile
constexpr int KS = 32;      // k-slice depth of the score tiles
constexpr int SLD = KS + 1;     // row stride of the staged k-slices
constexpr int PLD = OTHER + 1;  // row stride of the score tile

struct Lse5Layout {
  float* own;   // OWN x SLD
  float* oth;   // OTHER x SLD
  float* s;     // OWN x PLD: scores, then p
  float* acc;   // OWN x d (backward)
  float* full;  // OTHER x d (backward): the other side's tile rows
  __device__ Lse5Layout(float* base, int d) {
    own = base;
    oth = own + OWN * SLD;
    s = oth + OTHER * SLD;
    acc = s + OWN * PLD;
    full = acc + (size_t)OWN * d;
  }
};

size_t lse5_smem_bytes(int d, bool backward) {
  size_t floats = OWN * SLD + OTHER * SLD + OWN * PLD;
  if (backward) floats += (size_t)(OWN + OTHER) * d;
  return floats * sizeof(float);
}

// s[i][j] = a[a0 + i] . b[b0 + j] for i < 16, j < 32 (rows at or past na /
// nb read as 0), k in 32-deep slices, each score a sequential fp32 sum.
__device__ void score_tile(const Lse5Layout& L, const float* __restrict__ a,
                           int na, int a0, const float* __restrict__ b,
                           int nb, int b0, int d) {
  const int t = threadIdx.x, i = t / 16, j = t % 16;
  float s0 = 0.f, s1 = 0.f;
  for (int k0 = 0; k0 < d; k0 += KS) {
    for (int e = t; e < OWN * KS; e += kT) {
      const int r = e / KS, k = e % KS;
      L.own[r * SLD + k] = a0 + r < na && k0 + k < d
                               ? a[(long)(a0 + r) * d + k0 + k] : 0.f;
    }
    for (int e = t; e < OTHER * KS; e += kT) {
      const int r = e / KS, k = e % KS;
      L.oth[r * SLD + k] = b0 + r < nb && k0 + k < d
                               ? b[(long)(b0 + r) * d + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KS; ++k) {
      const float av = L.own[i * SLD + k];
      s0 = fmaf(av, L.oth[j * SLD + k], s0);
      s1 = fmaf(av, L.oth[(j + 16) * SLD + k], s1);
    }
    __syncthreads();
  }
  L.s[i * PLD + j] = s0;
  L.s[i * PLD + j + 16] = s1;
  __syncthreads();
}

__device__ __forceinline__ bool lse_valid(int r, int c, int R, int C,
                                          int off, int decoupled) {
  return r < R && c < C && !(decoupled && c == r + off);
}

__global__ void __launch_bounds__(kT)
lse_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
               float* __restrict__ lse, int R, int C, int d, int off,
               int decoupled) {
  extern __shared__ __align__(16) float smem5[];
  const Lse5Layout L(smem5, d);
  const int r0 = blockIdx.x * OWN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int c0 = 0; c0 < C; c0 += OTHER) {
    score_tile(L, x, R, r0, y, C, c0, d);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = 2 * warp + q, r = r0 + i, c = c0 + lane;
      const bool valid = lse_valid(r, c, R, C, off, decoupled);
      const float s = valid ? L.s[i * PLD + lane] : -INFINITY;
      const float m_new = fmaxf(m[q], warp_max(s));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float p = valid ? expf(s - m_safe) : 0.f;
      const float corr = m[q] == -INFINITY ? 0.f : expf(m[q] - m_safe);
      l[q] = l[q] * corr + warp_sum(p);
      m[q] = m_new;
    }
    __syncthreads();  // the next tile overwrites the scores
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = r0 + 2 * warp + q;
    if (lane == 0 && r < R)
      lse[r] = (m[q] == -INFINITY ? 0.f : m[q]) + logf(fmaxf(l[q], 1e-30f));
  }
}

// The backward: DY false gives dx (own = rows of x, other = rows of y),
// DY true gives dy (own = rows of y, other = rows of x).
template <bool DY>
__global__ void __launch_bounds__(kT)
lse_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ lse, const float* __restrict__ dlse,
               float* __restrict__ out, int R, int C, int d, int off,
               int decoupled) {
  extern __shared__ __align__(16) float smem5[];
  const Lse5Layout L(smem5, d);
  const int t = threadIdx.x;
  const int o0 = blockIdx.x * OWN;
  const float* own = DY ? y : x;
  const float* oth = DY ? x : y;
  const int n_own = DY ? C : R, n_oth = DY ? R : C;
  for (int e = t; e < OWN * d; e += kT) L.acc[e] = 0.f;
  for (int t0 = 0; t0 < n_oth; t0 += OTHER) {
    score_tile(L, own, n_own, o0, oth, n_oth, t0, d);
    for (int e = t; e < OTHER * d; e += kT) {  // the other side's rows
      const int j = e / d, k = e % d, row = t0 + j;
      float v = 0.f;
      if (row < n_oth) {
        v = oth[(long)row * d + k];
        if (DY) v *= dlse[row];  // xw = x * dlse, as `_dy_kernel`
      }
      L.full[e] = v;
    }
    for (int e = t; e < OWN * OTHER; e += kT) {
      const int i = e / OTHER, j = e % OTHER;
      const int r = DY ? t0 + j : o0 + i, c = DY ? o0 + i : t0 + j;
      L.s[i * PLD + j] = lse_valid(r, c, R, C, off, decoupled)
                             ? expf(L.s[i * PLD + j] - lse[r]) : 0.f;
    }
    __syncthreads();
    for (int e = t; e < OWN * d; e += kT) {
      const int i = e / d, k = e % d;
      float a = L.acc[e];
#pragma unroll 8
      for (int j = 0; j < OTHER; ++j)
        a = fmaf(L.s[i * PLD + j], L.full[j * d + k], a);
      L.acc[e] = a;
    }
    __syncthreads();  // the next tile overwrites s and full
  }
  for (int e = t; e < OWN * d; e += kT) {
    const int i = e / d, k = e % d, row = o0 + i;
    if (row < n_own)
      out[(long)row * d + k] = DY ? L.acc[e] : L.acc[e] * dlse[row];
  }
}

}  // namespace

// Returns a cudaError_t code (0 on success). x (R x d), y (C x d) and lse
// (R) are dense fp32 device buffers; R, C >= 1, 1 <= d <= 1024.
extern "C" int xclip_lse_fwd(const void* x, const void* y, void* lse, int R,
                             int C, int d, int row_offset, int decoupled,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || C < 1 || d < 1 || d > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = lse5_smem_bytes(d, false);
  cudaError_t e = cudaFuncSetAttribute(
      lse_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  lse_fwd_kernel<<<(R + OWN - 1) / OWN, kT, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(lse), R, C, d, row_offset, decoupled);
  XCLIP_CHECK_LAUNCH();
  return 0;
}

// dx (R x d) and dy (C x d) from x, y, the forward's lse and its cotangent
// dlse (R), all fp32.
extern "C" int xclip_lse_bwd(const void* x, const void* y, const void* lse,
                             const void* dlse, void* dx, void* dy, int R,
                             int C, int d, int row_offset, int decoupled,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || C < 1 || d < 1 || d > 1024) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* lf = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(dlse);
  const size_t smem = lse5_smem_bytes(d, true);
  for (int which = 0; which < 2; ++which) {
    const bool is_dy = which == 1;
    auto kernel = is_dy ? lse_bwd_kernel<true> : lse_bwd_kernel<false>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<((is_dy ? C : R) + OWN - 1) / OWN, kT, smem, st>>>(
        xf, yf, lf, gf, static_cast<float*>(is_dy ? dy : dx), R, C, d,
        row_offset, decoupled);
    XCLIP_CHECK_LAUNCH();
  }
  return 0;
}
