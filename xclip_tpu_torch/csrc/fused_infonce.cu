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
// Forward: a block of 256 threads owns 16 rows and walks the columns in
// tiles of 32. Each tile's 16 x 32 scores come from both sides staged in
// 32-deep k-slices in shared memory, each score a sequential fp32 sum over
// k, folded into a running max and normaliser per row (the online softmax
// of `_lse_kernel`, one warp per two rows, one lane per column); the
// slices walk any d. It feeds its FMAs from shared memory, two loads per
// FMA, and runs well short of its bound.
//
// Backward: three register-tiled fp32 products per chunk of columns,
//     P  = exp(x . y[chunk]^T - lse)  (0 where masked)   R x cc, once,
//     dx (+)= P . y[chunk],   dy[chunk] = P^T . (dlse x),
// so each score is computed once for both gradients. P lives in a scratch
// of at most R x cc fp32 (the wrapper's plan: a chunk of columns whose P
// stays under 64 MiB, all C at once at the b = 2048 step's 2048 x 2048),
// never the whole (R, C) matrix. Each product is one kernel
// (k5_gemm_kernel): 128 x 128 output tiles, 256 threads each holding an
// 8 x 8 micro-tile of accumulators in registers, fed from shared memory by
// 16-byte loads (4 operand loads per 64 FMAs); operands are staged in
// 8-deep k-slices through registers into a double-buffered shared ring, the
// next slice's global loads issued before this slice's FMAs, one barrier a
// slice. dx's and dy's products split their long reduction (the chunk's
// columns, the rows) into ranges of a fixed length, so that enough blocks
// fill 132 SMs at R = C = 2048 (4 ranges: 256 blocks of two an SM); each
// range writes an fp32 partial, and k5_sum_kernel adds the partials in
// range order, then (dx, after the last chunk) scales by dlse. No float
// atomics: two runs agree bit for bit. d is any width (k-slices and output
// tiles masked).
//
// What bounds it on the card: the products, 2 R C d FLOPs for the scores
// and as many again for each backward product (6 R C d in all), on the fp32
// FMA units (no tensor cores in full fp32); the inputs, (R + C) d fp32, are
// read from HBM once and then from L2, as are P and the partials.
#include "common.cuh"

namespace {

using xclip::warp_max;
using xclip::warp_sum;

constexpr int kT = 256;     // threads per block of the forward
constexpr int OWN = 16;     // rows per block of the forward
constexpr int OTHER = 32;   // columns per tile
constexpr int KS = 32;      // k-slice depth of the score tiles
constexpr int SLD = KS + 1;     // row stride of the staged k-slices
constexpr int PLD = OTHER + 1;  // row stride of the score tile

struct Lse5Layout {
  float* own;   // OWN x SLD
  float* oth;   // OTHER x SLD
  float* s;     // OWN x PLD: scores
  __device__ explicit Lse5Layout(float* base) {
    own = base;
    oth = own + OWN * SLD;
    s = oth + OTHER * SLD;
  }
};

constexpr size_t kLse5Smem = (OWN * SLD + OTHER * SLD + OWN * PLD) *
                             sizeof(float);

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
  const Lse5Layout L(smem5);
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

// ---------------------------------------------------------------- backward

constexpr int GBM = 128;     // output rows of a product tile
constexpr int GBN = 128;     // output columns of a product tile
constexpr int GBK = 8;       // k-slice depth (a multiple of 8)
constexpr int KP = GBK / 8;  // loads a thread issues per operand, 4 each
constexpr int GT = 256;      // threads of a product block
constexpr int GLD = GBM + 4;  // row stride of a staged k-slice

// The three products of the backward (c0 the chunk's first column, cc its
// columns; P the chunk's R x cc scores, row stride cc):
constexpr int kScores = 0;  // P[r, j] = exp(x[r] . y[c0 + j] - lse[r]), 0
                            //   where masked: M = R, N = cc, K = d
constexpr int kDx = 1;      // part[z] = P[:, Kz] . y[c0 + Kz]: M = R, N = d,
                            //   K = cc
constexpr int kDy = 2;      // part[z] = P[Kz, :]^T . (dlse x)[Kz]: M = cc,
                            //   N = d, K = R
// (Kz the z-th range of k_split along K.)

// r[q] = p[q] for q < n (n clamped to 0..4), 0 after: one 16-byte load
// when all four are in range and vec (p then 16-byte aligned).
__device__ __forceinline__ void load4(float (&r)[4], const float* p, int n,
                                      bool vec) {
  if (vec && n >= 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) r[q] = q < n ? p[q] : 0.f;
  }
}

// One 128 x 128 output tile of a product over the k-range blockIdx.z.
// Thread (tx, ty) = (t % 16, t / 16) accumulates rows {4 ty + i, 64 + 4 ty
// + i} x columns {4 tx + j, 64 + 4 tx + j}, i, j < 4, in registers; each
// slice's operands are stored k-major in shared memory (As[k][m],
// Bs[k][n]), so a thread reads its 8 + 8 operands as four 16-byte words.
template <int MODE>
__global__ void __launch_bounds__(GT, 2)
k5_gemm_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ lse, const float* __restrict__ dlse,
               float* __restrict__ P, float* __restrict__ out, int R, int d,
               int c0, int cc, int k_split, int off, int decoupled,
               bool vec_a, bool vec_b) {
  __shared__ __align__(16) float As[2][GBK][GLD];
  __shared__ __align__(16) float Bs[2][GBK][GLD];
  const int M = MODE == kDy ? cc : R;
  const int N = MODE == kScores ? cc : d;
  const int K = MODE == kScores ? d : MODE == kDx ? cc : R;
  const int m0 = blockIdx.x * GBM, n0 = blockIdx.y * GBN;
  const int kb = blockIdx.z * k_split;
  const int ke = K < kb + k_split ? K : kb + k_split;
  const int t = threadIdx.x;
  float ra[KP][4], rb[KP][4];
  // the operands of slice [k0, k0 + GBK) into ra, rb (zero outside), 8
  // deep a pass, 4 consecutive values a thread (one 16-byte load where
  // the operand's rows allow it: vec_a, vec_b)
  auto load = [&](int k0) {
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      const int kp = k0 + 8 * p;
      if constexpr (MODE == kDy) {  // A = P^T: P[kk, i], i consecutive
        const int kk = kp + (t >> 5), i = m0 + (t & 31) * 4;
        load4(ra[p], P + (long)kk * cc + i, kk < ke ? M - i : 0, vec_a);
      } else {  // A = x (row stride d) or P (row stride cc): k consecutive
        const float* A = MODE == kScores ? x : P;
        const long lda = MODE == kScores ? d : cc;
        const int i = m0 + (t >> 1), kk = kp + (t & 1) * 4;
        load4(ra[p], A + i * lda + kk, i < M ? ke - kk : 0, vec_a);
      }
      if constexpr (MODE == kScores) {  // B = y[c0 + j]^T: k consecutive
        const int j = n0 + (t >> 1), kk = kp + (t & 1) * 4;
        load4(rb[p], y + (long)(c0 + j) * d + kk, j < N ? ke - kk : 0,
              vec_b);
      } else {  // B = y[c0 + kk] or dlse[kk] x[kk]: columns consecutive
        const int kk = kp + (t >> 5), j = n0 + (t & 31) * 4;
        const bool kok = kk < ke;
        const long row = MODE == kDx ? (long)c0 + kk : (long)kk;
        load4(rb[p], (MODE == kDx ? y : x) + (kok ? row * d : 0) + j,
              kok ? N - j : 0, vec_b);
        if (MODE == kDy && kok) {
          const float sc = dlse[kk];
#pragma unroll
          for (int q = 0; q < 4; ++q) rb[p][q] *= sc;
        }
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      if constexpr (MODE == kDy) {
        *reinterpret_cast<float4*>(&As[buf][8 * p + (t >> 5)][(t & 31) * 4]) =
            make_float4(ra[p][0], ra[p][1], ra[p][2], ra[p][3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          As[buf][8 * p + (t & 1) * 4 + q][t >> 1] = ra[p][q];
      }
      if constexpr (MODE == kScores) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          Bs[buf][8 * p + (t & 1) * 4 + q][t >> 1] = rb[p][q];
      } else {
        *reinterpret_cast<float4*>(&Bs[buf][8 * p + (t >> 5)][(t & 31) * 4]) =
            make_float4(rb[p][0], rb[p][1], rb[p][2], rb[p][3]);
      }
    }
  };
  const int tx = t & 15, ty = t >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int slices = ke > kb ? (ke - kb + GBK - 1) / GBK : 0;
  if (slices > 0) {
    load(kb);
    store(0);
  }
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) load(kb + (s + 1) * GBK);
    const int buf = s & 1;
#pragma unroll
    for (int k = 0; k < GBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < slices) store((s + 1) & 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
    const float l = MODE == kScores ? lse[r] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c >= N) continue;
      if constexpr (MODE == kScores) {
        const bool masked = decoupled && c0 + c == r + off;
        P[(long)r * cc + c] = masked ? 0.f : expf(acc[i][j] - l);
      } else {
        out[(long)blockIdx.z * M * N + (long)r * N + c] = acc[i][j];
      }
    }
  }
}

// out[i] = (accumulate ? out[i] : 0) + sum over z of part[z * n + i], z in
// order 0, 1, ...; then, with `scale`, out[i] *= scale[i / d] (dx's dlse).
__global__ void __launch_bounds__(256)
k5_sum_kernel(const float* __restrict__ part, int parts, long n, int d,
              float* __restrict__ out, const float* __restrict__ scale,
              int accumulate) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = accumulate ? out[i] : 0.f;
  for (int z = 0; z < parts; ++z) s += part[(long)z * n + i];
  out[i] = scale ? s * scale[i / d] : s;
}

template <int MODE>
int launch_k5_gemm(const float* x, const float* y, const float* lse,
                   const float* dlse, float* P, float* out, int R, int d,
                   int c0, int cc, int k_split, int off, int decoupled,
                   cudaStream_t st) {
  const int M = MODE == kDy ? cc : R;
  const int N = MODE == kScores ? cc : d;
  const int K = MODE == kScores ? d : MODE == kDx ? cc : R;
  const dim3 grid((M + GBM - 1) / GBM, (N + GBN - 1) / GBN,
                  (K + k_split - 1) / k_split);
  // 16-byte loads where every 4 values a thread reads start on a 16-byte
  // boundary: x and y rows of d floats, P rows of cc, k-ranges starting
  // at multiples of 4
  const bool vd = d % 4 == 0, vc = cc % 4 == 0;
  k5_gemm_kernel<MODE><<<grid, GT, 0, st>>>(
      x, y, lse, dlse, P, out, R, d, c0, cc, k_split, off, decoupled,
      (MODE == kScores ? vd : vc) && k_split % 4 == 0, vd);
  XCLIP_CHECK_LAUNCH();
  return 0;
}

int launch_k5_sum(const float* part, int parts, long n, int d, float* out,
                  const float* scale, int accumulate, cudaStream_t st) {
  k5_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      part, parts, n, d, out, scale, accumulate);
  XCLIP_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// Returns a cudaError_t code (0 on success). x (R x d), y (C x d) and lse
// (R) are dense fp32 device buffers; R, C, d >= 1.
extern "C" int xclip_lse_fwd(const void* x, const void* y, void* lse, int R,
                             int C, int d, int row_offset, int decoupled,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || C < 1 || d < 1) return (int)cudaErrorInvalidValue;
  lse_fwd_kernel<<<(R + OWN - 1) / OWN, kT, kLse5Smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(lse), R, C, d, row_offset, decoupled);
  XCLIP_CHECK_LAUNCH();
  return 0;
}

// dx (R x d) and dy (C x d) from x, y, the forward's lse and its cotangent
// dlse (R), all fp32, through the plan of kernels/fused_infonce.py
// `bwd_plan`: chunks of cc columns (the last may be shorter); dx's product
// over a chunk in column ranges of kx, dy's over the rows in ranges of ky
// (any lengths; the plan's are multiples of 8). `p` holds R x cc fp32 and
// `part` the larger of
// ceil(cc / kx) R d and ceil(R / ky) cc d fp32.
extern "C" int xclip_lse_bwd(const void* x, const void* y, const void* lse,
                             const void* dlse, void* dx, void* dy, void* p,
                             void* part, int R, int C, int d, int cc, int kx,
                             int ky, int row_offset, int decoupled,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || C < 1 || d < 1 || cc < 1 || cc > C || kx < 1 || ky < 1)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* lf = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(dlse);
  float* P = static_cast<float*>(p);
  float* pt = static_cast<float*>(part);
  float* dxf = static_cast<float*>(dx);
  float* dyf = static_cast<float*>(dy);
  int e;
  for (int c0 = 0; c0 < C; c0 += cc) {
    const int n = C - c0 < cc ? C - c0 : cc;
    const bool last = c0 + n == C;
    if ((e = launch_k5_gemm<kScores>(xf, yf, lf, gf, P, nullptr, R, d, c0, n,
                                     d, row_offset, decoupled, st)))
      return e;
    if ((e = launch_k5_gemm<kDx>(xf, yf, lf, gf, P, pt, R, d, c0, n, kx,
                                 row_offset, decoupled, st)))
      return e;
    if ((e = launch_k5_sum(pt, (n + kx - 1) / kx, (long)R * d, d, dxf,
                           last ? gf : nullptr, c0 > 0, st)))
      return e;
    if ((e = launch_k5_gemm<kDy>(xf, yf, lf, gf, P, pt, R, d, c0, n, ky,
                                 row_offset, decoupled, st)))
      return e;
    if ((e = launch_k5_sum(pt, (R + ky - 1) / ky, (long)n * d, d,
                           dyf + (long)c0 * d, nullptr, 0, st)))
      return e;
  }
  return 0;
}
