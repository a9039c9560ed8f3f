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
// Forward: the scores on the backward's register-tiled product
// (k5_gemm_kernel, below) in its kLse mode: a block owns a 128-row tile and
// a fixed range of whole 128-column tiles (kernels/fused_infonce.py
// `fwd_plan`: the fewest ranges whose blocks fill 132 SMs two blocks
// each, 16 x 16 blocks at R = C = 2048) and walks its tiles with the same
// main loop as the backward's scores, so each score is the same sequential
// fp32 sum over k as the backward's p. Its epilogue replaces the exp and
// store by an online softmax: each thread folds its 8 columns of each of
// its 8 rows into a running (m, l) in registers across the range's tiles;
// at the range's end the 16 threads sharing a row merge their (m, l) by
// shuffles and the block writes one (m, l) a row into a scratch (2 x
// ranges x R fp32). lse_merge_kernel then merges the ranges in range
// order, M = max m_z, l = sum_z l_z exp(m_z - M), lse = M + log(max(l,
// 1e-30)). No float atomics: two launches agree bit for bit. The scores
// take four 16-byte shared loads per 64 FMAs, where 32-column tiles fed
// from shared memory would take two 4-byte loads an FMA.
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
// What bounds it on the card: the products, 2 R C d FLOPs for the forward's
// scores and as many again for each backward product (6 R C d in all), on
// the fp32 FMA units (no tensor cores in full fp32); the inputs, (R + C) d
// fp32, are read from HBM once and then from L2, as are P and the
// partials.
#include "common.cuh"

namespace {

// ------------------------------------------------------- the products

constexpr int GBM = 128;     // output rows of a product tile
constexpr int GBN = 128;     // output columns of a product tile
constexpr int GBK = 8;       // k-slice depth (a multiple of 8)
constexpr int KP = GBK / 8;  // loads a thread issues per operand, 4 each
constexpr int GT = 256;      // threads of a product block
constexpr int GLD = GBM + 4;  // row stride of a staged k-slice

// The products (the backward's three: c0 the chunk's first column, cc its
// columns; P the chunk's R x cc scores, row stride cc; and the forward's):
constexpr int kScores = 0;  // P[r, j] = exp(x[r] . y[c0 + j] - lse[r]), 0
                            //   where masked: M = R, N = cc, K = d
constexpr int kDx = 1;      // part[z] = P[:, Kz] . y[c0 + Kz]: M = R, N = d,
                            //   K = cc
constexpr int kDy = 2;      // part[z] = P[Kz, :]^T . (dlse x)[Kz]: M = cc,
                            //   N = d, K = R
constexpr int kLse = 3;     // the forward: (m, l) of exp(x[r] . y[c]) over
                            //   the block's range of columns (span): M =
                            //   R, N = C, K = d
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

// The 128 x 128 output tiles of a product over the k-range blockIdx.z:
// the columns [blockIdx.y * span, + span) a tile at a time (the backward's
// modes: span = GBN, one tile; kLse: its range of columns). Thread (tx, ty)
// = (t % 16, t / 16) accumulates rows {4 ty + i, 64 + 4 ty + i} x columns
// {4 tx + j, 64 + 4 tx + j}, i, j < 4, in registers; each slice's operands
// are stored k-major in shared memory (As[k][m], Bs[k][n]), so a thread
// reads its 8 + 8 operands as four 16-byte words. kLse writes the running
// (m, l) of each row over the range to out[z R + r] and out[(Z + z) R + r]
// (z = blockIdx.y of Z = gridDim.y ranges).
template <int MODE>
__global__ void __launch_bounds__(GT, 2)
k5_gemm_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ lse, const float* __restrict__ dlse,
               float* __restrict__ P, float* __restrict__ out, int R, int d,
               int c0, int cc, int k_split, int span, int off, int decoupled,
               bool vec_a, bool vec_b) {
  constexpr bool kScoresLike = MODE == kScores || MODE == kLse;
  __shared__ __align__(16) float As[2][GBK][GLD];
  __shared__ __align__(16) float Bs[2][GBK][GLD];
  const int M = MODE == kDy ? cc : R;
  const int N = kScoresLike ? cc : d;
  const int K = kScoresLike ? d : MODE == kDx ? cc : R;
  const int m0 = blockIdx.x * GBM;
  // kLse walks the tiles of its range of columns, [nb, ne); every other
  // mode computes one tile (span = GBN)
  const int nb = blockIdx.y * span, ne = N < nb + span ? N : nb + span;
  const int kb = blockIdx.z * k_split;
  const int ke = K < kb + k_split ? K : kb + k_split;
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  // kLse: each of the thread's rows' running max and normaliser over its
  // columns of the tiles walked so far
  float m_run[8], l_run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  // the tile at columns [n0, n0 + GBN): its product, then the epilogue
  auto tile = [&](int n0) {
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
          const float* A = kScoresLike ? x : P;
          const long lda = kScoresLike ? d : cc;
          const int i = m0 + (t >> 1), kk = kp + (t & 1) * 4;
          load4(ra[p], A + i * lda + kk, i < M ? ke - kk : 0, vec_a);
        }
        if constexpr (kScoresLike) {  // B = y[c0 + j]^T: k consecutive
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
        if constexpr (kScoresLike) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            Bs[buf][8 * p + (t & 1) * 4 + q][t >> 1] = rb[p][q];
        } else {
          *reinterpret_cast<float4*>(&Bs[buf][8 * p + (t >> 5)][(t & 31) * 4]) =
              make_float4(rb[p][0], rb[p][1], rb[p][2], rb[p][3]);
        }
      }
    };
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
    if constexpr (MODE == kLse) {
      // fold this tile's scores into the running (m, l) of each row, the
      // thread's 8 columns in order
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
        bool ok[8];
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
          ok[j] = r < R && c < ne && !(decoupled && c == r + off);
          if (ok[j]) mt = fmaxf(mt, acc[i][j]);
        }
        const float mn = fmaxf(m_run[i], mt);
        if (mn != -INFINITY) {  // else no valid column yet: (m, l) stay
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (ok[j]) sum += expf(acc[i][j] - mn);
          l_run[i] = l_run[i] * expf(m_run[i] - mn) + sum;
          m_run[i] = mn;
        }
      }
    } else {
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
  };
  if constexpr (MODE != kLse) {
    tile(blockIdx.y * GBN);
  } else {
    for (int n0 = nb; n0 < ne; n0 += GBN) tile(n0);
    // the 16 threads of a row (lanes tx of one half-warp) merge their (m,
    // l) by a butterfly: each step adds the same two terms in either lane,
    // so every lane ends with the same bits
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float m = m_run[i], l = l_run[i];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m, o);
        const float lo = __shfl_xor_sync(0xffffffffu, l, o);
        const float mm = fmaxf(m, mo);
        if (mm != -INFINITY) {
          l = l * expf(m - mm) + lo * expf(mo - mm);
          m = mm;
        }
      }
      const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (tx == 0 && r < R) {
        out[(long)blockIdx.y * R + r] = m;
        out[(long)(gridDim.y + blockIdx.y) * R + r] = l;
      }
    }
  }
}

// lse[r] from the (m, l) of Z column ranges (k5_gemm_kernel<kLse>'s
// scratch), merged in range order; m = 0 on a row with no valid column
// and the sum clamped at 1e-30 (`_lse_kernel`'s finalize)
__global__ void __launch_bounds__(256)
lse_merge_kernel(const float* __restrict__ ml, float* __restrict__ lse,
                 int R, int Z) {
  const int r = blockIdx.x * 256 + threadIdx.x;
  if (r >= R) return;
  float m = -INFINITY;
  for (int z = 0; z < Z; ++z) m = fmaxf(m, ml[(long)z * R + r]);
  const float ms = m == -INFINITY ? 0.f : m;
  float l = 0.f;
  for (int z = 0; z < Z; ++z) {
    const float mz = ml[(long)z * R + r];
    if (mz != -INFINITY) l += ml[(long)(Z + z) * R + r] * expf(mz - ms);
  }
  lse[r] = ms + logf(fmaxf(l, 1e-30f));
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

// span: the columns of N a block walks (a multiple of GBN)
template <int MODE>
int launch_k5_gemm(const float* x, const float* y, const float* lse,
                   const float* dlse, float* P, float* out, int R, int d,
                   int c0, int cc, int k_split, int off, int decoupled,
                   cudaStream_t st, int span = GBN) {
  constexpr bool kScoresLike = MODE == kScores || MODE == kLse;
  const int M = MODE == kDy ? cc : R;
  const int N = kScoresLike ? cc : d;
  const int K = kScoresLike ? d : MODE == kDx ? cc : R;
  const dim3 grid((M + GBM - 1) / GBM, (N + span - 1) / span,
                  (K + k_split - 1) / k_split);
  // 16-byte loads where every 4 values a thread reads start on a 16-byte
  // boundary: x and y 16-byte aligned with rows of d floats, P with rows
  // of cc, k-ranges starting at multiples of 4
  const bool vd = d % 4 == 0 && xclip::aligned16(x) && xclip::aligned16(y);
  const bool vc = cc % 4 == 0 && xclip::aligned16(P);
  k5_gemm_kernel<MODE><<<grid, GT, 0, st>>>(
      x, y, lse, dlse, P, out, R, d, c0, cc, k_split, span, off, decoupled,
      (kScoresLike ? vd : vc) && k_split % 4 == 0, vd);
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
// (R) are dense fp32 device buffers; R, C, d >= 1. Through the plan of
// kernels/fused_infonce.py `fwd_plan`: ranges of `span` columns (a
// multiple of 128; the last may be shorter), whose (m, l) the scratch `ml`
// holds, 2 x ceil(C / span) x R fp32.
extern "C" int xclip_lse_fwd(const void* x, const void* y, void* lse,
                             void* ml, int R, int C, int d, int span,
                             int row_offset, int decoupled, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || C < 1 || d < 1 || span < 1 || span % GBN)
    return (int)cudaErrorInvalidValue;
  float* mlf = static_cast<float*>(ml);
  int e;
  if ((e = launch_k5_gemm<kLse>(static_cast<const float*>(x),
                                static_cast<const float*>(y), nullptr,
                                nullptr, nullptr, mlf, R, d, 0, C, d,
                                row_offset, decoupled, st, span)))
    return e;
  lse_merge_kernel<<<(R + 255) / 256, 256, 0, st>>>(
      mlf, static_cast<float*>(lse), R, (C + span - 1) / span);
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
