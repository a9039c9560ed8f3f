// The LayerNorm row kernels, forward and backward, and the GEGLU-backward
// row kernel, for Hopper. Included at the end of common.cuh, whose dtype
// helpers and GegluParts they use; each .cu file that includes common.cuh
// gets its own copies of the template kernels, as with common.cuh's own.
//
//   * ln_fwd_rows_kernel: the gain-only LayerNorm over rows with two-pass
//     fp32 statistics (xclip_tpu/nn/core.py layer_norm_apply :91-93,
//     xclip_tpu/kernels/_common.py ln_fp32), every LayerNorm of the FF
//     blocks and the attention megablock (launch_ln_rows); optionally a
//     residual add in the storage dtype, the row's mean and rsqrt(var +
//     eps), the input rounded to the storage dtype (the training forwards'
//     residuals), or a GEGLU prologue that normalises a * gelu(b) of a row
//     [a, b] (K8's forward, xclip_tpu/kernels/fused_ff.py `_fwd_kernel`
//     :68).
//   * ln_bwd_rows_kernel: the gain-only LayerNorm vjp over rows from stored
//     statistics (xclip_tpu/kernels/_common.py ln_bwd :50), the backward of
//     every LayerNorm of the FF blocks and the attention megablock; in its
//     kLnBwdGeglu mode the inner LayerNorm of K1's pass 1 from the stored
//     GEGLU triple (xclip_tpu/kernels/fused_ff_block.py `_p1_geglu_core`
//     :585).
//   * geglu_bwd_rows_kernel: the GEGLU and inner-LayerNorm backward from h
//     rather than from a stored product: the FF block's recompute backward
//     (`_p1_recompute_core` :369), K8's backward
//     (xclip_tpu/kernels/fused_ff.py `_bwd_kernel` :75) and K1-h's pass 1
//     (`_p1_stored_core` :494).
//
// What bounds them on this card: bytes. Each row is read once and its
// outputs written once, a few dozen fp32 operations an element (one erf
// and one exp in the GEGLU modes) against 10-22 bytes an element: the
// recompute mode reads fp32 dy and h and writes bf16 dh and y, 18 bytes a
// column, 36,864 bytes a row at inner width 2048, 0.270 ms for 24,576 rows
// at 3.35 TB/s.
//
// Design. A block takes 64 rows (one dg partial each, kBwdRows) and
// kRowThreads threads (kRowThreadsRecompute in the recompute mode). Each
// thread owns V vectors of 8 consecutive columns (8 bf16 in one 16-byte
// load, 8 fp32 in two) of every row it meets, the same columns in every
// row; ceil(d / 8V) threads cover a row (V the least of 1, 2, 4 that fits
// the block; a row's last vector masked), and a block runs block /
// (d / 8V) rows at once, a group of threads each (the recompute mode's
// 512 threads two rows of inner width 2048, so a row sum's barrier serves
// two rows). A row's inputs are loaded once, as 16-byte vectors, into
// registers; prod, gelu(b) and gelu'(b) (GegluParts) are evaluated once
// an element and kept there; the row sums (m1, m2, and in K8's mode the
// two-pass mean and variance, from the registers) reduce by shuffles
// within a warp, then across the group's warps through a small shared
// array; every output leaves as 16-byte vectors. A width that is not a
// multiple of 8, or a pointer that is not 16-byte aligned, takes the same
// walk with element loads and stores (`vec` false). Bytes in flight: the
// next step's loads are issued before this step's sums are reduced (a
// register double buffer). The dg column partials stay in registers: a
// thread adds dy * xhat of its columns over its rows and writes them once;
// with several row groups the groups' sums are added in group order
// through shared memory. One partial per fixed 64-row block, summed in
// order by launch_reduce_parts: no float atomics, two runs agree bit for
// bit, and the recompute backwards' chunking (at multiples of 64 rows)
// leaves the sums' bits alone.
//
// tools/rows_variants.py times the alternatives, each an edited copy of
// this file: a ring of steps in shared memory fed by bulk copies
// (cp.async.bulk into mbarrier-guarded stages, the copy engine's bytes in
// flight rather than registers; tools/rows_ring.patch), 256 or 512 threads
// in every mode, three blocks an SM. On the H100 each loses or ties
// (PERF.md); K8's mode, three dependent row sums a row, stays furthest from
// its bytes bound.
#pragma once

#include <initializer_list>

namespace xclip {

// Launches of each kernel mode since the library was loaded or last reset
// (xclip_rows_launches, rows.cu): the GEGLU modes at their mode, the
// LayerNorm-backward modes at kGegluModes + theirs, the LayerNorm forward
// modes at kLnFwdCounter + theirs.
constexpr int kGegluModes = 3;
constexpr int kLnFwdCounter = kGegluModes + 2;
constexpr int kLnFwdModes = 5;
constexpr int kRowCounters = kLnFwdCounter + kLnFwdModes;
extern long long g_row_launches[kRowCounters];

namespace {

constexpr int kLnBwd = 0;
constexpr int kLnBwdGeglu = 1;
// the LayerNorm forward's modes, by what a call writes besides out: the
// GEGLU prologue, else a residual add, else the input copy, else the
// statistics, else nothing
constexpr int kLnFwdPlain = 0;
constexpr int kLnFwdStats = 1;
constexpr int kLnFwdResidual = 2;
constexpr int kLnFwdInCopy = 3;
constexpr int kLnFwdGeglu = 4;
constexpr int kGegluRecompute = 0;
constexpr int kGegluLn = 1;
constexpr int kGegluStoredH = 2;

constexpr int kBwdRows = 64;         // rows a block, one dg partial each
constexpr int kRowThreads = 256;     // threads a block
constexpr int kRowThreadsRecompute = 512;  // the recompute mode's
constexpr int kMaxRowWarps = 16;     // warps a block at most
constexpr int kRowMinBlocks = 1;     // blocks an SM the registers must allow
constexpr int kRowMaxWidth = 8192;   // widest row

inline int ln_bwd_blocks(int rows) { return (rows + kBwdRows - 1) / kBwdRows; }

// Vectors of 8 columns a thread holds for rows of width d: the least of 1,
// 2, 4 that leaves at most nt threads a row; 0 for a width the kernels do
// not take (not positive, or above kRowMaxWidth).
inline int row_vectors(int d, int nt) {
  if (d <= 0 || d > kRowMaxWidth) return 0;
  for (int v = 1; v <= 4; v *= 2)
    if ((d + 8 * v - 1) / (8 * v) <= nt) return v;
  return 0;
}

// threads a block of the GEGLU backward rows in MODE
template <int MODE> constexpr int geglu_row_threads() {
  return MODE == kGegluRecompute ? kRowThreadsRecompute : kRowThreads;
}

// Whether rows of width d at these pointers (null ones skipped) take
// 16-byte vectors: d a multiple of 8 and every pointer 16-byte aligned.
inline bool row_vec(int d, std::initializer_list<const void*> ptrs) {
  if (d % 8 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// 8 consecutive values of T as a thread loads them, kept packed until used:
// one 16-byte vector of bf16, two of fp32.
template <typename T> struct Vec8;
template <> struct Vec8<bf16> { uint4 u; };
template <> struct Vec8<float> { float4 lo, hi; };

// p[0..n) (n <= 8) and zeros after: one 16-byte vector (two for fp32)
// when n == 8 and vec (p then 16-byte aligned), else element by element.
template <typename T>
__device__ __forceinline__ Vec8<T> load8(const T* p, int n, bool vec) {
  Vec8<T> v;
  if constexpr (std::is_same<T, bf16>::value) {
    if (vec && n == 8) {
      v.u = *reinterpret_cast<const uint4*>(p);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < n)
          w[e / 2] |= (uint32_t)__bfloat16_as_ushort(p[e]) << (16 * (e & 1));
      v.u = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    if (vec && n == 8) {
      v.lo = reinterpret_cast<const float4*>(p)[0];
      v.hi = reinterpret_cast<const float4*>(p)[1];
    } else {
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = e < n ? p[e] : 0.f;
      v.lo = make_float4(f[0], f[1], f[2], f[3]);
      v.hi = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
  return v;
}

__device__ __forceinline__ void unpack8(const Vec8<bf16>& v, float (&f)[8]) {
  const uint32_t w[4] = {v.u.x, v.u.y, v.u.z, v.u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address in the low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack8(const Vec8<float>& v, float (&f)[8]) {
  f[0] = v.lo.x; f[1] = v.lo.y; f[2] = v.lo.z; f[3] = v.lo.w;
  f[4] = v.hi.x; f[5] = v.hi.y; f[6] = v.hi.z; f[7] = v.hi.w;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(from_f<bf16>(lo)) |
         ((uint32_t)__bfloat16_as_ushort(from_f<bf16>(hi)) << 16);
}

// p[0..n) = T(f[0..n)) (n <= 8): as 16-byte vectors when n == 8 and vec
// (p then 16-byte aligned), else element by element.
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&f)[8], int n,
                                       bool vec) {
  if (vec && n == 8) {
    if constexpr (std::is_same<T, bf16>::value) {
      *reinterpret_cast<uint4*>(p) =
          make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                     pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
    } else {
      reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n) p[e] = from_f<T>(f[e]);
  }
}

// How a block's threads cover rows of d columns, V vectors of 8 a thread:
// G threads hold a row's columns, inside a group of GS threads (a power of
// two up to a warp, else whole warps; the rest hold zeros), and R groups
// take R rows at once. Thread j of group grp holds columns [8 (j + k G),
// +8) for k < V, so each vector k of a warp covers consecutive 16-byte
// words; columns from d on are masked.
struct RowShape {
  int G, GS, R;
  __host__ __device__ __forceinline__ RowShape(int d, int V, int nt) {
    G = (d + 8 * V - 1) / (8 * V);
    GS = 8;
    while (GS < G && GS < 32) GS *= 2;
    if (G > 32) GS = (G + 31) / 32 * 32;
    R = nt / GS;
  }
};

struct RowGroups : RowShape {
  int grp, j, d;
  bool cols;  // this thread holds columns
  __device__ __forceinline__ RowGroups(int width, int V)
      : RowShape(width, V, blockDim.x), d(width) {
    grp = threadIdx.x / GS;
    j = threadIdx.x % GS;
    cols = grp < R && j < G;
  }
  __device__ __forceinline__ int col(int k) const { return 8 * (j + k * G); }
  // the columns of vector k inside the row (0 to 8)
  __device__ __forceinline__ int n(int k) const {
    const int left = d - col(k);
    return !cols || left <= 0 ? 0 : left < 8 ? left : 8;
  }
};

// Shared scratch of the row sums: two turns of one slot per warp and sum.
constexpr int kRedFloats = 2 * kMaxRowWarps * 2;

// v[0..N) (N <= 2) summed over the threads of each row group, in a fixed
// order (a shuffle tree, then the group's warps in order), every thread of
// the group getting the same bits. Every thread of the block calls it;
// `red` (kRedFloats) is used in alternate turns, so one barrier a sum
// suffices: a turn's slots are written again only after every thread has
// passed the next sum's barrier, hence finished reading them.
template <int N>
__device__ __forceinline__ void group_sum(float (&v)[N], const RowGroups& rg,
                                          float* red, int& turn) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < rg.GS)
#pragma unroll
      for (int n = 0; n < N; ++n)
        v[n] += __shfl_xor_sync(0xffffffffu, v[n], o);
  if (rg.GS <= 32) return;
  float* buf = red + turn * kMaxRowWarps * 2;
  turn ^= 1;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int n = 0; n < N; ++n) buf[warp * 2 + n] = v[n];
  __syncthreads();
  if (rg.grp < rg.R) {
    const int w0 = rg.grp * (rg.GS / 32);
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] = 0.f;
    for (int w = 0; w < rg.GS / 32; ++w)
#pragma unroll
      for (int n = 0; n < N; ++n) v[n] += buf[(w0 + w) * 2 + n];
  }
}

// The block's dg partial (its 64 rows' column sums, acc per thread) into
// dg_part row blockIdx.x: straight from the registers with one row group;
// else through shared memory (`part`, 8 floats a thread), the groups
// added in group order.
template <int V>
__device__ __forceinline__ void write_partial(const float (&acc)[V][8],
                                              const RowGroups& rg, float* part,
                                              float* dg_part, int d,
                                              bool vec) {
  float* dst = dg_part + (long)blockIdx.x * d;
  if (rg.R == 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) store8(dst + rg.col(k), acc[k], rg.n(k), vec);
    return;
  }
#pragma unroll
  for (int k = 0; k < V; ++k)
    store8(part + rg.grp * d + rg.col(k), acc[k], rg.n(k), vec);
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = part[c];
    for (int q = 1; q < rg.R; ++q) s += part[q * d + c];
    dst[c] = s;
  }
}

// ------------------------------------------------------ LayerNorm backward
//
// Per row r, from the stored statistics (mean[r], inv[r]) of the forward:
//   xhat = (v - mean) * inv,  dyg = dy * g,
//   val  = inv * (dyg - mean(dyg) - xhat * mean(dyg * xhat))
// and the column sums of dy * xhat (dg) over the block's rows.
//   kLnBwd:      out = T(val + resid) (resid optional); with xn_out also
//                xn_out = T(xhat * g), the pre-LN output the dW products
//                read.
//   kLnBwdGeglu: the inner LayerNorm of the FF block, v = the stored
//                product: out = dprod = T(val); dh = T([val * gb, val *
//                agdb]) (rows x 2d) for the dx product; dh2 = the same from
//                T(val) (the dW pass's operand, skipped when dh2 == dh, as
//                in fp32); y2 = T(xhat * g).
template <typename Tdy, typename Tv, typename T, int MODE, int V, int NT>
__global__ void __launch_bounds__(NT, kRowMinBlocks)
ln_bwd_rows_kernel(const Tdy* __restrict__ dy, const Tv* __restrict__ v,
                   const float* __restrict__ mean,
                   const float* __restrict__ inv, const T* __restrict__ g,
                   const T* __restrict__ resid, T* __restrict__ out,
                   float* __restrict__ dg_part, int rows, int d,
                   T* __restrict__ xn_out, const T* __restrict__ gb,
                   const T* __restrict__ agdb, T* __restrict__ dh,
                   T* __restrict__ dh2, T* __restrict__ y2, bool vec) {
  __shared__ float red[kRedFloats];
  __shared__ __align__(16) float part[NT * 8];
  const RowGroups rg(d, V);
  const long r0 = (long)blockIdx.x * kBwdRows;
  const int steps = (kBwdRows + rg.R - 1) / rg.R;
  // the extra inputs: resid (kLnBwd, optional), or gb and agdb
  const T* e1 = MODE == kLnBwd ? resid : gb;
  const T* e2 = MODE == kLnBwd ? nullptr : agdb;
  float gv[V][8], acc[V][8];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    unpack8(load8(g + rg.col(k), rg.n(k), vec), gv[k]);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[k][e] = 0.f;
  }
  struct Row {  // one row's inputs as loaded
    Vec8<Tdy> dy[V];
    Vec8<Tv> v[V];
    Vec8<T> e1[V], e2[V];
    float mu, iv;
    bool ok;
    long r;
  };
  auto fetch = [&](int s) {
    Row x;
    const int rr = s * rg.R + rg.grp;
    x.r = r0 + rr;
    x.ok = rg.cols && rr < kBwdRows && x.r < rows;
    const long o = x.r * d;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long c = o + rg.col(k);
      const int n = x.ok ? rg.n(k) : 0;
      x.dy[k] = load8(dy + c, n, vec);
      x.v[k] = load8(v + c, n, vec);
      x.e1[k] = load8(e1 + c, e1 ? n : 0, vec);
      if (MODE == kLnBwdGeglu) x.e2[k] = load8(e2 + c, n, vec);
    }
    x.mu = x.ok ? mean[x.r] : 0.f;
    x.iv = x.ok ? inv[x.r] : 0.f;
    return x;
  };
  int turn = 0;
  Row cur = fetch(0), nxt;
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) nxt = fetch(s + 1);
    const long o = cur.r * d;
    float xh[V][8], dyg[V][8], sums[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float dv[8], vv[8];
      unpack8(cur.dy[k], dv);
      unpack8(cur.v[k], vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xh[k][e] = (vv[e] - cur.mu) * cur.iv;
        dyg[k][e] = dv[e] * gv[k][e];
        sums[0] += dyg[k][e];
        sums[1] += dyg[k][e] * xh[k][e];
        acc[k][e] += dv[e] * xh[k][e];
      }
      // the outputs that need no row sum leave first
      T* yn = MODE == kLnBwd ? xn_out : y2;
      if (cur.ok && yn) {
        float t[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) t[e] = xh[k][e] * gv[k][e];
        store8(yn + o + rg.col(k), t, rg.n(k), vec);
      }
    }
    group_sum(sums, rg, red, turn);
    const float m1 = sums[0] / (float)d, m2 = sums[1] / (float)d;
    if (cur.ok) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float val[8], x1[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          val[e] = cur.iv * (dyg[k][e] - m1 - xh[k][e] * m2);
        const int c = rg.col(k), n = rg.n(k);
        if (MODE == kLnBwd) {
          if (e1) {
            unpack8(cur.e1[k], x1);
#pragma unroll
            for (int e = 0; e < 8; ++e) x1[e] += val[e];
            store8(out + o + c, x1, n, vec);
          } else {
            store8(out + o + c, val, n, vec);
          }
        } else {
          float x2[8], da[8], db[8];
          unpack8(cur.e1[k], x1);
          unpack8(cur.e2[k], x2);
          store8(out + o + c, val, n, vec);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            da[e] = val[e] * x1[e];
            db[e] = val[e] * x2[e];
          }
          store8(dh + 2 * o + c, da, n, vec);
          store8(dh + 2 * o + d + c, db, n, vec);
          if (dh2 != dh) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float pr = round_to<T>(val[e]);
              da[e] = pr * x1[e];
              db[e] = pr * x2[e];
            }
            store8(dh2 + 2 * o + c, da, n, vec);
            store8(dh2 + 2 * o + d + c, db, n, vec);
          }
        }
      }
    }
    cur = nxt;
  }
  write_partial<V>(acc, rg, part, dg_part, d, vec);
}

// --------------------------------------------------- GEGLU backward rows
//
// The GEGLU and inner-LayerNorm backward over rows, one kernel for the three
// callers that rebuild the product from h (rows x 2d, a then b; d the inner
// width) rather than read it. Per row r, with dy the cotangent of the LN
// output (rows x d):
//   prod = a * gelu(b) (GegluParts: the forward epilogue's op sequence),
//   xhat = (prod - mean) * inv,
//   dprod = inv * (dy * g - mean(dy * g) - xhat * mean(dy * g * xhat)),
//   dh = T([dprod * gelu(b), dprod * a * gelu'(b)]),
// all fp32 up to the casts, and the column partials of dy * xhat (dg) per
// block, as ln_bwd_rows_kernel. MODE says where mean and inv come from and
// what else is written:
//   kGegluRecompute: the FF block's recompute backward (`_p1_recompute_core`):
//     fp32 h and dy, the forward's stored statistics; also y = T(xhat * g).
//   kGegluLn: K8's backward (xclip_tpu/kernels/fused_ff.py `_bwd_kernel`):
//     T h and T do; mean and the two-pass variance are recomputed from the
//     row in registers, as the forward took them; dh alone.
//   kGegluStoredH: K1-h's pass 1 (`_p1_stored_core`, `_p2_stored_core`): T
//     h, fp32 dy, the forward's stored statistics, which came from the fp32
//     h while prod here comes from the rounded one (the reference's
//     precision quirk, kept); also dprod_out = T(dprod), y = T(xhat * g) and
//     dh2 = the same dh from T(dprod) (pass 2's operand; skipped when dh2 ==
//     dh, as in fp32).
template <typename Th, typename Tdy, typename T, int MODE, int V, int NT>
__global__ void __launch_bounds__(NT, kRowMinBlocks)
geglu_bwd_rows_kernel(const Tdy* __restrict__ dy, const Th* __restrict__ h,
                      const float* __restrict__ mean,
                      const float* __restrict__ inv, const T* __restrict__ g,
                      float* __restrict__ dg_part, int rows, int d, float eps,
                      T* __restrict__ dh, T* __restrict__ y,
                      T* __restrict__ dprod_out, T* __restrict__ dh2,
                      bool vec) {
  __shared__ float red[kRedFloats];
  __shared__ __align__(16) float part[NT * 8];
  const RowGroups rg(d, V);
  const long r0 = (long)blockIdx.x * kBwdRows;
  const int steps = (kBwdRows + rg.R - 1) / rg.R;
  float gv[V][8], acc[V][8];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    unpack8(load8(g + rg.col(k), rg.n(k), vec), gv[k]);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[k][e] = 0.f;
  }
  struct Row {  // one row's inputs as loaded
    Vec8<Th> a[V], b[V];
    Vec8<Tdy> dy[V];
    float mu, iv;
    bool ok;
    long r;
  };
  auto fetch = [&](int s) {
    Row x;
    const int rr = s * rg.R + rg.grp;
    x.r = r0 + rr;
    x.ok = rg.cols && rr < kBwdRows && x.r < rows;
    const Th* hr = h + x.r * 2 * d;
    const Tdy* dyr = dy + x.r * d;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = rg.col(k), n = x.ok ? rg.n(k) : 0;
      x.a[k] = load8(hr + c, n, vec);
      x.b[k] = load8(hr + d + c, n, vec);
      x.dy[k] = load8(dyr + c, n, vec);
    }
    const bool stored = MODE != kGegluLn && x.ok;
    x.mu = stored ? mean[x.r] : 0.f;
    x.iv = stored ? inv[x.r] : 0.f;
    return x;
  };
  int turn = 0;
  Row cur = fetch(0), nxt;
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) nxt = fetch(s + 1);
    const long o = cur.r * d;
    // a, gelu(b), gelu'(b) and prod (in xh until the statistics are known),
    // once an element
    float a[V][8], gb[V][8], gdb[V][8], xh[V][8], dyg[V][8];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float b[8];
      unpack8(cur.a[k], a[k]);
      unpack8(cur.b[k], b);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const GegluParts q(a[k][e], b[e]);
        gb[k][e] = q.gelu_b;
        gdb[k][e] = q.gelu_db(b[e]);
        xh[k][e] = q.prod;
      }
    }
    float mu = cur.mu, iv = cur.iv;
    if constexpr (MODE == kGegluLn) {  // two-pass statistics of the row
      float s1[1] = {0.f};
#pragma unroll
      for (int k = 0; k < V; ++k)
#pragma unroll
        for (int e = 0; e < 8; ++e) s1[0] += xh[k][e];
      group_sum(s1, rg, red, turn);
      mu = s1[0] / (float)d;
      float s2[1] = {0.f};
      if (cur.ok)
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int n = rg.n(k);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float c = xh[k][e] - mu;
            if (e < n) s2[0] += c * c;
          }
        }
      group_sum(s2, rg, red, turn);
      iv = rsqrtf(s2[0] / (float)d + eps);
    }
    float sums[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float dv[8];
      unpack8(cur.dy[k], dv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xh[k][e] = (xh[k][e] - mu) * iv;
        dyg[k][e] = dv[e] * gv[k][e];
        sums[0] += dyg[k][e];
        sums[1] += dyg[k][e] * xh[k][e];
        if (cur.ok) acc[k][e] += dv[e] * xh[k][e];
      }
      if (MODE != kGegluLn && cur.ok) {  // y needs no row sum: it leaves first
        float t[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) t[e] = xh[k][e] * gv[k][e];
        store8(y + o + rg.col(k), t, rg.n(k), vec);
      }
    }
    group_sum(sums, rg, red, turn);
    const float m1 = sums[0] / (float)d, m2 = sums[1] / (float)d;
    if (cur.ok) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float val[8], da[8], db[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          val[e] = iv * (dyg[k][e] - m1 - xh[k][e] * m2);
          da[e] = val[e] * gb[k][e];
          db[e] = val[e] * a[k][e] * gdb[k][e];
        }
        const int c = rg.col(k), n = rg.n(k);
        store8(dh + 2 * o + c, da, n, vec);
        store8(dh + 2 * o + d + c, db, n, vec);
        if (MODE == kGegluStoredH) {
          store8(dprod_out + o + c, val, n, vec);
          if (dh2 != dh) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float pr = round_to<T>(val[e]);
              da[e] = pr * gb[k][e];
              db[e] = pr * a[k][e] * gdb[k][e];
            }
            store8(dh2 + 2 * o + c, da, n, vec);
            store8(dh2 + 2 * o + d + c, db, n, vec);
          }
        }
      }
    }
    cur = nxt;
  }
  write_partial<V>(acc, rg, part, dg_part, d, vec);
}

// ------------------------------------------------------- LayerNorm forward
//
// Per row r of v (d wide; with GEGLU v = a * gelu(b) of the row [a, b] of
// in, 2d wide, evaluated once an element):
//   mean = sum(v) / d,  inv = rsqrt(sum((v - mean)^2) / d + eps),
//   out  = T((v - mean) * inv * g), or with resid T(that) + resid, the add
//          in T;
// with mean_out, mean and inv go to mean_out[r] and inv_out[r]; with
// in_copy, T(v) goes to in_copy[r]. The two sums are taken from the
// registers: the row is read once, as the backward rows read theirs
// (RowGroups; the next step's loads issued before this step's sums), and
// every output leaves as 16-byte vectors. Each sum reduces by shuffles
// within a warp, then across the group's warps through `red` (one barrier
// a sum, only where a row spans more than a warp). Bound by bytes: the
// plain mode reads T and writes T, 4 bytes an element in bf16; the inner
// LayerNorm of the FF blocks reads fp32 and writes bf16 (6), K8's reads
// 2 x bf16 and writes bf16 (6).
constexpr int kFwdRows = 32;      // rows a block
constexpr int kFwdThreads = 256;  // threads a block
// Vectors of 8 columns a thread holds of a row, at least (more when the
// row is wider than the block's threads take one each): 2 puts a 512-wide
// row on one warp, no barrier a sum, and twice the bytes in flight a
// thread; the GEGLU mode, an erf an element, keeps the most threads a row
// (1). tools/ln_fwd_variants.py times 1, 2 and 4 (PERF.md).
constexpr int kFwdMinVectors = 2;

// No least number of blocks an SM in the launch bounds: the compiler's
// own register choice (128 a thread in the GEGLU mode) ran fastest; 3 an
// SM (80 registers) helps the 512-wide bf16 rows 5-7 % and costs the
// 2048-wide fp32 rows 10-20 % (tools/ln_fwd_variants.py, PERF.md).
template <typename Tin, typename T, bool GEGLU, int V, int NT>
__global__ void __launch_bounds__(NT)
ln_fwd_rows_kernel(const Tin* __restrict__ in, const T* __restrict__ g,
                   const T* __restrict__ resid, T* __restrict__ out,
                   int rows, int d, float eps, float* __restrict__ mean_out,
                   float* __restrict__ inv_out, T* __restrict__ in_copy,
                   bool vec) {
  __shared__ float red[kRedFloats];
  const RowGroups rg(d, V);
  const long r0 = (long)blockIdx.x * kFwdRows;
  const int steps = (kFwdRows + rg.R - 1) / rg.R;
  const long in_ld = GEGLU ? 2L * d : (long)d;
  float gv[V][8];
#pragma unroll
  for (int k = 0; k < V; ++k)
    unpack8(load8(g + rg.col(k), rg.n(k), vec), gv[k]);
  struct Row {  // one row's inputs as loaded
    Vec8<Tin> a[V], b[V];
    Vec8<T> e[V];
    bool ok;
    long r;
  };
  auto fetch = [&](int s) {
    Row x;
    const int rr = s * rg.R + rg.grp;
    x.r = r0 + rr;
    x.ok = rg.cols && rr < kFwdRows && x.r < rows;
    const long o = x.ok ? x.r : 0;  // the row's offset, in range
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = rg.col(k), n = x.ok ? rg.n(k) : 0;
      x.a[k] = load8(in + o * in_ld + c, n, vec);
      if (GEGLU) x.b[k] = load8(in + o * in_ld + d + c, n, vec);
      x.e[k] = load8(resid + o * d + c, resid ? n : 0, vec);
    }
    return x;
  };
  int turn = 0;
  Row cur = fetch(0), nxt;
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) nxt = fetch(s + 1);
    float v[V][8], s1[1] = {0.f};
#pragma unroll
    for (int k = 0; k < V; ++k) {
      unpack8(cur.a[k], v[k]);
      if constexpr (GEGLU) {
        float b[8];
        unpack8(cur.b[k], b);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[k][e] = GegluParts(v[k][e], b[e]).prod;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) s1[0] += v[k][e];  // masked columns are 0
    }
    group_sum(s1, rg, red, turn);
    const float mu = s1[0] / (float)d;
    float s2[1] = {0.f};
    if (cur.ok)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int n = rg.n(k);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float c = v[k][e] - mu;
          if (e < n) s2[0] += c * c;
        }
      }
    group_sum(s2, rg, red, turn);
    const float iv = rsqrtf(s2[0] / (float)d + eps);
    if (cur.ok) {
      const long o = cur.r * d;
      if (mean_out && rg.j == 0) {
        mean_out[cur.r] = mu;
        inv_out[cur.r] = iv;
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int c = rg.col(k), n = rg.n(k);
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = ((v[k][e] - mu) * iv) * gv[k][e];
        if (resid) {
          float rv[8];
          unpack8(cur.e[k], rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) y[e] = round_to<T>(y[e]) + rv[e];
        }
        store8(out + o + c, y, n, vec);
        if (in_copy) store8(in_copy + o + c, v[k], n, vec);
      }
    }
    cur = nxt;
  }
}

template <typename Tin, typename T, bool GEGLU, int V>
void ln_fwd_rows_v(const Tin* in, const T* g, const T* resid, T* out,
                   int rows, int d, float eps, float* mean_out,
                   float* inv_out, T* in_copy, bool vec, cudaStream_t st) {
  ln_fwd_rows_kernel<Tin, T, GEGLU, V, kFwdThreads>
      <<<(rows + kFwdRows - 1) / kFwdRows, kFwdThreads, 0, st>>>(
          in, g, resid, out, rows, d, eps, mean_out, inv_out, in_copy, vec);
}

// out (rows x d) = T(LN_g(in)) [+ resid], as ln_fwd_rows_kernel says; with
// GEGLU `in` is rows x 2d. Returns a cudaError_t code:
// cudaErrorInvalidValue, launching nothing, for a width row_vectors
// refuses; 0, launching nothing, for no rows.
template <typename Tin, typename T, bool GEGLU = false>
int launch_ln_rows(const Tin* in, const T* g, const T* resid, T* out,
                   int rows, int d, float eps, cudaStream_t st,
                   float* mean_out = nullptr, float* inv_out = nullptr,
                   T* in_copy = nullptr) {
  int vecs = row_vectors(d, kFwdThreads);
  if (vecs == 0 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int least = GEGLU ? 1 : kFwdMinVectors;
  vecs = vecs > least ? vecs : least;
  const bool vec = row_vec(d, {in, g, resid, out, in_copy});
  (vecs == 1   ? ln_fwd_rows_v<Tin, T, GEGLU, 1>
   : vecs == 2 ? ln_fwd_rows_v<Tin, T, GEGLU, 2>
               : ln_fwd_rows_v<Tin, T, GEGLU, 4>)(
      in, g, resid, out, rows, d, eps, mean_out, inv_out, in_copy, vec, st);
  XCLIP_CHECK_LAUNCH();
  const int mode = GEGLU ? kLnFwdGeglu
                   : resid ? kLnFwdResidual
                   : in_copy ? kLnFwdInCopy
                   : mean_out ? kLnFwdStats : kLnFwdPlain;
  ++g_row_launches[kLnFwdCounter + mode];
  return 0;
}

// Each launch function returns a cudaError_t code: cudaErrorInvalidValue,
// launching nothing, for a width row_vectors refuses.
template <typename Th, typename Tdy, typename T, int MODE, int V>
void geglu_bwd_rows_v(const Tdy* dy, const Th* h, const float* mean,
                      const float* inv, const T* g, float* dg_part, int rows,
                      int d, float eps, T* dh, T* y, T* dprod_out, T* dh2,
                      bool vec, cudaStream_t st) {
  constexpr int NT = geglu_row_threads<MODE>();
  geglu_bwd_rows_kernel<Th, Tdy, T, MODE, V, NT>
      <<<ln_bwd_blocks(rows), NT, 0, st>>>(dy, h, mean, inv, g, dg_part,
                                           rows, d, eps, dh, y, dprod_out,
                                           dh2, vec);
}

// mean / inv: the stored statistics (null for kGegluLn, which takes eps).
template <typename Th, typename Tdy, typename T, int MODE>
int launch_geglu_bwd_rows(const Tdy* dy, const Th* h, const float* mean,
                          const float* inv, const T* g, float* dg_part,
                          int rows, int d, T* dh, cudaStream_t st,
                          float eps = 0.f, T* y = nullptr,
                          T* dprod_out = nullptr, T* dh2 = nullptr) {
  const int vecs = row_vectors(d, geglu_row_threads<MODE>());
  if (vecs == 0) return (int)cudaErrorInvalidValue;
  const bool vec = row_vec(d, {dy, h, g, dg_part, dh, y, dprod_out, dh2});
  (vecs == 1   ? geglu_bwd_rows_v<Th, Tdy, T, MODE, 1>
   : vecs == 2 ? geglu_bwd_rows_v<Th, Tdy, T, MODE, 2>
               : geglu_bwd_rows_v<Th, Tdy, T, MODE, 4>)(
      dy, h, mean, inv, g, dg_part, rows, d, eps, dh, y, dprod_out, dh2, vec,
      st);
  XCLIP_CHECK_LAUNCH();
  ++g_row_launches[MODE];
  return 0;
}

template <typename Tdy, typename Tv, typename T, int MODE, int V>
void ln_bwd_rows_v(const Tdy* dy, const Tv* v, const float* mean,
                   const float* inv, const T* g, const T* resid, T* out,
                   float* dg_part, int rows, int d, T* xn_out, const T* gb,
                   const T* agdb, T* dh, T* dh2, T* y2, bool vec,
                   cudaStream_t st) {
  ln_bwd_rows_kernel<Tdy, Tv, T, MODE, V, kRowThreads>
      <<<ln_bwd_blocks(rows), kRowThreads, 0, st>>>(
          dy, v, mean, inv, g, resid, out, dg_part, rows, d, xn_out, gb, agdb,
          dh, dh2, y2, vec);
}

template <typename Tdy, typename Tv, typename T, int MODE>
int launch_ln_bwd_rows(const Tdy* dy, const Tv* v, const float* mean,
                       const float* inv, const T* g, const T* resid, T* out,
                       float* dg_part, int rows, int d, cudaStream_t st,
                       T* xn_out = nullptr, const T* gb = nullptr,
                       const T* agdb = nullptr, T* dh = nullptr,
                       T* dh2 = nullptr, T* y2 = nullptr) {
  const int vecs = row_vectors(d, kRowThreads);
  if (vecs == 0) return (int)cudaErrorInvalidValue;
  const bool vec = row_vec(d, {dy, v, g, resid, out, dg_part, xn_out, gb,
                               agdb, dh, dh2, y2});
  (vecs == 1   ? ln_bwd_rows_v<Tdy, Tv, T, MODE, 1>
   : vecs == 2 ? ln_bwd_rows_v<Tdy, Tv, T, MODE, 2>
               : ln_bwd_rows_v<Tdy, Tv, T, MODE, 4>)(
      dy, v, mean, inv, g, resid, out, dg_part, rows, d, xn_out, gb, agdb, dh,
      dh2, y2, vec, st);
  XCLIP_CHECK_LAUNCH();
  ++g_row_launches[kGegluModes + MODE];
  return 0;
}

}  // namespace
}  // namespace xclip
