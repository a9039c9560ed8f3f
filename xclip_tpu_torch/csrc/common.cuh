// Device code shared by the hand-written Hopper kernels of xclip_tpu_torch.
//
//   * dtype helpers: storage is fp32 or bf16; every statistic, softmax and
//     product accumulates in fp32, and a value is rounded to the storage
//     dtype exactly where the JAX kernels cast (`.astype(x.dtype)`).
//   * row_kernels.cuh (included at the end): the LayerNorm row kernels,
//     forward and backward, and the GEGLU-backward row kernel
//     (ln_fwd_rows_kernel, ln_bwd_rows_kernel, geglu_bwd_rows_kernel) and
//     their launch functions (launch_ln_rows, launch_ln_bwd_rows,
//     launch_geglu_bwd_rows).
//   * launch_mm: a tiled matrix product with fused epilogues, either
//     operand optionally transposed (the backward's A·Bᵀ and Aᵀ·B), the k
//     axis optionally split into ranges that write fp32 partials (the
//     weight gradients over the long row axis, summed in order by
//     launch_reduce_parts). bf16 operands go to the wgmma kernel of
//     gemm_sm90.cu (TMA-fed), fp32 operands to the register-tiled FMA
//     kernel of gemm_f32.cu (cp.async-fed, full fp32, no TF32); each is
//     its own translation unit.
//   * launch_reduce_parts / launch_emit_sum: the ordered sums of fp32
//     partials (the dg and split-k sums of every backward), strictly in
//     order, on a slab kernel with a cp.async ring (narrow and deep) or a
//     grid-stride vector kernel (wide and shallow).
//
// Everything sits in an anonymous namespace: each .cu file gets its own
// copies of the template kernels, so linking several of them into one
// shared library cannot merge their launch stubs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "gemm_sm90.cuh"

namespace xclip {

// Launches of the ordered sums (below) by (regime, width) since the library
// was loaded or last reset (xclip_sum_launches, rows.cu), from every
// caller: a step's sums by width, which tells its call sites apart where
// their widths differ. Up to kSumSites widths; a launch of a width past
// them goes to g_sum_unrecorded, which makes the reading an error.
struct SumSite {
  long long n, launches;
  int wide;
};
constexpr int kSumSites = 32;
extern SumSite g_sum_sites[kSumSites];
extern long long g_sum_unrecorded;

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

// exact (erf) GELU of the gate b and the GEGLU product a * gelu(b), as
// jax.nn.gelu(approximate=False): gelu(b) = b * Phi(b); gelu'(b) = Phi(b) +
// b * phi(b), one erf and one exp (xclip_tpu/kernels/fused_ff_block.py
// _gelu_val_grad). The forward's product epilogue, K8's row kernels and the
// GEGLU backward rows all take them from here, so a recomputed prod repeats
// the forward's op sequence on the same h.
struct GegluParts {
  float phi, gelu_b, prod;
  __device__ __forceinline__ GegluParts(float a, float b) {
    phi = 0.5f * (1.f + erff(b * 0.70710678118654752f));
    gelu_b = b * phi;
    prod = a * gelu_b;
  }
  __device__ __forceinline__ float gelu_db(float b) const {
    return phi + b * (expf(-0.5f * b * b) * 0.3989422804014327f);
  }
};

// ------------------------------------------------------- matrix product
//
// out (m x n) = epilogue(opA · opB) over a k-range, fp32 accumulation:
//   opA(i, kk) = TA ? A[kk * m + i] : A[i * k + kk]  (A is m x k, or k x m)
//   opB(kk, j) = TB ? B[j * k + kk] : B[kk * n + j]  (B is k x n, or n x k)
// The forwards multiply row-major operands (TA = TB = false). The backward
// needs A·Bᵀ (TB; m = rows, k = a weight width) and Aᵀ·B (TA; k = rows, m
// and n weight widths). m, n and k are multiples of 64 except the ragged
// row axis, which is masked. The row axis of Aᵀ·B is long (65,792 text
// rows) and its output small (a weight), so k may be split into `parts`
// ranges of `k_split` that write separate fp32 partials (the z-th at out +
// z * m * n); launch_reduce_parts sums them in order. Epilogues (acc is the
// fp32 product):
constexpr int kStore = 0;     // out (T)    = T(acc)
constexpr int kStoreF32 = 1;  // out (fp32) = acc, the z-th partial
constexpr int kGeglu = 2;     // out (fp32) = a * gelu(b): B is (k, 2n),
                              //   a from columns [0, n), b from [n, 2n)
constexpr int kResidual = 3;  // out (T)    = T(acc) + resid, added in T
constexpr int kGegluTriple = 4;  // as kGeglu, and also aux1 (T) = gelu(b),
                                 //   aux2 (T) = a * gelu'(b)
constexpr int kGegluH = 5;  // as kGeglu, and also aux1 (T, m x 2n) = the
                            //   product itself rounded: a, then b

__host__ __device__ constexpr bool is_geglu(int epi) {
  return epi == kGeglu || epi == kGegluTriple || epi == kGegluH;
}

struct Split {
  int parts, k_split;  // k_split 0: the whole k in one range
};

// k_block > 0: k-ranges of exactly k_block (the last may be short), so a
// caller that splits k at multiples of k_block gets the same partials; bf16
// callers pass a multiple of kGemmBK. Otherwise the fewest k-ranges (each
// at least 1024 long, at most two work tiles a slot) whose work tiles fill
// the card's slots to within 10 % in their last wave (else the fullest):
// in bf16 the wgmma kernel's 128 x kGemmBN tiles on its persistent blocks,
// one on each of kGemmSMs, ranges a multiple of its kGemmBK-deep slice, so
// no TMA box crosses into the next range; in fp32 the FMA kernel's 128 x
// 128 tiles on two blocks an SM, ranges a multiple of 32 (whole 16-deep
// slices).
inline Split gemm_split(int m, int n, int k, bool tensor_cores,
                        int k_block = 0) {
  if (k_block > 0) return Split{(k + k_block - 1) / k_block, k_block};
  const int tile_n = tensor_cores ? kGemmBN : kGemmF32Tile;
  const long tiles = (long)((m + kGemmBM - 1) / kGemmBM) *
                     ((n + tile_n - 1) / tile_n);
  const long slots = tensor_cores ? kGemmSMs : 2 * kGemmSMs;
  const long most = std::min((2 * slots + tiles - 1) / tiles, (long)k / 1024);
  long parts = 1;
  double best = 0.0;
  for (long p = 1; p <= most; ++p) {
    const long work = tiles * p;
    const double fill =
        (double)work / ((double)((work + slots - 1) / slots) * slots);
    if (fill > best + 1e-9) {
      best = fill;
      parts = p;
    }
    if (fill >= 0.9) break;
  }
  const int align = tensor_cores ? kGemmBK : 32;
  const int k_split =
      (int)(((k + parts - 1) / parts + align - 1) / align * align);
  return Split{(k + k_split - 1) / k_split, k_split};
}

// cp.async, for the attention kernels' rings (mma_tiles.cuh and the FMA
// cores), the fp32 product kernel's ring and the ordered sums' slab ring
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
// 4-byte global → shared copy (cp.async.ca: .cg takes only 16 bytes);
// zero-fills when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

// ------------------------------------------------------- ordered sums
//
// out[i] = Tout(part[0][i] + part[1][i] + ... + part[parts - 1][i]),
// strictly left to right in fp32 (kernels/matmul.py `ordered_sum`); with
// `accumulate` (fp32 out) the sum starts from out[i]: the recompute
// backwards add one row chunk's partials at a time, in chunk order, so
// partials over fixed row blocks are summed in one order however the rows
// are chunked. They take the place of the Pallas backwards' dg and dW
// accumulators, carried in VMEM scratch across the sequential row grid
// (xclip_tpu/kernels/fused_ff_block.py `dgpre_scr` / `dgin_scr` :447-448,
// :576-577, `dwina_scr` / `dwout_scr` :697-701, :802-804; the megablock's
// likewise): every partial of a row block or k-range written by the
// kernel before, then one ordered sum, no float atomics, two runs agree
// bit for bit.
//
// What bounds them: the bytes (each partial read once, the out read and
// written once), and for the dg sums a chain of `parts` dependent fp32 adds
// a column. The order runs along the parts, so the parallelism comes from
// columns and bytes in flight, never from reordering. Two regimes, by
// (parts, n), in launch_reduce_parts:
//   * Narrow and deep, the dg sums (n = 512 or 2048, 384 to 1,028 parts):
//     reduce_parts_slab_kernel. The columns are cut into slabs of S = 16,
//     8 or 4 fp32 (the widest that still gives kSumMinBlocks blocks); a
//     block of kSumThreads streams its slab of every part (parts x S, row
//     stride n) through a ring of kSumRing stages in shared memory by
//     cp.async, one 16-byte copy a thread a stage (kSumRing - 1 stages in
//     flight: 28 KB a block, ~7 MB across the card at n = 2048), and S
//     threads add the stage's rows in order, one column each, from shared
//     memory. A width off the 4-column grid or a partial pointer that is
//     not 16-byte aligned takes the same walk by 4-byte copies; a ragged
//     last slab zero-fills its columns past n and stores only below n.
//   * Wide and shallow, the split-k sums (n = 262,144 to 2,097,152, 12-15
//     parts): reduce_parts_wide_kernel, a persistent grid-stride loop over
//     kSumWideBlocks blocks an SM, a thread the columns of one 16-byte
//     vector of its out (4 fp32, 8 bf16), every part of them loaded (up
//     to kSumBatch at once) before their adds, as 16-byte loads marked
//     evict-first (the partials are dead after the sum), the out read and
//     written as one 16-byte vector. Off that vector grid, or with a
//     pointer not 16-byte aligned, one column a thread.
// tools/sums_variants.py times the slab width, the ring depth, the block
// and the regimes against part.sum(0) (and an older checkout's kernels,
// --parent).
constexpr int kSumThreads = 256;     // threads of a slab block
constexpr int kSumRing = 8;          // stages of a slab block's ring
constexpr int kSumMinBlocks = kGemmSMs;  // slab blocks wanted: one an SM
constexpr int kSumWideThreads = 256;  // threads of a wide block
constexpr int kSumWideBlocks = 4;     // wide blocks an SM (132 SMs)
constexpr int kSumBatch = 12;         // parts a wide thread loads at once
// columns a wide thread: one 16-byte vector of its out (4 fp32, 8 bf16)
template <typename Tout> constexpr int kSumWideColumns = 16 / sizeof(Tout);
// n from which the sums go wide: a vector a thread for two warps an SM
constexpr long kSumWideMin = 8L * kGemmSMs * 64;

inline void count_sum(long n, int wide) {
  for (SumSite& s : g_sum_sites) {
    if (s.launches == 0 || (s.n == n && s.wide == wide)) {
      s.n = n;
      s.wide = wide;
      ++s.launches;
      return;
    }
  }
  ++g_sum_unrecorded;
}

template <typename Tout, int S, bool VEC>
__global__ void __launch_bounds__(kSumThreads)
reduce_parts_slab_kernel(const float* __restrict__ part,
                         Tout* __restrict__ out, int parts, long n,
                         int accumulate) {
  constexpr int V = S / 4;                 // 4-column vectors a part row
  constexpr int ROWS = kSumThreads / V;    // part rows a stage
  __shared__ __align__(16) float ring[kSumRing][ROWS * S];
  const int t = threadIdx.x;
  const long c0 = (long)blockIdx.x * S;
  // this thread's copy each stage: part row `row` of the stage, columns
  // [col, col + 4) of the slab
  const int row = t / V, col = (t % V) * 4;
  const int stages = (parts + ROWS - 1) / ROWS;
  auto fetch = [&](int s) {
    if (s < stages) {
      const int p = s * ROWS + row;
      float* dst = &ring[s % kSumRing][row * S + col];
      const float* src = part + (long)p * n + c0 + col;
      if (VEC) {
        const bool ok = p < parts && c0 + col < n;
        cp_async16(dst, ok ? src : part, ok);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = p < parts && c0 + col + q < n;
          cp_async4(dst + q, ok ? src + q : part, ok);
        }
      }
    }
    cp_async_commit();  // empty groups past the last stage keep the count
  };
#pragma unroll
  for (int s = 0; s < kSumRing - 1; ++s) fetch(s);
  const long c = c0 + t;
  float acc = 0.f;
  if (t < S && accumulate && c < n) acc = to_f(out[c]);
  for (int s = 0; s < stages; ++s) {
    fetch(s + kSumRing - 1);  // into the stage consumed last iteration
    cp_async_wait<kSumRing - 1>();
    __syncthreads();
    if (t < S) {
      const float* v = ring[s % kSumRing] + t;
      const int rows = min(ROWS, parts - s * ROWS);
      int r = 0;
      if (s == 0 && !accumulate) {
        acc = v[0];
        r = 1;
      }
#pragma unroll 16
      for (; r < rows; ++r) acc += v[r * S];
    }
    __syncthreads();
  }
  if (t < S && c < n) out[c] = from_f<Tout>(acc);
}

// W fp32 from p (16-byte aligned) into v, evict-first
template <int W>
__device__ __forceinline__ void load_cs(float (&v)[W], const float* p) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p) + q);
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

template <typename Tout, bool VEC>
__global__ void __launch_bounds__(kSumWideThreads)
reduce_parts_wide_kernel(const float* __restrict__ part,
                         Tout* __restrict__ out, int parts, long n,
                         int accumulate) {
  constexpr int W = VEC ? kSumWideColumns<Tout> : 1;  // columns a thread
  const long units = n / W;
  for (long u = (long)blockIdx.x * kSumWideThreads + threadIdx.x; u < units;
       u += (long)gridDim.x * kSumWideThreads) {
    const long i = u * W;
    float s[W];
    int p = 0;
    if (accumulate) {  // fp32 out
      if constexpr (VEC && std::is_same<Tout, float>::value) {
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
          const float4 a = reinterpret_cast<const float4*>(out + i)[q];
          s[4 * q] = a.x;
          s[4 * q + 1] = a.y;
          s[4 * q + 2] = a.z;
          s[4 * q + 3] = a.w;
        }
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) s[w] = to_f(out[i + w]);
      }
    } else {
      if constexpr (VEC) {
        load_cs<W>(s, part + i);
      } else {
        s[0] = __ldcs(part + i);
      }
      p = 1;
    }
    for (; p < parts; p += kSumBatch) {
      float q[kSumBatch][W];
#pragma unroll
      for (int b = 0; b < kSumBatch; ++b) {
        if (p + b < parts) {
          const float* src = part + (long)(p + b) * n + i;
          if constexpr (VEC)
            load_cs<W>(q[b], src);
          else
            q[b][0] = __ldcs(src);
        }
      }
#pragma unroll
      for (int b = 0; b < kSumBatch; ++b)
        if (p + b < parts)
#pragma unroll
          for (int w = 0; w < W; ++w) s[w] += q[b][w];
    }
    if constexpr (VEC && std::is_same<Tout, float>::value) {
#pragma unroll
      for (int q = 0; q < W / 4; ++q)
        reinterpret_cast<float4*>(out + i)[q] =
            make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
    } else if constexpr (VEC) {  // bf16: W values, 16-byte stores
      static_assert(W % 8 == 0, "whole 16-byte vectors of bf16");
      __align__(16) Tout v[W];
#pragma unroll
      for (int w = 0; w < W; ++w) v[w] = from_f<Tout>(s[w]);
#pragma unroll
      for (int q = 0; q < W / 8; ++q)
        reinterpret_cast<uint4*>(out + i)[q] = reinterpret_cast<uint4*>(v)[q];
    } else {
      out[i] = from_f<Tout>(s[0]);
    }
  }
}

template <typename Tout, int S>
void launch_slab(const float* part, Tout* out, int parts, long n, bool vec,
                 int accumulate, cudaStream_t st) {
  const unsigned blocks = (unsigned)((n + S - 1) / S);
  if (vec)
    reduce_parts_slab_kernel<Tout, S, true><<<blocks, kSumThreads, 0, st>>>(
        part, out, parts, n, accumulate);
  else
    reduce_parts_slab_kernel<Tout, S, false><<<blocks, kSumThreads, 0, st>>>(
        part, out, parts, n, accumulate);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename Tout>
int launch_reduce_parts(const float* part, Tout* out, int parts, long n,
                        cudaStream_t st, int accumulate = 0) {
  if (parts < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int wide = n >= kSumWideMin;
  if (wide) {
    constexpr int W = kSumWideColumns<Tout>;
    const bool vec = n % W == 0 && aligned16(part) && aligned16(out);
    const long units = vec ? n / W : n;
    const long blocks = std::min((units + kSumWideThreads - 1) /
                                     kSumWideThreads,
                                 (long)kSumWideBlocks * kGemmSMs);
    if (vec)
      reduce_parts_wide_kernel<Tout, true>
          <<<(unsigned)blocks, kSumWideThreads, 0, st>>>(part, out, parts, n,
                                                         accumulate);
    else
      reduce_parts_wide_kernel<Tout, false>
          <<<(unsigned)blocks, kSumWideThreads, 0, st>>>(part, out, parts, n,
                                                         accumulate);
  } else {
    const bool vec = n % 4 == 0 && aligned16(part);
    if ((n + 15) / 16 >= kSumMinBlocks)
      launch_slab<Tout, 16>(part, out, parts, n, vec, accumulate, st);
    else if ((n + 7) / 8 >= kSumMinBlocks)
      launch_slab<Tout, 8>(part, out, parts, n, vec, accumulate, st);
    else
      launch_slab<Tout, 4>(part, out, parts, n, vec, accumulate, st);
  }
  XCLIP_CHECK_LAUNCH();
  count_sum(n, wide);
  return 0;
}

// The sums a backward emits (dW, dg): `acc` 0 writes them in the storage
// dtype T (the stored backwards, one call over every row); 1 writes them in
// fp32 and 2 adds them to the fp32 values there (the recompute backwards,
// one call per row chunk, cast once by the caller after the last).
template <typename T>
int launch_emit_sum(const float* part, void* out, int parts, long n, int acc,
                    cudaStream_t st) {
  if (acc == 0)
    return launch_reduce_parts<T>(part, static_cast<T*>(out), parts, n, st);
  return launch_reduce_parts<float>(part, static_cast<float*>(out), parts, n,
                                    st, acc == 2);
}

template <typename T, int EPI, bool TA = false, bool TB = false>
int launch_mm(const T* A, const T* B, const T* resid, void* out, int m, int n,
              int k, cudaStream_t st, void* aux1 = nullptr,
              void* aux2 = nullptr, Split sp = Split{1, 0}) {
  const int k_split = sp.k_split ? sp.k_split : k;
  if constexpr (std::is_same<T, bf16>::value) {
    return gemm_bf16(EPI, TA, TB, A, B, resid, out, m, n, k, sp.parts,
                     k_split, aux1, aux2, st);
  } else {
    return gemm_f32(EPI, TA, TB, A, B, resid, out, m, n, k, sp.parts, k_split,
                    aux1, aux2, st);
  }
}

// The backward's products: out (m x n, fp32; `sp.parts` partials) =
// opA · opB, as launch_mm with the kStoreF32 epilogue.
template <typename T, bool TA, bool TB>
int launch_gemm(const T* A, const T* B, float* out, int m, int n, int k,
                cudaStream_t st, Split sp = Split{1, 0}) {
  return launch_mm<T, kStoreF32, TA, TB>(A, B, nullptr, out, m, n, k, st,
                                         nullptr, nullptr, sp);
}

// A weight gradient out (m x n) = Aᵀ·B, A (rows x m), B (rows x n): fp32
// partials over k-ranges of the rows in `part`, then an ordered sum, emitted
// as launch_emit_sum's `acc` says (0: T(Aᵀ·B)).
template <typename T>
int launch_weight_grad(const T* A, const T* B, void* out, float* part, int m,
                       int n, int rows, cudaStream_t st, int acc = 0,
                       int k_block = 0) {
  const Split sp =
      gemm_split(m, n, rows, std::is_same<T, bf16>::value, k_block);
  int e = launch_gemm<T, true, false>(A, B, part, m, n, rows, st, sp);
  if (e) return e;
  return launch_emit_sum<T>(part, out, sp.parts, (long)m * n, acc, st);
}

inline size_t weight_grad_part_bytes(int m, int n, int rows, bool bf16,
                                     int k_block = 0) {
  return (size_t)gemm_split(m, n, rows, bf16, k_block).parts * m * n *
         sizeof(float);
}

// Bump allocator over one caller-provided workspace (256-byte aligned
// pieces); with base == nullptr it only counts the bytes.
struct Workspace {
  unsigned char* base;
  size_t used = 0;
  explicit Workspace(void* b) : base(static_cast<unsigned char*>(b)) {}
  template <typename U> U* take(size_t count) {
    U* p = base ? reinterpret_cast<U*>(base + used) : nullptr;
    used += (count * sizeof(U) + 255) / 256 * 256;
    return p;
  }
};

}  // namespace
}  // namespace xclip

// Entry points: run CALL with T the storage type of dtype code `dtype`.
#define XCLIP_DISPATCH(dtype, CALL)          \
  do {                                       \
    if ((dtype) == xclip::kBF16) {           \
      using T = __nv_bfloat16;               \
      return CALL;                           \
    }                                        \
    if ((dtype) == xclip::kF32) {            \
      using T = float;                       \
      return CALL;                           \
    }                                        \
    return (int)cudaErrorInvalidValue;       \
  } while (0)

#define XCLIP_PTR(type, ptr) static_cast<type>(ptr)

#include "row_kernels.cuh"
