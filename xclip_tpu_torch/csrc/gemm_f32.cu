// The fp32 product kernel of the FF blocks and the attention megablock:
// out (m x n) = epilogue(opA · opB) over a k-range, in full fp32 on the
// FMA units (no TF32, no tensor cores), as common.cuh's launch_mm
// documents it. It runs every fp32 product of K-FF, K1, K1-h, K-FF-s, the
// FF recompute backward, K-MEGA, K2 and K3: the counterparts of the
// `jax.lax.dot_general` calls inside their Pallas bodies whenever the
// operands are fp32 (xclip_tpu/kernels/fused_ff_block.py `_fwd_kernel`
// :150, :158, `_fwd_store_core` :234, :245, `_fwd_store_geglu_core` :283,
// :295, the backward products :387, :396, :411, :515, :527, :697-701,
// :770-774; xclip_tpu/kernels/attention_megablock.py `_dot` in
// `_fwd_common` :120 and the backward's, :859), with the Pallas bodies'
// epilogues fused. The bf16 products run on gemm_sm90.cu.
//
// What bounds it on the card: the FMAs, 2mnk FLOPs at 67 TFLOP/s in fp32;
// the operands are read from HBM about once (column tiles walk fastest, so
// the blocks in flight share their A rows in L2, and the weights stay
// there).
//
// Design (Hopper, FMAs only):
//   * A block of 256 threads computes a 128 x 128 output tile; each thread
//     holds an 8 x 8 block of fp32 sums in registers: rows {4 ty + i, 64 +
//     4 ty + i} by columns {4 tx + j, 64 + 4 tx + j}, i, j < 4, (tx, ty) =
//     (t % 16, t / 16). Per k it reads its 8 + 8 operands from shared
//     memory as four 16-byte loads, both operands held k-major there
//     (As[k][m], Bs[k][n]): 4 LDS.128 per 64 FMAs. Two blocks an SM.
//   * k is staged in kF32BK-deep slices through a ring of `stages` slices
//     by cp.async (16-byte copies; 4-byte ones where a row or k is off the
//     4-float grid or a pointer is not 16-byte aligned), so the next
//     slices' copies are in flight during this slice's FMAs; one barrier
//     a slice. An operand whose rows run along m or n (a transposed A, a
//     non-transposed B) lands k-major as it is. One whose rows run along
//     k (a non-transposed A, a transposed B) lands row by row in a padded
//     staging slice and is transposed by the block into one of two
//     k-major buffers one slice ahead of its use.
//   * Each output element is one fp32 FMA chain over its k-range in k
//     order (zero-filled k past the range's end adds nothing), so split-k
//     partials over fixed ranges and chunks of the rows at range
//     boundaries give the same bits; launch_reduce_parts sums the
//     partials in order. No float atomics: two runs agree bit for bit.
//   * The GEGLU epilogues stage A once: the block's B tile holds the 64
//     value columns c0.. and their 64 gate columns n + c0.., so output
//     column j and its gate sit in the same thread, 4 register columns
//     apart, and a * gelu(b), gelu(b), a * gelu'(b) and h come out of
//     registers (GegluParts: the op sequence of the row kernels).
//   * Epilogues store from registers as 16-byte vectors (a warp writes two
//     256-byte row segments), masked at the ragged rows and at columns past
//     n.
// tools/f32_gemm_variants.py times the slice depth, the ring, the register
// budget and the unrolling against their alternatives (and an older
// checkout's kernel, --parent).
#include "common.cuh"

namespace xclip {

long long g_f32_launches[kGemmInstances];  // kernel launches per instance

namespace {

constexpr int kF32Threads = 256;
constexpr int kF32Tile = kGemmF32Tile;  // output rows and columns of a block
constexpr int kF32BK = 16;     // k-slice depth
constexpr int kF32Slice = kF32BK * kF32Tile;  // floats of a k-major slice
constexpr int kF32Ld = kF32BK + 4;  // row stride of a staged row-major slice
constexpr int kF32Staged = kF32Tile * kF32Ld;

// Shared memory of an instance, in floats: for A, then B, a ring of
// `stages` slices (k-major, or staged row-major when the operand's rows
// run along k, plus two k-major buffers it is transposed into).
template <bool TA, bool TB>
struct F32Smem {
  static constexpr bool a_k = TA, b_k = !TB;  // lands k-major as it is
  // three slices where both operands are transposed on the way in: two
  // blocks of four would take 224 of the SM's 228 KB
  static constexpr int stages = a_k || b_k ? 4 : 3;
  static constexpr int ring(bool k) {
    return stages * (k ? kF32Slice : kF32Staged);
  }
  static constexpr int tbuf(bool k) { return k ? 0 : 2 * kF32Slice; }
  static constexpr int a_ring = 0, a_t = a_ring + ring(a_k);
  static constexpr int b_ring = a_t + tbuf(a_k), b_t = b_ring + ring(b_k);
  static constexpr int floats = b_t + tbuf(b_k);
  static constexpr int bytes = floats * (int)sizeof(float);
};

// Where the tile's operand index o (0..127: rows of A, columns of B) lies
// in the operand: o < split at base0 + o, else at base1 + o - split; in
// range below `limit`.
struct Outer {
  int base0, base1, split, limit;
  __device__ __forceinline__ int at(int o) const {
    return o < split ? base0 + o : base1 + o - split;
  }
};

// One thread's cp.async copies of an operand X, set up once: its
// kF32Copies 4-float chunks of every slice, their source pointers advanced
// a slice at a time. KMAJOR: X's rows run along k, X[kk * ld + outer], and
// a slice lands k-major (dst[kk][o]); else X[outer * ld + kk], and it
// lands row-major in a staged slice (dst[o][kk], row stride kF32Ld; four
// threads read a row's 64 contiguous bytes). VEC: every chunk is 16-byte
// aligned and wholly in or out of range along m or n.
constexpr int kF32Copies = kF32Slice / 4 / kF32Threads;

template <bool KMAJOR, bool VEC>
struct SliceCopies {
  const float* src[kF32Copies];  // the chunk in the next slice
  int dst[kF32Copies];           // its offset in a ring slot
  int kk[kF32Copies];            // its (first) k within the slice
  int in[kF32Copies];            // its values in range along m or n (0..4)

  __device__ __forceinline__ SliceCopies(const float* X, long ld,
                                         const Outer& map, int kb) {
#pragma unroll
    for (int p = 0; p < kF32Copies; ++p) {
      const int c = threadIdx.x + p * kF32Threads;
      const int o = KMAJOR ? (c % (kF32Tile / 4)) * 4 : c / (kF32BK / 4);
      kk[p] = KMAJOR ? c / (kF32Tile / 4) : (c % (kF32BK / 4)) * 4;
      dst[p] = KMAJOR ? kk[p] * kF32Tile + o : o * kF32Ld + kk[p];
      const int g = map.at(o);
      in[p] = KMAJOR ? min(max(map.limit - g, 0), 4) : g < map.limit ? 4 : 0;
      src[p] = KMAJOR ? X + (long)(kb + kk[p]) * ld + (in[p] ? g : 0)
                      : X + (in[p] ? (long)g * ld : 0) + kb + kk[p];
    }
  }

  // the next slice into `slot`; `left` of its k in range
  __device__ __forceinline__ void copy(float* slot, int left, const float* X,
                                       long ld) {
#pragma unroll
    for (int p = 0; p < kF32Copies; ++p) {
      if (VEC) {
        const bool ok = in[p] && kk[p] < left;
        cp_async16(slot + dst[p], ok ? src[p] : X, ok);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = KMAJOR ? kk[p] < left && q < in[p]
                                 : in[p] && kk[p] + q < left;
          cp_async4(slot + dst[p] + q, ok ? src[p] + q : X, ok);
        }
      }
      src[p] += KMAJOR ? kF32BK * ld : kF32BK;
    }
  }
};

// A staged row-major slice (src[o][kk]) into k-major dst[kk][o]: a warp
// reads 32 rows' 16-byte words (row stride kF32Ld: no bank conflict) and
// writes 32 consecutive floats of each k row.
__device__ __forceinline__ void transpose_slice(float* dst, const float* src) {
  const int t = threadIdx.x;
#pragma unroll
  for (int p = 0; p < kF32Slice / 4 / kF32Threads; ++p) {
    const int c = t + p * kF32Threads;
    const int o = c % kF32Tile, kk = (c / kF32Tile) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + o * kF32Ld + kk);
    dst[kk * kF32Tile + o] = v.x;
    dst[(kk + 1) * kF32Tile + o] = v.y;
    dst[(kk + 2) * kF32Tile + o] = v.z;
    dst[(kk + 3) * kF32Tile + o] = v.w;
  }
}

// four consecutive floats at p: one 16-byte store where vec
__device__ __forceinline__ void store4(float* p, const float (&v)[4],
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = v[q];
  }
}

template <int EPI, bool TA, bool TB, bool VEC>
__global__ void __launch_bounds__(kF32Threads, 2)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ resid, float* __restrict__ out,
                int m, int n, int k, int k_split, float* __restrict__ aux1,
                float* __restrict__ aux2, bool vec_out) {
  using L = F32Smem<TA, TB>;
  constexpr int ST = L::stages;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int c0 = blockIdx.x * (is_geglu(EPI) ? kF32Tile / 2 : kF32Tile);
  const int row0 = blockIdx.y * kF32Tile;
  const int kb = blockIdx.z * k_split;
  const int ke = k < kb + k_split ? k : kb + k_split;
  const Outer amap{row0, row0, kF32Tile, m};
  const Outer bmap = is_geglu(EPI) ? Outer{c0, n + c0, kF32Tile / 2, 2 * n}
                                   : Outer{c0, c0, kF32Tile, n};
  // A is m x k (row stride k) or, with TA, k x m (row stride m); B is k x
  // ldb or, with TB, n x k
  const long lda = TA ? m : k;
  const long ldb = TB ? k : (is_geglu(EPI) ? 2 * n : n);
  const int slices = (ke - kb + kF32BK - 1) / kF32BK;

  auto ring_a = [&](int s) {
    return smem + L::a_ring + (s % ST) * (L::a_k ? kF32Slice : kF32Staged);
  };
  auto ring_b = [&](int s) {
    return smem + L::b_ring + (s % ST) * (L::b_k ? kF32Slice : kF32Staged);
  };
  // the k-major slice s as the FMAs read it
  auto kmaj_a = [&](int s) {
    return L::a_k ? ring_a(s) : smem + L::a_t + (s & 1) * kF32Slice;
  };
  auto kmaj_b = [&](int s) {
    return L::b_k ? ring_b(s) : smem + L::b_t + (s & 1) * kF32Slice;
  };
  SliceCopies<L::a_k, VEC> copy_a(A, lda, amap, kb);
  SliceCopies<L::b_k, VEC> copy_b(B, ldb, bmap, kb);
  auto issue = [&](int s) {  // slices in order, each once
    if (s < slices) {
      const int left = ke - kb - s * kF32BK;
      copy_a.copy(ring_a(s), left, A, lda);
      copy_b.copy(ring_b(s), left, B, ldb);
    }
    cp_async_commit();  // empty groups past the last slice keep the count
  };
  auto transpose = [&](int s) {  // the operands staged row-major
    if constexpr (!L::a_k)
      transpose_slice(smem + L::a_t + (s & 1) * kF32Slice, ring_a(s));
    if constexpr (!L::b_k)
      transpose_slice(smem + L::b_t + (s & 1) * kF32Slice, ring_b(s));
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) issue(s);
  cp_async_wait<ST - 2>();  // slice 0 landed
  __syncthreads();
  transpose(0);
  for (int s = 0; s < slices; ++s) {
    // slice s + 1 landed (every thread's copies, after the barrier); the
    // FMAs of slice s - 1 are done, so its ring stage and the k-major
    // buffer of slice s + 1 are free
    cp_async_wait<ST - 3>();
    __syncthreads();
    if (s + 1 < slices) transpose(s + 1);
    issue(s + ST - 1);
    const float* As = kmaj_a(s);
    const float* Bs = kmaj_b(s);
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(As + kk * kF32Tile + 4 * ty);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + kk * kF32Tile + 64 + 4 * ty);
      const float4 b0 =
          *reinterpret_cast<const float4*>(Bs + kk * kF32Tile + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + kk * kF32Tile + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  if (EPI == kStoreF32) out += (long)blockIdx.z * m * n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= m) continue;
    if constexpr (is_geglu(EPI)) {
      // columns c .. c + 3: the value in acc[i][q], its gate in acc[i][4 + q]
      const int c = c0 + 4 * tx;
      const long o = (long)r * n + c;
      float prod[4], gb[4], agdb[4], a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = acc[i][q];
        b[q] = acc[i][4 + q];
        const GegluParts g(a[q], b[q]);
        prod[q] = g.prod;
        gb[q] = g.gelu_b;
        agdb[q] = a[q] * g.gelu_db(b[q]);
      }
      store4(out + o, prod, vec_out);
      if (EPI == kGegluTriple) {
        store4(aux1 + o, gb, vec_out);
        store4(aux2 + o, agdb, vec_out);
      } else if (EPI == kGegluH) {
        const long ho = (long)r * 2 * n + c;
        store4(aux1 + ho, a, vec_out);
        store4(aux1 + ho + n, b, vec_out);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + 64 * h + 4 * tx;
        if (c >= n) continue;  // n is a multiple of 64
        const long o = (long)r * n + c;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = acc[i][4 * h + q];
        if (EPI == kResidual) {  // T(acc) + resid in T = fp32
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] += resid[o + q];
        }
        store4(out + o, v, vec_out);
      }
    }
  }
}

template <int EPI, bool TA, bool TB, bool VEC>
int launch_f32(const float* A, const float* B, const float* resid, void* out,
               int m, int n, int k, int parts, int k_split, void* aux1,
               void* aux2, bool vec_out, cudaStream_t st) {
  using L = F32Smem<TA, TB>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_f32_kernel<EPI, TA, TB, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(is_geglu(EPI) ? n / (kF32Tile / 2)
                                : (n + kF32Tile - 1) / kF32Tile,
                  (m + kF32Tile - 1) / kF32Tile, parts);
  gemm_f32_kernel<EPI, TA, TB, VEC><<<grid, kF32Threads, L::bytes, st>>>(
      A, B, resid, static_cast<float*>(out), m, n, k, k_split,
      static_cast<float*>(aux1), static_cast<float*>(aux2), vec_out);
  XCLIP_CHECK_LAUNCH();
  ++g_f32_launches[gemm_instance(EPI, TA, TB)];
  return 0;
}

template <int EPI, bool TA, bool TB>
int launch_f32_any(const float* A, const float* B, const float* resid,
                   void* out, int m, int n, int k, int parts, int k_split,
                   void* aux1, void* aux2, cudaStream_t st) {
  // 16-byte copies: the pointers aligned, and every 4-float chunk of a
  // staged row wholly in or out of range (m on the grid where A's rows run
  // along m; k and the k-ranges where a row runs along k)
  const bool k4 = k % 4 == 0 && (parts == 1 || k_split % 4 == 0);
  const bool vec = aligned16(A) && aligned16(B) && (TA ? m % 4 == 0 : k4) &&
                   (!TB || k4);
  const bool vec_out = aligned16(out) && aligned16(resid) &&
                       aligned16(aux1) && aligned16(aux2);
  if (vec)
    return launch_f32<EPI, TA, TB, true>(A, B, resid, out, m, n, k, parts,
                                         k_split, aux1, aux2, vec_out, st);
  return launch_f32<EPI, TA, TB, false>(A, B, resid, out, m, n, k, parts,
                                        k_split, aux1, aux2, vec_out, st);
}

}  // namespace

int gemm_f32(int epi, bool ta, bool tb, const float* A, const float* B,
             const float* resid, void* out, int m, int n, int k, int parts,
             int k_split, void* aux1, void* aux2, cudaStream_t st) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 64 || parts < 1 ||
      (parts > 1 && (epi != kStoreF32 || k_split <= 0 ||
                     (long)(parts - 1) * k_split >= k ||
                     (long)parts * k_split < k)))
    return (int)cudaErrorInvalidValue;
  if (parts == 1) k_split = k;
  switch (gemm_instance(epi, ta, tb)) {
#define XCLIP_F32(E, A_T, B_T)                                             \
  return launch_f32_any<E, A_T, B_T>(A, B, resid, out, m, n, k, parts,    \
                                     k_split, aux1, aux2, st)
    case 0: XCLIP_F32(kStore, false, false);
    case 1: XCLIP_F32(kStoreF32, false, false);
    case 2: XCLIP_F32(kStoreF32, false, true);
    case 3: XCLIP_F32(kStoreF32, true, false);
    case 4: XCLIP_F32(kGeglu, false, false);
    case 5: XCLIP_F32(kGegluTriple, false, false);
    case 6: XCLIP_F32(kGegluH, false, false);
    case 7: XCLIP_F32(kResidual, false, false);
#undef XCLIP_F32
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace xclip
