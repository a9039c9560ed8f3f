// Register-resident tensor-core tiles for one warp: mma.sync m16n8k16
// (bf16 operands, fp32 accumulators) fed by ldmatrix from shared memory.
//
// A warp owns a 16-row strip. Its accumulator over 64 columns is
// `float acc[8][4]`, eight 16x8 tiles: element e of tile t sits at row
// (lane >> 2) + 8 * (e >> 1), column 8 t + 2 (lane & 3) + (e & 1). A
// 16x64 A operand is `uint32_t a[4][4]`, four 16x16 k-slices of packed
// bf16 pairs. The accumulator layout of m16n8k16 is the layout of its A
// operand, so an accumulator rounded to bf16 (`pack_a`) is the A operand
// of the next product without leaving registers: the attention kernels
// turn scores into p and ds that way.
//
// Shared-memory tiles are 64 rows of 64 bf16 at a row stride of LDT = 72
// elements (144 bytes): the eight 16-byte rows one ldmatrix phase reads
// fall into distinct banks.
//
// Beside the fragments: the double-buffered cp.async walk over 64-row
// tiles, a key tile's 64-bit mask word read by a warp from global memory
// and a thread's view of it, and the quad reductions of a row's
// statistics. K6 (attention_block_sm90.cuh) and K7
// (flash_attention_sm90.cuh) are built from these; the fp32 attention
// core (attention_core.cuh) reads its K7 mode's mask words with them.
#pragma once

#include "common.cuh"

namespace xclip {
namespace {

constexpr int LDT = 72;  // bf16 row stride of a staged 64-wide tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) . b (16x8, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
}

// Depth slice k (columns [16k, 16k + 16)) of the warp's 16 rows [r0, r0 +
// 16) of a staged tile, as an A operand.
__device__ __forceinline__ void load_a_k(uint32_t (&a)[4], const bf16* tile,
                                         int r0, int k) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (r0 + (lane & 15)) * LDT + 16 * k + (lane >> 4) * 8);
}

// The warp's 16 rows [r0, r0 + 16) of a staged tile as an A operand.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* tile,
                                       int r0) {
#pragma unroll
  for (int k = 0; k < 4; ++k) load_a_k(a[k], tile, r0, k);
}

// Columns [16k, 16k + 16) of the accumulator rounded to bf16, as depth
// slice k of an A operand.
__device__ __forceinline__ void pack_a_k(uint32_t (&a)[4],
                                         const float (&acc)[8][4], int k) {
  a[0] = pack_bf16(acc[2 * k][0], acc[2 * k][1]);
  a[1] = pack_bf16(acc[2 * k][2], acc[2 * k][3]);
  a[2] = pack_bf16(acc[2 * k + 1][0], acc[2 * k + 1][1]);
  a[3] = pack_bf16(acc[2 * k + 1][2], acc[2 * k + 1][3]);
}

// The accumulator rounded to bf16, as an A operand over its 64 columns.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&acc)[8][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) pack_a_k(a[k], acc, k);
}

// Depth slice k of acc += a . bᵀ: b a staged tile of 64 rows (the output's
// columns) by 64 (the depth), as q . kᵀ. Only the output's first `nc`
// 8-column chunks are computed (a ragged tail's); the rest are untouched.
__device__ __forceinline__ void mma_abt_k(float (&acc)[8][4],
                                          const uint32_t (&a)[4], int k,
                                          const bf16* b, int nc = 8) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    if (2 * np >= nc) break;
    uint32_t r[4];
    ldsm_x4(r, b + (16 * np + (mi >> 1) * 8 + (lane & 7)) * LDT + 16 * k +
                   (mi & 1) * 8);
    mma_bf16(acc[2 * np], a, r[0], r[1]);
    if (2 * np + 1 < nc) mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
  }
}

// acc += a . bᵀ over the whole depth, slice by slice (first `nc` chunks;
// all 8 take a branch-free path).
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const uint32_t (&a)[4][4],
                                        const bf16* b, int nc = 8) {
  if (nc >= 8) {
#pragma unroll
    for (int k = 0; k < 4; ++k) mma_abt_k(acc, a[k], k, b);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) mma_abt_k(acc, a[k], k, b, nc);
  }
}

// Depth slice k of acc += a . b: b a staged tile of 64 rows (the depth) by
// 64 (the output's columns), as p . v.
__device__ __forceinline__ void mma_ab_k(float (&acc)[8][4],
                                         const uint32_t (&a)[4], int k,
                                         const bf16* b) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t r[4];
    ldsm_x4_t(r, b + (16 * k + (mi & 1) * 8 + (lane & 7)) * LDT + 16 * np +
                     (mi >> 1) * 8);
    mma_bf16(acc[2 * np], a, r[0], r[1]);
    mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
  }
}

// acc += a . b over the first `ns` 16-deep slices of the depth (a ragged
// tail's: exact where the rest of a is zero).
__device__ __forceinline__ void mma_ab(float (&acc)[8][4],
                                       const uint32_t (&a)[4][4],
                                       const bf16* b, int ns = 4) {
  if (ns >= 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) mma_ab_k(acc, a[k], k, b);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < ns) mma_ab_k(acc, a[k], k, b);
  }
}

// The number of 8-column chunks (`unit` 8) or 16-deep slices (`unit` 16) of
// a 64-column tile that hold one of its first `cols` columns (0 to 64 / unit).
__device__ __forceinline__ int tile_parts(int cols, int unit) {
  return min(64 / unit, max(0, (cols + unit - 1) / unit));
}

// Stage rows [r0, r0 + 64) of the 64 bf16 columns at `col` of a row-major
// matrix (row stride ld) into a tile, by cp.async from all of the block's
// `threads` threads; rows at or past n, and the tile's columns at or past
// `cols` (a multiple of 8: a head's last half past its true width), read
// as 0. The caller commits.
template <int threads>
__device__ __forceinline__ void stage_tile_async(bf16* tile, const bf16* src,
                                                 long ld, int col, int r0,
                                                 int n, int cols = 64) {
  for (int c = threadIdx.x; c < 64 * 8; c += threads) {
    const int r = c >> 3, d = (c & 7) * 8;
    const bool in = r0 + r < n && d < cols;
    cp_async16(tile + r * LDT + d, src + (in ? (long)(r0 + r) * ld + col + d : 0),
               in);
  }
}

// Write the warp's 16 rows [r0, r0 + 16) of the accumulator, rounded to
// bf16, through its own rows of a staged tile (`stage`, which no other
// warp reads) to rows q0 + r0 + i < n of dst (row stride ld, 16-byte
// stores of the first `cols` of the 64 columns, a multiple of 8).
__device__ __forceinline__ void store_rows(bf16* dst, long ld, int q0, int n,
                                           bf16* stage, int r0,
                                           const float (&acc)[8][4],
                                           int cols = 64) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  __syncwarp();
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(stage + (r0 + g + 8 * h) * LDT + 8 * t +
                                   2 * tq) =
          pack_bf16(acc[t][2 * h], acc[t][2 * h + 1]);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i, r = r0 + (c >> 3), d = (c & 7) * 8;
    if (q0 + r < n && d < cols)
      *reinterpret_cast<uint4*>(dst + (long)(q0 + r) * ld + d) =
          *reinterpret_cast<const uint4*>(stage + r * LDT + d);
  }
}

// cp.async.wait_group with a count known once the caller's loop is unrolled.
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// Walk tiles from `t` to `last` in the order `next` gives (the next tile
// to visit after its argument, or `last`): `stage(t, buf)` issues the
// tile's cp.async copies into buffer buf one tile ahead, `body(t, buf)`
// runs once they have landed; the two buffers alternate. Copies the
// caller issued before the walk without committing them land with the
// first tile's.
template <typename Next, typename Stage, typename Body>
__device__ __forceinline__ void tile_walk(int t, int last, Next next,
                                          Stage stage, Body body) {
  int buf = 0;
  if (t < last) stage(t, 0);
  cp_async_commit();
  while (t < last) {
    const int u = next(t);
    if (u < last) stage(u, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    body(t, buf);
    __syncthreads();
    t = u;
    buf ^= 1;
  }
}

// The 64-bit word of a key tile's 64 mask bytes (bit c: key c valid), in
// every lane of the warp.
__device__ __forceinline__ unsigned long long key_word(const uint8_t* m) {
  const int lane = threadIdx.x & 31;
  const unsigned lo = __ballot_sync(0xffffffffu, m[lane] != 0);
  const unsigned hi = __ballot_sync(0xffffffffu, m[lane + 32] != 0);
  return lo | (unsigned long long)hi << 32;
}

// The first key tile in [t, last) of a mask row with a valid key, or
// `last`: each lane tests 8 mask bytes, four tiles a ballot. The same in
// every lane of the warp.
__device__ __forceinline__ int next_key_tile(const uint8_t* mrow, int t,
                                             int last) {
  const int lane = threadIdx.x & 31;
  for (; t < last; t += 4) {
    const int u = t + (lane >> 3);
    uint2 w = make_uint2(0u, 0u);
    if (u < last)
      w = *reinterpret_cast<const uint2*>(mrow + 64L * u + 8 * (lane & 7));
    const unsigned any = __ballot_sync(0xffffffffu, (w.x | w.y) != 0u);
    if (any) return t + (__ffs(any) - 1) / 8;
  }
  return last;
}

// A thread's view of a 64-key tile's mask word (bit c: key c valid): bits
// (lo, hi) of word >> 2 (lane & 3), so that the key at column 8 c + 2
// (lane & 3) + e of the tile, in the accumulator layout above, is a shift
// by a constant (c and e unrolled).
struct KeyBits {
  uint32_t lo, hi;
  __device__ __forceinline__ KeyBits(unsigned long long w, int tq)
      : lo((uint32_t)(w >> (2 * tq))), hi((uint32_t)(w >> (32 + 2 * tq))) {}
  __device__ __forceinline__ bool operator()(int c, int e) const {
    return ((c < 4 ? lo >> (8 * c + e) : hi >> (8 * (c - 4) + e)) & 1u) != 0;
  }
};

// max and sum over the quad (lanes 4g..4g+3) that holds one accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------------ head widths
//
// A head of dh columns is NH = ⌈dh / 64⌉ staged 64-column halves. The bf16
// kernels (K6, the megablock's core, K7) read it at its true width, the
// columns of the last half past dh zero in shared memory and never stored;
// the fp32 FMA core (attention_core.cuh) takes whole halves at one or two.

constexpr int BF16_MAX_DH = 256;  // the widest head the bf16 kernels take

// The halves of a bf16 head: dh a multiple of 8 from 8 to BF16_MAX_DH; 0
// otherwise.
inline int bf16_halves(int dh) {
  return dh % 8 == 0 && dh >= 8 && dh <= BF16_MAX_DH ? (dh + 63) / 64 : 0;
}

// The halves of an fp32 head: 64 and 128 (NH = 1, 2); 0 otherwise.
inline int f32_halves(int dh) { return dh == 64 ? 1 : dh == 128 ? 2 : 0; }

// Launch a kernel of a head of NH halves as `run` does with FULL true
// where dh is whole halves (dh = 64 NH) at one or two halves: the widths
// the kernels were tuned at (64, 128) then run with dh folded into the
// code. Three and four halves, and partial ones, read dh at run time.
template <int NH, typename Run>
inline int by_width(int dh, Run run) {
  if constexpr (NH <= 2)
    if (dh == 64 * NH) return run(std::true_type{});
  return run(std::false_type{});
}

// Warp groups of a dk/dv kernel (K6's, the megablock's, K7's): at heads of
// three or four halves each thread cannot hold every half's dk and dv (2 x
// 16 x 64 NH / 32 fp32), so two groups of four warps share the 16-key
// slabs, each recomputing s and dp over the whole head and keeping dk and
// dv for two halves.
__host__ __device__ constexpr int dkv_groups(int nh) {
  return nh > 2 ? 2 : 1;
}

// 16 bytes from global memory where `ok`, zeros elsewhere: the dq
// prologues' loads past a head's true width, predicated rather than
// branched around so that a row's loads issue together.
__device__ __forceinline__ uint4 load16_if(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

}  // namespace
}  // namespace xclip
