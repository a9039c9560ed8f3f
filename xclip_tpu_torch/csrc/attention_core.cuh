// The attention core of the attention megablock (K-MEGA, K2, K3:
// csrc/attention_megablock.cu) and of whole-head attention on a fused qkv
// (K6: csrc/attention_block.cu): softmax(q . kᵀ · scale) · v per (batch
// element, head) from the (b·n, 3·heads·D) qkv, D = 64 or 128, and its
// backward; K7's fp32 forward and backward (csrc/flash_attention.cu) run
// the same kernels in a mode of their own.
//
// Cast order (as the Pallas kernels): scores are fp32 (q . k) * scale; keys
// where the mask is 0, and keys past the query when causal, get -inf. With
// maybe_dead a row with no valid key gets m = 0 and p = 1 on every column
// (uniform weights over the n real keys). l = max(sum p, 1e-30); p / l is
// cast to the storage dtype before p @ v (fp32 accumulation), and the head
// outputs are cast to the storage dtype. Head h takes q from columns
// [h*D, (h+1)*D) of a row, k from hd + h*D and v from 2*hd + h*D.
//
// bf16 runs on the kernels of attention_block_sm90.cuh: K6 in
// their K6 mode, the megablock in their megablock mode (launch_attention
// and launch_mega_attention_bwd below); their notes give the design and
// what bounds it. What follows is the fp32 path, which the tests, the fp32
// goldens and every fp32 tower pass (the SimSiam / SimCLR views) run.
//
// Forward: one kernel, one block per (64-query tile, head, batch element),
// an online softmax over the 64-key tiles in registers (per row a running
// max m and sum l, o rescaled by e^(m_old - m_new) when m grows; a dead
// row's m is 0 and its p 1). Skipped tiles hold no valid key of the
// block's rows, so the final m is each row's true maximum, which the
// backward rebuilds p from. The row statistics go out as the megablock's
// (m, l) pair per head (`sm`) or as K6's log-sum-exp m + log l (`lse`), or
// not at all, and o / l is stored once at the end. K7's lse is m_safe +
// log l, m_safe 0 where m = -inf (the Pallas `_fwd_kernel`'s): a row with
// no valid key keeps m = -inf, p = 0 and l = 0 on every tile, and gives
// out 0 and lse log 1e-30.
//
// Backward: two kernels, each owning its outputs (no atomics; two runs
// agree bit for bit): a query-tile kernel gives delta (into the `delta`
// scratch) and dq, a key-tile kernel recomputes s and dp for its keys and
// gives dk and dv. p is rebuilt from the forward's statistics (not
// re-reduced): the megablock's p = (dead ? 1 : exp(s - m)) / l, K6's p =
// exp(s - lse) and 1/n on a dead row. The row cotangent do (`dattn`) is the
// megablock's dattn or K6's do. The megablock puts the softmax scale on do
// (dp = do * scale · vᵀ, here do · vᵀ times the scale, the same bits where
// the scale is a power of two as 64^-0.5 is; delta = scale · Σ do ·
// attnout, ds = p (dp - delta)); K6 applies it to ds as `_bwd_kernel` does
// (dp = do · vᵀ, delta = Σ do · out, ds = p (dp - delta) scale). Then ds
// is zeroed on dead rows; dq = ds · k, dk = dsᵀ · q, dv = pᵀ · do.
// K7's mode (kK7), forward and backward, is K6's with scale 1 (its q comes
// pre-scaled) and no dead-row rule (a K7 row with no valid key has lse =
// log 1e-30 and p 0 on every key), on separate (b·h, n, D) q, k, v, out,
// do and dq, dk, dv (one head, row stride D) and a (b·h, n) mask, with no
// length limit: each warp reads a key tile's mask word from global memory
// as it walks it (mma_tiles.cuh's key_word, next_key_tile) instead of
// keeping every tile's word in shared memory.
//
// What bounds them on the card: the FMAs. The backward makes seven 64-deep
// products of a (query, key) pair where the bound counts five (s and dp
// are made in both kernels), the forward two, at 67 TFLOP/s; the bytes (q,
// k, v, out, do and the statistics read, the outputs written) are a tenth
// of that time at the flagship's shapes. The design, as the bf16 kernels'
// (their notes) with fp32 FMAs in place of mma.sync:
//   * a block is 64 queries (forward, dq) or 64 keys (dk/dv) x one head x
//     one batch element, 256 threads (K7's mode: on a 1-D grid, b·h x
//     tiles, as its b·h grows past the grid's 65,535 on y and z); the
//     other side's 64-row tiles (k
//     and v; q and do) stream once through a double-buffered cp.async ring
//     of 16-byte copies (tile_walk), no score row is kept whole, so n is
//     bounded by the mask words (2048; K7's mode: not at all), not by
//     shared memory;
//   * each thread owns a 4 x 4 register tile of every 64 x 64 product
//     (rows 4 ty + i, columns tx + 16 j) and reads its operands as 16-byte
//     shared loads, 8 per 64 FMAs, each quarter warp's load one 128-byte
//     wavefront; tiles are unpadded 16 KB, their 16-byte chunks swizzled
//     by row (`swz`) so that no load or p / ds store of a warp meets a bank
//     conflict. The backward's warp is 4 rows of threads by 8 columns; the
//     forward's is 2 rows by 16, so that a row's 16 threads share a warp
//     and its running max and sum reduce by shuffles,
//     and the p tile's rows a warp reads are its own (a warp barrier, not a
//     block one, between p and o += p · v);
//   * s (forward), s and dp (backward) of a tile stay in registers, p and
//     ds are formed there and pass through one tile as the A operand of o
//     += p · v, dq += ds · k, dv += pᵀ · do, dk += dsᵀ · q, whose sums stay
//     in registers: six 16 KB tiles a forward block (q, two k, two v, p),
//     seven a backward block, two blocks an SM either way: 128 registers
//     a thread fill the register file at two, and a third block would
//     need 293 KB (forward) or 342 KB (backward) of the SM's 228 KB of
//     shared memory;
//   * the mask is read once into one 64-bit word per key tile (K7's mode:
//     each warp reads a tile's word as it walks it); key tiles
//     above the causal diagonal and with no valid key are skipped
//     (forward, dq), and so are query tiles wholly before the key tile
//     under causal (dk/dv), except where dead rows reach them (a dead row's
//     p reaches every key: the forward walks every key tile for a block
//     holding one, and dk/dv every query tile holding one). Below the tile,
//     a warp runs no product when its rows lie at or past n; in the forward
//     and dq its key columns stop (in groups of 16) at the tile's last
//     valid key and, causal, at its last row; in dk/dv its query columns
//     stop at n, and 16 keys none of which is valid run nothing on a query
//     tile without a dead row;
//   * every element of the outputs is written: a skipped tile leaves its
//     sums 0.
// tools/f32_attention_variants.py times the register tile (4 x 8 a
// thread), one block an SM (p and ds in two tiles), the backward's expf
// in place of ex2.approx, the forward's rows split over two warps (their
// max and sum exchanged through shared memory: tools/fwd_exchange.patch),
// the forward's expf (tools/fwd_expf.patch), in every mode (K7's too),
// against the shipped choices (PERF.md).
//
// A head of 128 (NH = 2, every mode) is two 64-column halves, each a tile
// of its own, and a block of two 256-thread halves (threadIdx.y), each the
// NH = 1 thread layout and owning one column half of the outputs, so that
// a thread's sums stay at NH = 1's 4 x 4 of each product and 128
// registers, and an SM holds one 512-thread block: 16 warps, as two
// blocks at 64. Each half stages its own columns of the operands.
//   * forward: each half's warp computes its half's partial scores, the
//     two warps holding the same rows exchange them through a tile each
//     (a named barrier of the pair), and both add s0 + s1 (the same bits
//     in either), so both form the same row max, sum and p; each writes p
//     over the partial it read and multiplies it by its own v columns: 12
//     tiles (192 KB);
//   * backward: the dq kernel's half 0 makes s = q . kᵀ and half 1 dp = do
//     . vᵀ, each over the whole head in one chain (the gradients bit for
//     bit those of the one-block design this replaced); dp reaches half 0
//     through the ds tile, where half 0 writes ds over it; each half then
//     adds ds . k of its columns: 13 tiles (208 KB). The dk/dv kernel's
//     half 0 makes p into the p tile, half 1 dpᵀ into the ds tile, half 0
//     forms ds there, and each half keeps its columns of dv and dk: 14
//     tiles (224 KB).
// tools/f32_attention_variants.py times the one-block design it replaces
// (256 threads holding both halves' sums, 8 warps an SM:
// tools/nh2_one_block.patch) against it at heads of 128 (PERF.md).
#pragma once

#include "attention_block_sm90.cuh"

namespace {

constexpr int DH = 64;  // a tile's columns: a head is DH NH

// The row statistics of query q, head h: the megablock's (m, l) in sm,
// (b*n) x (2*heads) with m at column h and l at heads + h; K6's lse,
// (b*n) x heads.
__device__ __forceinline__ void store_row_stats(float* sm, float* lse, int bi,
                                                int n, int q, int h,
                                                int heads, float m, float l) {
  const long row = (long)bi * n + q;
  if (sm) {
    sm[row * 2 * heads + h] = m;
    sm[row * 2 * heads + heads + h] = l;
  }
  if (lse) lse[row * heads + h] = m + logf(l);
}

// The fp32 kernels' modes: the megablock's (m, l) statistics; K6's lse;
// K7's lse on separate (b·h, n, D) tensors, no dead-row rule and no
// length limit (the mask words read per tile from global memory).
enum CoreMode : int { kMega = 0, kK6 = 1, kK7 = 2 };

// The tiles hold 64 rows of 64 fp32 (a head's q, k, v or do rows, or a 64
// x 64 block of p or ds), 16 KB, unpadded. The 16-byte chunk c of row r
// sits at chunk c ^ swz(r) (`swz`): the rows a warp reads at one chunk
// fall into distinct banks.
constexpr int BT = 64 * DH;  // floats of a tile
// The register tile: a thread owns 4 rows and kBwdTN columns of each 64 x
// 64 product (4 x kBwdTN fp32 sums), rows 4 ty + i and columns tx + TX j,
// TX = 64 / kBwdTN threads along the columns, 16 rows of threads: 4096 /
// (4 kBwdTN) threads a block. The backward's warp is 4 rows of threads by
// 8 columns (`thr_tx`, `thr_ty`), TX / 8 warps side by side: its 16 rows
// of a product are contiguous.
constexpr int kBwdTN = 4;
constexpr int kBwdTX = 64 / kBwdTN;
constexpr int kBwdThreads = 16 * kBwdTX;
// The dk/dv kernel's p and ds tiles: 1, one tile that takes p, then ds
// (seven tiles a block, two blocks an SM); 2, a tile each (one block).
constexpr int kBwdPTiles = 1;
constexpr int kBwdBlocks = kBwdPTiles == 1 ? 2 : 1;  // blocks an SM
// The backward's e^(x - m): K6's 2^(x log2 e - m log2 e) on ex2.approx
// (true; a few fp32 ulps from expf, well inside the 1e-4 gate), or expf
// (false). The forward's is always ex2.approx.
constexpr bool kBwdEx2 = true;
// The dk/dv kernel's p and ds tiles at a head of DH NH: at 128 always two
// (p; dp from the other half, then ds).
template <int NH>
constexpr int kDkvPTiles = NH == 1 ? kBwdPTiles : 2;
// shared memory at a head of DH NH columns
template <int NH = 1>
constexpr size_t kBwdDqSmem =
    sizeof(float) * ((6 * NH + 1) * BT + 3 * 64) + 8 * xclip::K6_MAX_TILES;
template <int NH = 1>
constexpr size_t kBwdDkvSmem = sizeof(float) *
    ((6 * NH + kDkvPTiles<NH>) * BT + 3 * 64) + 8 * xclip::K6_MAX_TILES;
template <int NH = 1>
constexpr size_t kFwdSmem =
    sizeof(float) * 6 * NH * BT + 8 * xclip::K6_MAX_TILES;
// a block's threads at NH: a 256-thread half a 64-column half (threadIdx.y)
template <int NH>
constexpr int kThreads = kBwdThreads * NH;
// blocks an SM at NH: 16 warps either way (two at 64; one of 512 threads
// at 128)
template <int NH>
constexpr int kBlocks = NH == 1 ? 2 : 1;

template <bool EX2>
__device__ __forceinline__ float core_exp(float x, float m) {
  if constexpr (EX2)
    return xclip::k6_exp(x, m);
  else
    return expf(x - m);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The thread's column (tx) and row (ty) of threads: RW, a warp 2 rows of
// threads by TX columns (32 / TX rows); else 4 rows by 8 columns, TX / 8
// warps side by side.
template <bool RW = false>
__device__ __forceinline__ int thr_tx() {
  if constexpr (RW) return threadIdx.x % kBwdTX;
  return (threadIdx.x & 7) + 8 * ((threadIdx.x >> 5) % (kBwdTX / 8));
}
template <bool RW = false>
__device__ __forceinline__ int thr_ty() {
  if constexpr (RW) return threadIdx.x / kBwdTX;
  return ((threadIdx.x & 31) >> 3) + 4 * ((threadIdx.x >> 5) / (kBwdTX / 8));
}
// The rows of a product a warp holds, and the first of them.
template <bool RW = false>
constexpr int kWarpRows = RW ? 4 * (32 / kBwdTX) : 16;
template <bool RW = false>
__device__ __forceinline__ int warp_row0() {
  const int warp = threadIdx.x >> 5;
  return RW ? kWarpRows<true> * warp : 16 * (warp / (kBwdTX / 8));
}

// A block's (batch element, head, tile): kMega, kK6 on the grid (tiles,
// heads, b); kK7 (one head) on a 1-D grid of b·h x tiles, the tiles of one
// b·h row adjacent (its b·h grows with the batch, past the 65,535 blocks
// of the grid's y and z).
template <int MODE>
struct CoreBlock {
  int bi, h, t;
  __device__ __forceinline__ explicit CoreBlock(int tiles) {
    if constexpr (MODE == kK7) {
      t = blockIdx.x % tiles;
      bi = blockIdx.x / tiles;
      h = 0;
    } else {
      t = blockIdx.x;
      h = blockIdx.y;
      bi = blockIdx.z;
    }
  }
};

// The launch grid of CoreBlock<MODE> (kMega, kK6: b at most 65,535); a
// zero x when it does not fit.
template <int MODE>
dim3 core_grid(int b, int n, int heads) {
  const long tiles = (n + 63) / 64;
  if (MODE == kK7)
    return dim3(tiles * b <= 0x7fffffffL ? (unsigned)(tiles * b) : 0u);
  return dim3(b <= 65535 ? (unsigned)tiles : 0u, heads, b);
}

// The chunk swizzle of tile row r: distinct for 8 consecutive rows from a
// multiple of 8 (a quarter warp's B rows tx + TX j), and for rows 4 apart
// from 4 ty (its 4 A rows 4 ty + i): the low 3 bits of r, bit 1 flipped by
// bit 3.
__device__ __forceinline__ int swz(int r) { return (r & 7) ^ ((r >> 2) & 2); }

// Rows [r0, r0 + 64) of the 64 fp32 columns at `col` of a row-major matrix
// (row stride ld) into a tile, by cp.async (16-byte copies) from the
// block's threads; rows at or past n read as 0. The caller commits.
__device__ __forceinline__ void stage_f32(float* tile, const float* src,
                                          long ld, int col, int r0, int n) {
  for (int c = threadIdx.x; c < 64 * 16; c += kBwdThreads) {
    const int r = c >> 4, ch = c & 15;
    const bool in = r0 + r < n;
    xclip::cp_async16(tile + r * 64 + ((ch ^ swz(r)) << 2),
                      src + (in ? (long)(r0 + r) * ld + col + 4 * ch : 0), in);
  }
}

// The thread's 8 row pointers of a tile's rows 4 ty + i: swz(4 ty + i) =
// i ^ swz(4 ty), so chunk c of the row sits at 8 hi + (lo ^ swz(4 ty))
// for c ^ i = 8 hi + lo, and base[lo] + 64 i + 32 hi is its first float.
__device__ __forceinline__ void row_bases(const float* (&base)[8],
                                          const float* tile, int ty) {
#pragma unroll
  for (int lo = 0; lo < 8; ++lo)
    base[lo] = tile + 4 * ty * 64 + ((lo ^ swz(4 * ty)) << 2);
}

// acc[i][j] = a[4 ty + i] . b[tx + TX j] over the 64 columns (q . kᵀ, do .
// vᵀ and, in the dk/dv kernel, k . qᵀ, v . doᵀ), for the first NJ column
// groups j (the rest hold no key or query of the tile and are left
// alone); one FMA chain an element, in column order. ACC: acc += instead.
template <int NJ, bool RW = false, bool ACC = false>
__device__ __forceinline__ void tile_abt(float (&acc)[4][kBwdTN],
                                         const float* a, const float* b) {
  constexpr int TX = kBwdTX;
  const int tx = thr_tx<RW>(), ty = thr_ty<RW>();
  const float* pa[8];
  row_bases(pa, a, ty);
  // rows tx + TX j: chunk c at c ^ swz(tx + TX j), which for TX 16 is
  // swz(tx) and for TX 8 depends on j's parity too
  constexpr int PAR = TX == 8 ? 2 : 1;
  const float* pb[PAR][8];
#pragma unroll
  for (int par = 0; par < PAR; ++par)
#pragma unroll
    for (int lo = 0; lo < 8; ++lo)
      pb[par][lo] = b + tx * 64 + ((lo ^ swz(tx + TX * par)) << 2);
  if constexpr (!ACC) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 1
  for (int hi = 0; hi < 2; ++hi) {  // halves of the depth
#pragma unroll
    for (int lo = 0; lo < 8; ++lo) {
      float4 av[4], bv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = lds4(pa[lo ^ i] + 64 * i + 32 * hi);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        bv[j] = lds4(pb[j % PAR][lo] + 64 * TX * j + 32 * hi);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float s = fmaf(av[i].x, bv[j].x, acc[i][j]);
          s = fmaf(av[i].y, bv[j].y, s);
          s = fmaf(av[i].z, bv[j].z, s);
          acc[i][j] = fmaf(av[i].w, bv[j].w, s);
        }
    }
  }
}

// acc[i][4 g + e] += Σ_kk p[4 ty + i][kk] b[kk][4 (tx + TX g) + e] over
// the first 4 NC keys kk of a p or ds tile (p . v, ds . k, pᵀ . do, dsᵀ .
// q), in key order.
template <int NC, bool RW = false>
__device__ __forceinline__ void tile_ab(float (&acc)[4][kBwdTN],
                                        const float* p, const float* b) {
  constexpr int TX = kBwdTX;
  const int tx = thr_tx<RW>(), ty = thr_ty<RW>();
  const float* pa[8];
  row_bases(pa, p, ty);
  // row kk of b, chunk tx + TX g, sits at TX g + (tx ^ swz(kk))
  const float* pb[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) pb[v] = b + ((tx ^ v) << 2);
#pragma unroll
  for (int c = 0; c < NC; ++c) {  // keys 4 c .. 4 c + 3
    float4 av4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = c ^ i;
      av4[i] = lds4(pa[v & 7] + 64 * i + 32 * (v >> 3));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = 4 * c + u;
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = u == 0 ? av4[i].x : u == 1 ? av4[i].y : u == 2 ? av4[i].z
                                                                : av4[i].w;
#pragma unroll
      for (int g = 0; g < kBwdTN / 4; ++g) {
        const float4 bv = lds4(pb[swz(kk)] + kk * 64 + 4 * TX * g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g] = fmaf(av[i], bv.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(av[i], bv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(av[i], bv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(av[i], bv.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// tile_abt over a head of NH tiles (tile hh at `a + hh * BT`, `b + hh *
// BT`): one FMA chain an element over the halves in order (NH 2: a loop,
// one half's row pointers live at a time).
template <int NH, int NJ, bool RW = false>
__device__ __forceinline__ void head_abt(float (&acc)[4][kBwdTN],
                                         const float* a, const float* b) {
  if constexpr (NH == 1) {
    tile_abt<NJ, RW>(acc, a, b);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int half = 0; half < NH; ++half)
      tile_abt<NJ, RW, true>(acc, a + half * BT, b + half * BT);
  }
}

// At NH = 2: warp w of each half (the two warps holding the same rows of
// every product) meet at named barrier 1 + w.
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync %0, 64;" ::"r"(1 + (threadIdx.x >> 5)) : "memory");
}

// The thread's half of the head at NH (threadIdx.y; 0 at NH = 1).
template <int NH>
__device__ __forceinline__ int head_half() {
  return NH == 1 ? 0 : (int)threadIdx.y;
}

// f(integral_constant<k>) for the smallest k in 1..N with k >= m (N if m
// >= N): a product's live column groups as a constant.
template <int N, typename F>
__device__ __forceinline__ void with_groups(int m, F&& f) {
  if constexpr (N > 1) {
    if (m < N) return with_groups<N - 1>(m, f);
  }
  f(std::integral_constant<int, N>{});
}

// Element (4 ty + i, tx + TX j) of a p or ds tile.
template <bool RW = false>
__device__ __forceinline__ float& tile_at(float* tile, int i, int j) {
  const int r = 4 * thr_ty<RW>() + i, c = thr_tx<RW>() + kBwdTX * j;
  return tile[r * 64 + (((c >> 2) ^ swz(r)) << 2) + (c & 3)];
}

// Rows 4 ty + i of a (64 x 64) output tile from registers to rows r0 + 4
// ty + i < n of dst (row stride ld), 16-byte stores.
template <bool RW = false>
__device__ __forceinline__ void store_tile(float* dst, long ld, int r0, int n,
                                           const float (&acc)[4][kBwdTN]) {
  constexpr int TX = kBwdTX;
  const int tx = thr_tx<RW>(), ty = thr_ty<RW>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= n) continue;
#pragma unroll
    for (int g = 0; g < kBwdTN / 4; ++g)
      *reinterpret_cast<float4*>(dst + (long)r * ld + 4 * (tx + TX * g)) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]);
  }
}

// v reduced with `op` (max or sum) over the TX threads of each row of
// threads in the forward's warp shape (a row's threads in one warp), by
// shuffles, the same in each of them. The sum's order is fixed: two runs
// agree bit for bit.
template <typename Op>
__device__ __forceinline__ void row_reduce(float (&v)[4], Op op) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = kBwdTX / 2; o > 0; o >>= 1)
      v[i] = op(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
}

// The walk's mask: WORDS (kMega, kK6), one 64-bit word per key tile of the
// batch element in shared memory (k6_key_tiles, at most K6_MAX_TILES
// tiles), and its first valid key; else (kK7, n a multiple of 64) each
// tile's word read by each warp from global memory as it walks it, and the
// next tile with a valid key found so (no length limit, no dead rows).
// The words are read by the block's kThreads<NH> threads.
template <int MODE, int NH = 1>
struct KeyTiles {
  static constexpr bool WORDS = MODE != kK7;
  const uint8_t* mrow;
  unsigned long long* bits;
  int fv;  // the first valid key (WORDS), else n
  __device__ __forceinline__ KeyTiles(unsigned long long* b,
                                      const uint8_t* m, int n)
      : mrow(m), bits(b), fv(n) {
    if constexpr (WORDS && NH == 1)
      fv = xclip::k6_key_tiles<kBwdThreads>(bits, m, n);
    else if constexpr (WORDS)
      fv = xclip::k6_key_tiles<kThreads<NH>>(
          bits, m, n, (threadIdx.x >> 5) + kBwdThreads / 32 * threadIdx.y);
  }
  __device__ __forceinline__ unsigned long long word(int t) const {
    if constexpr (WORDS)
      return bits[t];
    else
      return xclip::key_word(mrow + 64 * t);
  }
  // the first tile after t, below last, with a valid key (or last)
  __device__ __forceinline__ int next(int t, int last) const {
    if constexpr (WORDS) {
      for (++t; t < last && !bits[t]; ++t) {
      }
      return t;
    } else {
      return xclip::next_key_tile(mrow, t + 1, last);
    }
  }
};

// ------------------------------------------------------------- forward

// attnout (b*n x hd) from q, k, v (row stride ld, head h at column h*64),
// one block per (64-query tile, head, batch element), the last query
// tiles (the most key tiles when causal) first; the rows' statistics into
// `stats`: the megablock's (m, l) (kMega; or none, null), K6's lse (kK6)
// or K7's (kK7: m_safe + log l, one head, q pre-scaled). Heads of DH NH,
// kThreads<NH> threads.
template <int MODE, int NH>
__global__ void __launch_bounds__(kThreads<NH>, kBlocks<NH>)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, long ld,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ attnout, float* __restrict__ stats,
                     int n, int heads, float scale, int causal,
                     int maybe_dead) {
  using namespace xclip;
  constexpr bool RW = true;  // the warp shape: a row's threads in one warp
  constexpr int TX = kBwdTX, D = DH * NH, HT = NH * BT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + HT;      // two buffers
  float* vs = ks + 2 * HT;  // two buffers
  // p; NH 2: tile hh takes half hh's partial scores, then the other
  // half's p
  float* ps = vs + 2 * HT;
  auto* bits = reinterpret_cast<unsigned long long*>(ps + NH * BT);
  if constexpr (MODE == kK7) {  // one head, q pre-scaled
    heads = 1;
    ld = D;
    scale = 1.f;
    maybe_dead = 0;
  }
  const int tiles = (n + 63) / 64;
  const CoreBlock<MODE> blk(tiles);
  const int q0 = 64 * (tiles - 1 - blk.t), h = blk.h, bi = blk.bi;
  const int hd = heads * D;
  const long rows = (long)bi * n;
  const int tx = thr_tx<RW>(), ty = thr_ty<RW>();
  // the thread's column half: its q, k, v and o columns; its p tile
  const int hh = head_half<NH>();
  float* pt = ps + (NH - 1 - hh) * BT;

  // the walked rows' bases (the head's first column)
  const float* kb = k + rows * ld + h * D;
  const float* vb = v + rows * ld + h * D;
  auto stage = [&](int t, int buf) {
    stage_f32(ks + buf * HT + hh * BT, kb, ld, DH * hh, 64 * t, n);
    stage_f32(vs + buf * HT + hh * BT, vb, ld, DH * hh, 64 * t, n);
  };
  // q lands with the first key tile's copies (tile_walk)
  stage_f32(qs + hh * BT, q + rows * ld, ld, h * D + DH * hh, q0, n);
  const KeyTiles<MODE, NH> keys(bits, mask + rows, n);
  const int fv = keys.fv;
  // a row below `dead_end` has no valid key (maybe_dead): m = 0 and p = 1
  // on every real key, so a block holding one walks every key tile
  const int dead_end =
      maybe_dead ? (causal ? min(fv, n) : (fv >= n ? n : 0)) : 0;
  const bool bdead = q0 < dead_end;
  const int last = bdead || !causal ? tiles : min(tiles, q0 / 64 + 1);
  auto next = [&](int t) { return bdead ? t + 1 : keys.next(t, last); };
  // the warp's rows: none at or past n runs a product (the warp still
  // joins the barriers); a warp holding a dead row reads every real key,
  // the others no key past their last row (causal)
  const int row0 = q0 + warp_row0<RW>();
  const bool wlive = row0 < n, wdead = row0 < dead_end;
  const int kend = causal ? min(n, row0 + kWarpRows<RW>) : n;
  const int r0 = q0 + 4 * ty;  // the thread's rows r0 + i

  // per row: the running max, this thread's share of the running sum
  float m[4], l[4], o[4][kBwdTN] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  tile_walk(next(-1), last, next, stage, [&](int t, int buf) {
    const unsigned long long word = keys.word(t);
    // the column groups (of TX keys) that hold a key the warp's rows read
    const int cols =
        wdead ? min(64, n - 64 * t)
              : word ? min(kend - 64 * t, 64 - __clzll((long long)word)) : 0;
    const bool wrun = wlive && cols > 0;
    with_groups<kBwdTN>((cols + TX - 1) / TX, [&](auto nj) {
      constexpr int NJ = decltype(nj)::value;
      float s[4][kBwdTN], mt[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) mt[i] = -INFINITY;
      if (wrun) {
        tile_abt<NJ, RW>(s, qs + hh * BT, ks + buf * HT + hh * BT);
        if constexpr (NH == 2) {
          // the head's scores: each half adds the other's partial, the
          // same s0 + s1 in both (the pair's warps see the same cols)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              tile_at<RW>(ps + hh * BT, i, j) = s[i][j];
          pair_sync();
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) s[i][j] += tile_at<RW>(pt, i, j);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int c = tx + TX * j, key = 64 * t + c;
            // a dead row's scores read 0 on every real key (p = 1)
            const bool dead = r0 + i < dead_end;
            const bool valid =
                dead ? key < n
                     : ((word >> c) & 1ull) && !(causal && key > r0 + i);
            s[i][j] = valid ? (dead ? 0.f : s[i][j] * scale) : -INFINITY;
            mt[i] = fmaxf(mt[i], s[i][j]);
          }
      }
      if (wrun) row_reduce(mt, [](float a, float b) { return fmaxf(a, b); });
      if (wrun) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mn = fmaxf(m[i], mt[i]);
          // e^(m_old - m_new): 0 from -inf, exactly 1 where m stays
          const float corr = mn == m[i] ? 1.f : k6_exp(m[i], mn);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float x = s[i][j];
            const float p = x == -INFINITY    ? 0.f
                            : r0 + i < dead_end ? 1.f
                                                : k6_exp(x, mn);
            sum += p;
            tile_at<RW>(pt, i, j) = p;  // NH 2: over the partial read
          }
          l[i] = l[i] * corr + sum;
#pragma unroll
          for (int e = 0; e < kBwdTN; ++e) o[i][e] *= corr;
          m[i] = mn;
        }
      }
      __syncwarp();  // the warp reads only its own rows of p
      if (wrun) tile_ab<NJ * TX / 4, RW>(o, pt, vs + buf * HT + hh * BT);
    });
  });
  cp_async_wait<0>();  // q has landed even if no tile was walked
  row_reduce(l, [](float a, float b) { return a + b; });
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < kBwdTN; ++e) o[i][e] /= li;
    // K7's lse takes m_safe: 0 where the row had no valid key
    const float mi = MODE == kK7 && m[i] == -INFINITY ? 0.f : m[i];
    if (tx == 0 && hh == 0 && r0 + i < n)
      store_row_stats(MODE == kMega ? stats : nullptr,
                      MODE == kMega ? nullptr : stats, bi, n, r0 + i, h,
                      heads, mi, li);
  }
  store_tile<RW>(attnout + rows * hd + h * D + DH * hh, hd, q0, n, o);
}

// A kernel's shared memory (above the 48 KB default) and the SM's largest
// shared-memory carveout.
inline cudaError_t core_setup(const void* kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

template <int MODE, int NH>
int launch_fma_fwd_nh(const float* q, const float* k, const float* v, long ld,
                      const uint8_t* mask, float* attnout, float* stats,
                      dim3 grid, int n, int heads, float scale, int causal,
                      int maybe_dead, cudaStream_t st) {
  const cudaError_t e =
      core_setup((const void*)attention_fwd_kernel<MODE, NH>, kFwdSmem<NH>);
  if (e != cudaSuccess) return (int)e;
  attention_fwd_kernel<MODE, NH>
      <<<grid, dim3(kBwdThreads, NH), kFwdSmem<NH>, st>>>(
      q, k, v, ld, mask, attnout, stats, n, heads, scale, causal,
      maybe_dead);
  XCLIP_CHECK_LAUNCH();
  return 0;
}

// fp32: attnout (b*n x heads*dh) from q, k, v (row stride ld, head h at
// column h*dh, dh 64 or 128) and the rows' statistics into `stats`
// (kMega: the megablock's sm, or none; kK6, kK7: lse). The tiles are
// copied 16 bytes at a time: every pointer 16-byte aligned. kMega, kK6: n
// at most K6_MAX_N (the mask words); kK7: one head, ld = dh, n a multiple
// of 64, no dead rows, any length, the mask 8-byte aligned.
template <int MODE>
int launch_fma_fwd(const float* q, const float* k, const float* v, long ld,
                   const uint8_t* mask, float* attnout, float* stats, int b,
                   int n, int heads, int dh, float scale, int causal,
                   int maybe_dead, cudaStream_t st) {
  using xclip::aligned16;
  const dim3 grid = core_grid<MODE>(b, n, heads);
  const int nh = xclip::f32_halves(dh);
  const bool shape_ok =
      MODE == kK7 ? n % 64 == 0 && heads == 1 && ld == dh && !maybe_dead
                  : n <= xclip::K6_MAX_N;
  if (!nh || !shape_ok || !grid.x || ld % 4 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(attnout) ||
      (MODE == kK7 && reinterpret_cast<uintptr_t>(mask) % 8))
    return (int)cudaErrorInvalidValue;
  return (nh == 1 ? launch_fma_fwd_nh<MODE, 1> : launch_fma_fwd_nh<MODE, 2>)(
      q, k, v, ld, mask, attnout, stats, grid, n, heads, scale, causal,
      maybe_dead, st);
}

// attnout (b*n x hd, T) from qkv (b*n x 3hd, T), hd = heads * dh; with
// `sm` the rows' (m, l), with `lse` (fp32 only: bf16 K6 launches its own
// kernel) their log-sum-exp. fp32: launch_fma_fwd's limits.
template <typename T>
int launch_attention(const T* qkv, const uint8_t* mask, T* attnout, int b,
                     int n, int heads, int dh, float scale, int causal,
                     int maybe_dead, float* sm, cudaStream_t st,
                     float* lse = nullptr) {
  if constexpr (std::is_same<T, xclip::bf16>::value) {
    return xclip::launch_k6_fwd<true>(qkv, mask, attnout, sm, b, n, heads,
                                      dh, scale, causal, maybe_dead, st);
  } else {
    const int hd = heads * dh;
    auto* launch = lse ? launch_fma_fwd<kK6> : launch_fma_fwd<kMega>;
    return launch(qkv, qkv + hd, qkv + 2 * hd, 3L * hd, mask, attnout,
                  lse ? lse : sm, b, n, heads, dh, scale, causal, maybe_dead,
                  st);
  }
}

// Blocks an SM of the fp32 forward in MODE at heads of DH NH (blocks of
// kThreads<NH> threads), as the occupancy calculator gives them for the
// build's registers and the kernel's shared memory; a negative
// cudaError_t code on failure. A template, so that only a file calling it
// builds the forward.
template <int MODE, int NH>
int attention_fwd_blocks() {
  const void* fwd = (const void*)attention_fwd_kernel<MODE, NH>;
  int blocks = 0;
  cudaError_t e = core_setup(fwd, kFwdSmem<NH>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fwd,
                                                      kThreads<NH>,
                                                      kFwdSmem<NH>);
  return e == cudaSuccess ? blocks : -(int)e;
}

// ------------------------------------------------------------ backward

// dq and delta, one block per (64-query tile, head, batch element), the
// last query tiles (the most key tiles when causal) first. q, k, v with
// row stride ld, head h at column h*64; `dattn` the row cotangents (b*n x
// hd); `attnout` the forward's attention output (b*n x hd); `stats` the
// forward's row statistics (K6's and K7's lse; the megablock's (m, l)).
// Writes delta into its scratch for the dk/dv kernel, dq (row stride ld).
// Heads of DH NH, kThreads<NH> threads.
template <int MODE, int NH>
__global__ void __launch_bounds__(kThreads<NH>, kBlocks<NH>)
attention_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, long ld,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ dattn,
                        const float* __restrict__ attnout,
                        const float* __restrict__ stats,
                        float* __restrict__ dq, float* __restrict__ delta,
                        int n, int heads, float scale, int causal,
                        int maybe_dead) {
  using namespace xclip;
  constexpr bool LSE = MODE != kMega;
  constexpr int TX = kBwdTX, D = DH * NH, HT = NH * BT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + HT;
  float* ks = dos + HT;      // two buffers
  float* vs = ks + 2 * HT;   // two buffers
  float* dss = vs + 2 * HT;  // ds
  // the tile's rows: delta, m (K6, K7: lse) and 1 / l (K6, K7: 1)
  float* rdelta = dss + BT;
  float* rmax = rdelta + 64;
  float* rlinv = rmax + 64;
  auto* bits = reinterpret_cast<unsigned long long*>(rlinv + 64);
  if constexpr (MODE == kK7) {  // one head, q pre-scaled
    heads = 1;
    ld = D;
    scale = 1.f;
    maybe_dead = 0;
  }
  const int tiles = (n + 63) / 64;
  const CoreBlock<MODE> blk(tiles);
  const int q0 = 64 * (tiles - 1 - blk.t), h = blk.h, bi = blk.bi;
  const int hd = heads * D;
  const long rows = (long)bi * n;
  const int tx = thr_tx(), ty = thr_ty();
  // the megablock folds the softmax scale into dp and delta, K6 into ds
  const float dscale = LSE ? 1.f : scale;
  // the thread's column half: the operand columns it stages, its dq's
  const int hh = head_half<NH>();

  // the walked rows' bases (the head's first column)
  const float* kb = k + rows * ld + h * D;
  const float* vb = v + rows * ld + h * D;
  auto stage = [&](int t, int buf) {
    stage_f32(ks + buf * HT + hh * BT, kb, ld, DH * hh, 64 * t, n);
    stage_f32(vs + buf * HT + hh * BT, vb, ld, DH * hh, 64 * t, n);
  };
  stage_f32(qs + hh * BT, q + rows * ld, ld, h * D + DH * hh, q0, n);
  stage_f32(dos + hh * BT, dattn + rows * hd, hd, h * D + DH * hh, q0, n);
  cp_async_commit();
  const KeyTiles<MODE, NH> keys(bits, mask + rows, n);
  const int fv = keys.fv;
  // a dead row's ds is 0: only key tiles with a valid key up to the
  // diagonal
  const int last = causal ? min(tiles, q0 / 64 + 1) : tiles;
  auto next = [&](int t) { return keys.next(t, last); };
  const int first = next(-1);
  cp_async_wait<0>();  // q, do
  __syncthreads();
  // delta = Σ do · out (the megablock: scale Σ dattn · attnout), G threads
  // a row, in column order within a thread, then summed over the G (NH 2:
  // half 0's threads)
  if (hh == 0) {
    constexpr int G = kBwdThreads / 64, CH = 16 / G;
    const int r = threadIdx.x / G, part = threadIdx.x % G, qi = q0 + r;
    float acc = 0.f;
    if (qi < n) {
#pragma unroll
      for (int half = 0; half < NH; ++half) {
        const float* orow = attnout + (rows + qi) * hd + h * D + DH * half;
        const float* drow = dos + half * BT + r * 64;
#pragma unroll
        for (int c = part * CH; c < (part + 1) * CH; ++c) {
          const float4 o = *reinterpret_cast<const float4*>(orow + 4 * c);
          const float4 d = lds4(drow + ((c ^ swz(r)) << 2));
          acc += d.x * o.x * dscale;
          acc += d.y * o.y * dscale;
          acc += d.z * o.z * dscale;
          acc += d.w * o.w * dscale;
        }
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (part == 0) {
      const long row = rows + qi;
      rdelta[r] = acc;
      rmax[r] = 0.f;
      rlinv[r] = 1.f;
      if (qi < n) {
        delta[row * heads + h] = acc;
        rmax[r] = LSE ? stats[row * heads + h] : stats[row * 2 * heads + h];
        if (!LSE) rlinv[r] = 1.f / stats[row * 2 * heads + heads + h];
      }
    }
  }
  __syncthreads();
  // the warp's 16 rows: none at or past n runs a product (the warp still
  // joins the barriers); no key past the last row (causal)
  const int row0 = q0 + warp_row0();
  const bool wlive = row0 < n;
  const int kend = causal ? min(n, row0 + 16) : n;

  float dqa[4][kBwdTN] = {};
  tile_walk(first, last, next, stage, [&](int t, int buf) {
    const float* kt = ks + buf * HT;
    const float* vt = vs + buf * HT;
    const unsigned long long word = keys.word(t);
    // the column groups (of TX keys) that hold a key the warp's rows read:
    // up to the tile's last valid key and, causal, the warp's last row
    const int cols = min(kend - 64 * t, 64 - __clzll((long long)word));
    const int groups = (cols + TX - 1) / TX;
    if (wlive)
      with_groups<kBwdTN>(groups, [&](auto nj) {
        constexpr int NJ = decltype(nj)::value;
        float s[4][kBwdTN], dp[4][kBwdTN];
        if constexpr (NH == 1) {
          head_abt<NH, NJ>(s, qs, kt);
          head_abt<NH, NJ>(dp, dos, vt);
        } else {
          // half 0 makes s, half 1 dp into s (each over the whole head);
          // dp reaches half 0 through the ds tile, where half 0 puts ds
          head_abt<NH, NJ>(s, hh ? dos : qs, hh ? vt : kt);
          if (hh) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < NJ; ++j) tile_at(dss, i, j) = s[i][j];
          }
          pair_sync();
          if (hh) return;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // the row's terms; a dead row's ds is 0
          const int r = 4 * ty + i, qi = q0 + r;
          const bool live = qi < n &&
                            !(maybe_dead && (causal ? fv > qi : fv >= n));
          const float rm = rmax[r], rl = rlinv[r], rd = rdelta[r];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int c = tx + TX * j;
            const bool valid = live && ((word >> c) & 1ull) &&
                               !(causal && 64 * t + c > qi);
            float ds = 0.f;
            if (valid) {
              float p = core_exp<kBwdEx2>(s[i][j] * scale, rm);
              if (!LSE) p *= rl;
              const float dpv = NH == 1 ? dp[i][j] : tile_at(dss, i, j);
              ds = LSE ? p * (dpv - rd) * scale : p * (dpv * scale - rd);
            }
            tile_at(dss, i, j) = ds;
          }
        }
      });
    __syncthreads();
    // dq += ds . k over the same keys (the warp reads only its rows of the
    // ds tile; NH 2: its half's columns of k)
    if (wlive)
      with_groups<kBwdTN>(groups, [&](auto nj) {
        tile_ab<decltype(nj)::value * TX / 4>(dqa, dss, kt + hh * BT);
      });
  });
  store_tile(dq + rows * ld + h * D + DH * hh, ld, q0, n, dqa);
}

// dk and dv, one block per (64-key tile, head, batch element), over the
// query tiles that reach it: from the key tile's on when causal, and
// every tile holding a dead row (its p = 1/n reaches every key). Operands
// as the dq kernel's (delta its output); dk, dv with row stride ld. Heads
// of DH NH, kThreads<NH> threads.
template <int MODE, int NH>
__global__ void __launch_bounds__(kThreads<NH>,
                                  NH == 1 ? kBwdBlocks : kBlocks<NH>)
attention_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, long ld,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ dattn,
                         const float* __restrict__ stats,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int n, int heads, float scale, int causal,
                         int maybe_dead) {
  using namespace xclip;
  constexpr bool LSE = MODE != kMega;
  constexpr int TX = kBwdTX, D = DH * NH, HT = NH * BT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + HT;
  float* qs = vs + HT;        // two buffers
  float* dos = qs + 2 * HT;   // two buffers
  // p, then ds (two tiles: p; ds next, NH 2 after dp)
  constexpr int PT = kDkvPTiles<NH>;
  float* ps = dos + 2 * HT;
  float* dss = ps + (PT - 1) * BT;
  // the walked query tile's row terms: m (K6, K7: lse), 1 / l (K6: 1; 1/n
  // on a dead row) and delta, 64 each
  float* terms = ps + PT * BT;
  auto* bits = reinterpret_cast<unsigned long long*>(terms + 3 * 64);
  if constexpr (MODE == kK7) {  // one head, q pre-scaled
    heads = 1;
    ld = D;
    scale = 1.f;
    maybe_dead = 0;
  }
  const int tiles = (n + 63) / 64;
  const CoreBlock<MODE> blk(tiles);
  const int kt = blk.t, k0 = 64 * kt, h = blk.h, bi = blk.bi;
  const int hd = heads * D;
  const long rows = (long)bi * n;
  const int tx = thr_tx(), ty = thr_ty();
  // the thread's column half: the operand columns it stages, its dk's and
  // dv's
  const int hh = head_half<NH>();

  // the walked rows' bases (the head's first column)
  const float* qb = q + rows * ld + h * D;
  const float* db = dattn + rows * hd + h * D;
  auto stage = [&](int t, int buf) {
    stage_f32(qs + buf * HT + hh * BT, qb, ld, DH * hh, 64 * t, n);
    stage_f32(dos + buf * HT + hh * BT, db, hd, DH * hh, 64 * t, n);
  };
  stage_f32(ks + hh * BT, k + rows * ld, ld, h * D + DH * hh, k0, n);
  stage_f32(vs + hh * BT, v + rows * ld, ld, h * D + DH * hh, k0, n);
  cp_async_commit();
  const KeyTiles<MODE, NH> keys(bits, mask + rows, n);
  const int fv = keys.fv;
  const unsigned long long kw = keys.word(kt);
  // queries below `dead_end` are dead rows
  const int dead_end =
      maybe_dead ? (causal ? min(fv, n) : (fv >= n ? n : 0)) : 0;
  auto next = [&](int t) {
    for (++t; t < tiles; ++t)
      if (64 * t < dead_end || (kw && !(causal && 64 * t + 63 < k0))) break;
    return t;
  };
  const int first = next(-1);
  // the thread's keys k0 + 4 ty + i: valid, and < n (kept apart: fewer
  // spills than one word of their bits)
  int key[4];
  bool kvalid[4], klive[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    key[i] = k0 + 4 * ty + i;
    kvalid[i] = (kw >> (4 * ty + i)) & 1ull;
    klive[i] = key[i] < n;
  }
  // the warp's 16 keys: none at or past n runs a product (the warp still
  // joins the barriers); nor do 16 keys none of which is valid, on a
  // query tile without a dead row (their p and ds are 0)
  const bool wlive = k0 + warp_row0() < n;
  const bool wkeys = (kw >> warp_row0()) & 0xffffull;
  const float inv_n = 1.f / (float)n;
  // term e = 64 w + c (w < 3) is term w of query c of tile u, fetched from
  // global memory by thread e % kBwdThreads (NH 2: of half 0): the next
  // tile's during a tile, stored once the tile's own are read
  constexpr int FT = (3 * 64 + kBwdThreads - 1) / kBwdThreads;  // a thread
  auto fetch = [&](int u, int e) {
    const int w = e >> 6, qi = 64 * u + (e & 63);
    const long row = rows + qi;
    if (w >= 3 || u >= tiles) return 0.f;
    if (qi >= n) return w == 1 ? 1.f : 0.f;
    if (w == 0)
      return LSE ? stats[row * heads + h] : stats[row * 2 * heads + h];
    if (w == 2) return delta[row * heads + h];
    return LSE ? (qi < dead_end ? inv_n : 1.f)
               : 1.f / stats[row * 2 * heads + heads + h];
  };
  if (hh == 0) {
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      const int e = threadIdx.x + f * kBwdThreads;
      if (e < 3 * 64) terms[e] = fetch(first, e);
    }
  }

  float dka[4][kBwdTN] = {}, dva[4][kBwdTN] = {};
  tile_walk(first, tiles, next, stage, [&](int t, int buf) {
    const float* qt = qs + buf * HT;
    const float* dt = dos + buf * HT;
    const bool wrun = wlive && (wkeys || 64 * t < dead_end);
    const int u = next(t);
    float fetched[FT];
    if (hh == 0) {
#pragma unroll
      for (int f = 0; f < FT; ++f)
        fetched[f] = fetch(u, threadIdx.x + f * kBwdThreads);
    }
    with_groups<kBwdTN>((n - 64 * t + TX - 1) / TX, [&](auto nj) {
      constexpr int NJ = decltype(nj)::value;
      const float* cm = terms;
      const float* clinv = terms + 64;
      const float* cd = terms + 128;
      // p (sᵀ = k . qᵀ) into its tile (NH 2: half 0's; half 1 makes dpᵀ =
      // v . doᵀ into the ds tile meanwhile, each over the whole head)
      float a[4][kBwdTN];
      if (wrun) {
        head_abt<NH, NJ>(a, hh ? vs : ks, hh ? dt : qt);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int c = tx + TX * j, qi = 64 * t + c;
            if (hh) {
              tile_at(dss, i, j) = a[i][j];
              continue;
            }
            float num;
            if (qi < dead_end) {
              num = klive[i] ? 1.f : 0.f;  // uniform over the n keys
            } else {
              const bool valid =
                  kvalid[i] && qi < n && !(causal && key[i] > qi);
              num = valid ? core_exp<kBwdEx2>(a[i][j] * scale, cm[c]) : 0.f;
            }
            tile_at(ps, i, j) = num * clinv[c];
          }
      }
      if constexpr (NH == 1) {
        // dv += pᵀ . do; ds (dpᵀ = v . doᵀ) into its tile, then dk += dsᵀ
        // . q
        if constexpr (kBwdPTiles == 1) {
          __syncthreads();
          if (wrun) tile_ab<NJ * TX / 4>(dva, ps, dt);
        }
        if (wrun) {
          head_abt<NH, NJ>(a, vs, dt);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const int c = tx + TX * j, qi = 64 * t + c;
              const float p = tile_at(ps, i, j);  // this thread's own
              float ds = 0.f;
              if (qi >= dead_end && p != 0.f)
                ds = LSE ? p * (a[i][j] - cd[c]) * scale
                         : p * (a[i][j] * scale - cd[c]);
              a[i][j] = ds;
            }
        }
        if constexpr (kBwdPTiles == 1) __syncthreads();  // p read
        if (wrun) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) tile_at(dss, i, j) = a[i][j];
        }
      } else {
        // half 0 puts ds over dpᵀ (p read back: no sums live across the
        // barrier); each half adds pᵀ . do and dsᵀ . q of its columns
        __syncthreads();  // p and dpᵀ in their tiles
        if (wrun && hh == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const int c = tx + TX * j, qi = 64 * t + c;
              const float p = tile_at(ps, i, j), dp = tile_at(dss, i, j);
              float ds = 0.f;
              if (qi >= dead_end && p != 0.f)
                ds = LSE ? p * (dp - cd[c]) * scale
                         : p * (dp * scale - cd[c]);
              tile_at(dss, i, j) = ds;
            }
        }
        if (wrun) tile_ab<NJ * TX / 4>(dva, ps, dt + hh * BT);
      }
      __syncthreads();  // ds made; the tile's terms read
      if (hh == 0) {
#pragma unroll
        for (int f = 0; f < FT; ++f) {
          const int e = threadIdx.x + f * kBwdThreads;
          if (e < 3 * 64) terms[e] = fetched[f];
        }
      }
      if (wrun) {
        if constexpr (NH == 1 && kBwdPTiles == 2)
          tile_ab<NJ * TX / 4>(dva, ps, dt);
        tile_ab<NJ * TX / 4>(dka, dss, qt + hh * BT);
      }
    });
  });
  cp_async_wait<0>();  // k and v have landed even if no tile was walked
  store_tile(dk + rows * ld + h * D + DH * hh, ld, k0, n, dka);
  store_tile(dv + rows * ld + h * D + DH * hh, ld, k0, n, dva);
}

template <int MODE, int NH = 1>
cudaError_t attention_bwd_setup() {
  cudaError_t e = core_setup((const void*)attention_bwd_dq_kernel<MODE, NH>,
                             kBwdDqSmem<NH>);
  return e == cudaSuccess
             ? core_setup((const void*)attention_bwd_dkv_kernel<MODE, NH>,
                          kBwdDkvSmem<NH>)
             : e;
}

// Blocks an SM of the fp32 backward's dq (`which` 0) or dk/dv (1) kernel
// in MODE at heads of DH NH (blocks of kThreads<NH> threads), as the
// occupancy calculator gives them for the build's registers and the
// kernels' shared memory; a negative cudaError_t code on failure.
template <int MODE, int NH>
int attention_bwd_blocks(int which) {
  int blocks = 0;
  cudaError_t e = attention_bwd_setup<MODE, NH>();
  if (e == cudaSuccess)
    e = which == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, attention_bwd_dq_kernel<MODE, NH>,
                         kThreads<NH>, kBwdDqSmem<NH>)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, attention_bwd_dkv_kernel<MODE, NH>,
                         kThreads<NH>, kBwdDkvSmem<NH>);
  return e == cudaSuccess ? blocks : -(int)e;
}

// The fp32 kernels' blocks an SM at head width dh (64 or 128): the
// forward's (`which` -1), the dq kernel's (0) or the dk/dv kernel's (1).
template <int MODE>
int attention_blocks(int which, int dh) {
  const int nh = xclip::f32_halves(dh);
  if (!nh) return -(int)cudaErrorInvalidValue;
  if (which < 0)
    return nh == 1 ? attention_fwd_blocks<MODE, 1>()
                   : attention_fwd_blocks<MODE, 2>();
  return nh == 1 ? attention_bwd_blocks<MODE, 1>(which)
                 : attention_bwd_blocks<MODE, 2>(which);
}

template <int MODE, int NH>
int launch_fma_bwd_nh(const float* q, const float* k, const float* v, long ld,
                      const uint8_t* mask, const float* dattn,
                      const float* attnout, const float* stats, float* dq,
                      float* dk, float* dv, float* delta, dim3 grid, int n,
                      int heads, float scale, int causal, int maybe_dead,
                      cudaStream_t st) {
  const cudaError_t ce = attention_bwd_setup<MODE, NH>();
  if (ce != cudaSuccess) return (int)ce;
  attention_bwd_dq_kernel<MODE, NH>
      <<<grid, dim3(kBwdThreads, NH), kBwdDqSmem<NH>, st>>>(
          q, k, v, ld, mask, dattn, attnout, stats, dq, delta, n, heads,
          scale, causal, maybe_dead);
  XCLIP_CHECK_LAUNCH();
  attention_bwd_dkv_kernel<MODE, NH>
      <<<grid, dim3(kBwdThreads, NH), kBwdDkvSmem<NH>, st>>>(
          q, k, v, ld, mask, dattn, stats, delta, dk, dv, n, heads, scale,
          causal, maybe_dead);
  XCLIP_CHECK_LAUNCH();
  return 0;
}

// fp32: dq, dk, dv (row stride ld, head h at column h*dh, dh 64 or 128)
// from q, k, v (the same strides), the row cotangents dattn (b*n x hd), the
// forward's output attnout (b*n x hd) and row statistics (kK6, kK7: lse;
// kMega: the megablock's sm); `delta` is b*n x heads scratch (the dq
// kernel writes it, the dk/dv kernel reads it). The tiles are copied 16
// bytes at a time: every pointer 16-byte aligned. kMega, kK6: n at most
// K6_MAX_N (the mask words); kK7: one head, ld = dh, n a multiple of 64,
// no dead rows, any length.
template <int MODE>
int launch_fma_bwd(const float* q, const float* k, const float* v, long ld,
                   const uint8_t* mask, const float* dattn,
                   const float* attnout, const float* stats, float* dq,
                   float* dk, float* dv, float* delta, int b, int n,
                   int heads, int dh, float scale, int causal, int maybe_dead,
                   cudaStream_t st) {
  using xclip::aligned16;
  const dim3 grid = core_grid<MODE>(b, n, heads);
  const int nh = xclip::f32_halves(dh);
  const bool shape_ok =
      MODE == kK7 ? n % 64 == 0 && heads == 1 && ld == dh && !maybe_dead
                  : n <= xclip::K6_MAX_N;
  if (!nh || !shape_ok || !grid.x || ld % 4 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(dattn) ||
      !aligned16(attnout) || !aligned16(dq) || !aligned16(dk) ||
      !aligned16(dv) || (MODE == kK7 && reinterpret_cast<uintptr_t>(mask) % 8))
    return (int)cudaErrorInvalidValue;
  return (nh == 1 ? launch_fma_bwd_nh<MODE, 1> : launch_fma_bwd_nh<MODE, 2>)(
      q, k, v, ld, mask, dattn, attnout, stats, dq, dk, dv, delta, grid, n,
      heads, scale, causal, maybe_dead, st);
}

// The fused layout's backward (kMega, kK6): dqkv (b*n x 3hd), hd = heads *
// dh, from qkv and the rest as launch_fma_bwd's.
template <int MODE>
int launch_attention_fma_bwd(const float* qkv, const uint8_t* mask,
                             const float* dattn, const float* attnout,
                             const float* stats, float* dqkv, float* delta,
                             int b, int n, int heads, int dh, float scale,
                             int causal, int maybe_dead, cudaStream_t st) {
  const int hd = heads * dh;
  return launch_fma_bwd<MODE>(qkv, qkv + hd, qkv + 2 * hd, 3L * hd, mask,
                              dattn, attnout, stats, dqkv, dqkv + hd,
                              dqkv + 2 * hd, delta, b, n, heads, dh, scale,
                              causal, maybe_dead, st);
}

// The megablock's attention backward: dqkv (b*n x 3hd, T) from qkv, its
// fp32 row cotangents dattn (b*n x hd), attnout and sm; delta (b*n x
// heads) fp32 scratch. bf16 runs the megablock mode of
// attention_block_sm90.cuh, whose dq kernel rewrites dattn in place as its
// two bf16 copies (the caller's scratch, read by nothing after this
// launch); fp32 the FMA kernels above.
template <typename T>
int launch_mega_attention_bwd(const T* qkv, const uint8_t* mask, float* dattn,
                              const T* attnout, const float* sm, T* dqkv,
                              float* delta, int b, int n, int heads, int dh,
                              float scale, int causal, int maybe_dead,
                              cudaStream_t st) {
  if constexpr (std::is_same<T, xclip::bf16>::value)
    return xclip::launch_k6_bwd<true>(
        qkv, mask, attnout, sm, dattn, reinterpret_cast<xclip::bf16*>(dattn),
        dqkv, delta, b, n, heads, dh, scale, causal, maybe_dead, st);
  else
    return launch_attention_fma_bwd<kMega>(qkv, mask, dattn, attnout, sm,
                                           dqkv, delta, b, n, heads, dh,
                                           scale, causal, maybe_dead, st);
}

// Largest sequence length the forward takes in dtype code `dtype`: the
// mask words of K6_MAX_TILES key tiles, 2048, in both dtypes (bf16 the
// mma.sync kernels', fp32 the FMA forward's: neither keeps a score row
// whole).
inline int attention_max_n(int dtype) { return xclip::K6_MAX_N; }

// Largest sequence length the backward takes in `dtype`: the same 2048.
inline int attention_bwd_max_n(int dtype) { return xclip::K6_MAX_N; }

// the fp32 kernels' blocks an SM: each takes its shared memory and 1 KB
// the card reserves a block, of the SM's 233,472 bytes
static_assert(2 * (kFwdSmem<1> + 1024) <= 233472, "two forward blocks an SM");
static_assert(2 * (kBwdDqSmem<1> + 1024) <= 233472, "two dq blocks an SM");
static_assert(kBwdBlocks * (kBwdDkvSmem<1> + 1024) <= 233472,
              "the dk/dv kernel's blocks an SM");
// a head of 128: one 512-thread block an SM, each under the 232,448 bytes
// a block may opt in to
static_assert(kFwdSmem<2> <= 232448 && kBwdDqSmem<2> <= 232448 &&
                  kBwdDkvSmem<2> <= 232448,
              "a head of 128 fits one block an SM");

}  // namespace
