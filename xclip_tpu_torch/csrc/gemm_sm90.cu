// The bf16 product kernel of the FF blocks and the attention megablock:
// out (m x n) = epilogue(opA · opB) over a k-range, fp32 accumulation, as
// common.cuh's launch_mm documents it. It runs every bf16 product of K-FF,
// K1, K1-h, K-FF-s, the FF recompute backward, K-MEGA, K2 and K3: the
// counterparts of the `jax.lax.dot_general` calls inside their Pallas
// bodies (xclip_tpu/kernels/fused_ff_block.py `_fwd_kernel` :150, :158,
// `_fwd_store_core` :234, :245, `_fwd_store_geglu_core` :283, :295, the
// backward products :387, :396, :411, :515, :527, :697-701, :770-774;
// xclip_tpu/kernels/attention_megablock.py `_dot` in `_fwd_common` :120
// and the backward's, :859), with the Pallas bodies' epilogues fused.
//
// What bounds it on the card: the tensor cores (2mnk FLOPs at 989 TFLOP/s
// in bf16) for the bf16-output and weight-gradient products; the fp32
// outputs' bytes for the products over the long row axis with a short k
// (the recomputed h, R x 4096 fp32 from k = 512, writes 16 KB a row).
//
// Design (Hopper): a persistent kernel, one block an SM walking output
// tiles (row tile, column tile, k-range) in that order, column tiles
// fastest so the row tiles in flight share their A rows in L2.
//   * One producer warpgroup, of which one thread issues TMA loads of 64-deep
//     k slices of A and B into a ring of kGemmStages slices in shared
//     memory, each stage guarded by a full and an empty mbarrier; it runs
//     ahead across tiles, so the next tile's slices load while the
//     consumers store the last tile. `setmaxnreg` hands its registers to:
//   * two consumer warpgroups, each 64 rows of the 128-row tile by all
//     kGemmBN columns, which run `wgmma.mma_async` m64nNk16 from shared
//     memory (four per slice) with the fp32 sums in registers, one slice's
//     group kept in flight while the slice before it is released.
//   * Layouts: every tile is stored with the 128-byte swizzle TMA writes
//     and wgmma reads. A non-transposed A (m x k) and a transposed B (n x
//     k, the backward's A·Bᵀ) are K-major, wgmma's own layout; a
//     transposed A (k x m, the weight gradients' Aᵀ·B) and a non-transposed
//     B (k x n) are MN-major, stored as 64-wide panels of 64 k rows and read
//     through the instruction's transpose bits. No pass copies an operand.
//   * The ragged row axis: TMA loads zero-fill rows (or k rows) past a
//     map's extent, and its stores clip there. A split k-range starts at
//     a multiple of kGemmBK (gemm_split), so no box crosses into the next
//     range; the last range ends ragged at k, zero-filled.
//   * Epilogues from the accumulator fragments through shared memory:
//     each consumer warpgroup writes its 64 rows, rounded as the epilogue
//     says, into a staging buffer (kGemmStagingPanels panels; an fp32 row
//     of the tile takes four rounds) in the swizzled layout of 64-row,
//     128-byte boxes, and one thread hands them to bulk (TMA) stores,
//     which clip the ragged edges and drain while the warpgroup runs the
//     next tile's products. Stores straight from the fragments would be
//     8-byte and strided, and would hold the warpgroup (and, all SMs
//     walking alike tiles, the whole card) off the tensor cores while the
//     fp32 outputs (16 KB a row of the recomputed h) drain. The GEGLU
//     epilogues load the tile as [a panel | b panel]
//     (columns c0.. of B's a half and n + c0.. of its b half), so output
//     column j and its gate sit in the same thread, N / 2 columns apart,
//     and a * gelu(b), gelu(b), a * gelu'(b) and the rounded h come out of
//     registers (GegluParts: the op sequence of the LayerNorm and
//     GEGLU-backward row kernels).
// Split-k writes fp32 partials (out + z * m * n) that launch_reduce_parts
// sums in order: no float atomics, two runs agree bit for bit.
//
// Tensor maps are encoded on the host for every launch (the pointers
// change every call) with cuTensorMapEncodeTiled, taken through
// cudaGetDriverEntryPoint so the library needs no -lcuda, and passed as
// __grid_constant__ kernel parameters.
#include "common.cuh"
#include "gemm_sm90.cuh"
#include "sm90_async.cuh"

namespace xclip {
namespace {

constexpr int kGemmThreads = 384;  // consumers: warpgroups 0, 1; producer: 2

constexpr int kStaging = kGemmStagingPanels * kPanel;  // per warpgroup

// shared memory: the ring, the two staging buffers, the ring's barriers
template <int BN>
struct GemmTile {
  static constexpr int a_bytes = kGemmBM * kGemmBK * 2;
  static constexpr int b_bytes = BN * kGemmBK * 2;
  static constexpr int stage_bytes = a_bytes + b_bytes;
  static constexpr int smem_bytes = kGemmStages * stage_bytes +
                                    2 * kStaging + 2 * kGemmStages * 8 +
                                    1024;  // + alignment
};

// registers a thread after setmaxnreg: the producer warpgroup gives its
// share of the block's 384 x 168 to the consumers' 128 accumulators
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs =
    (168 * kGemmThreads - kProducerRegs * 128) / 256;  // 232

#define XCLIP_ACC8(i)                                                   \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// D (64 x N, fp32 fragments) (+)= A (64 x 16) · B (16 x N), bf16 operands
// from shared memory; TA / TB the transpose bits (1: MN-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : XCLIP_ACC8(0), XCLIP_ACC8(8), XCLIP_ACC8(16), XCLIP_ACC8(24),
        XCLIP_ACC8(32), XCLIP_ACC8(40), XCLIP_ACC8(48), XCLIP_ACC8(56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : XCLIP_ACC8(0), XCLIP_ACC8(8), XCLIP_ACC8(16), XCLIP_ACC8(24),
        XCLIP_ACC8(32), XCLIP_ACC8(40), XCLIP_ACC8(48), XCLIP_ACC8(56),
        XCLIP_ACC8(64), XCLIP_ACC8(72), XCLIP_ACC8(80), XCLIP_ACC8(88),
        XCLIP_ACC8(96), XCLIP_ACC8(104), XCLIP_ACC8(112), XCLIP_ACC8(120)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

#undef XCLIP_ACC8

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (BN == 256)
    wgmma_n256<TA, TB>(d, da, db, scale_d);
  else
    wgmma_n128<TA, TB>(d, da, db, scale_d);
}

// bulk stores: a box of shared memory to a 3-D map at (col, row, z), one
// bulk group per epilogue round
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int row,
                                          int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(row), "r"(z)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the stores committed so far have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and written it
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// the 128 threads of consumer warpgroup wg (named barrier wg + 1)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Byte offset, in a consumer warpgroup's staging buffer, of byte b of its
// row r (0 .. 63): panels of 64 rows x 128 bytes with
// the 128-byte swizzle, as a bulk store of a (128-byte x 64-row) box reads
// them
__device__ __forceinline__ int staged(int r, int b) {
  return (b >> 7) * kPanel + r * 128 + ((((b >> 4) & 7) ^ (r & 7)) << 4) +
         (b & 15);
}

struct TileCoord {
  int row0, c0, kb, ke, z;
};

// tile t of the walk: column tiles fastest, then row tiles, then k-ranges
template <int EPI, int BN>
__device__ __forceinline__ TileCoord tile_coord(int t, int tiles_m,
                                                int tiles_n, int k,
                                                int k_split) {
  const int tn = t % tiles_n, tm = (t / tiles_n) % tiles_m,
            z = t / (tiles_n * tiles_m);
  TileCoord c;
  c.row0 = tm * kGemmBM;
  c.c0 = tn * (is_geglu(EPI) ? BN / 2 : BN);
  c.kb = z * k_split;
  c.ke = k < c.kb + k_split ? k : c.kb + k_split;
  c.z = z;
  return c;
}

// One output of consumer warpgroup wg's epilogue: its 64 rows by 8 NCH
// columns of V (fp32 or bf16), the pair of values at (8-column chunk ch,
// row half i) given by value(ch, i) (thread t holds local rows 16 (t / 32
// % 4) + t % 32 / 4 and + 8, columns 8 ch + 2 (t % 4) and + 1), stored
// through the warpgroup's staging buffer `buf` to `map` at columns col0..
// of rows row.. (layer z), in rounds of kGemmStagingPanels 128-byte
// panels. A round
// first waits until the last round's bulk stores have read the buffer;
// the stores clip rows and columns past the map's extent (and
// skip panels from column col_end on), and drain while the warpgroup goes
// on to the next tile's products. value() is called once for each (ch, i).
template <typename V, int NCH, typename F>
__device__ __forceinline__ void emit(unsigned char* buf, int wg,
                                     const CUtensorMap* map, int col0,
                                     int row, int z, int col_end, F value) {
  constexpr int ES = sizeof(V), PANEL_COLS = 128 / ES;
  constexpr int ROUND_CH = kGemmStagingPanels * PANEL_COLS / 8;
  const int lane = threadIdx.x % 32;
  const int rl = (threadIdx.x / 32) % 4 * 16 + lane / 4, q = lane % 4 * 2;
  const bool leader = threadIdx.x % 128 == 0;
#pragma unroll
  for (int ch0 = 0; ch0 < NCH; ch0 += ROUND_CH) {
    if (leader) bulk_wait_read();
    wg_sync(wg);
#pragma unroll
    for (int ch = ch0; ch < (ch0 + ROUND_CH < NCH ? ch0 + ROUND_CH : NCH);
         ++ch)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 v = value(ch, i);
        unsigned char* dst =
            buf + staged(rl + 8 * i, ((ch - ch0) * 8 + q) * ES);
        if constexpr (ES == 4)
          *reinterpret_cast<float2*>(dst) = v;
        else
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v.x, v.y);
      }
    fence_async_smem();
    wg_sync(wg);
    if (leader) {
      constexpr int panels = ROUND_CH * 8 / PANEL_COLS;
#pragma unroll
      for (int p = 0; p < panels; ++p) {
        const int col = col0 + ch0 * 8 + p * PANEL_COLS;
        if (ch0 * 8 + p * PANEL_COLS < NCH * 8 && col < col_end)
          tma_store(map, buf + p * kPanel, col, row, z);
      }
      bulk_commit();
    }
  }
}

// The epilogue of consumer warpgroup wg: its 64 rows of the tile from the
// accumulator fragments (acc: 8-column chunks of 4 values, rows r and r + 8
// by two columns), rounded as the epilogue says, through emit().
template <int EPI, int BN>
__device__ __forceinline__ void store_tile_sm90(
    float (&acc)[BN / 2], const TileCoord& c, int wg, unsigned char* buf,
    const CUtensorMap* map_out, const CUtensorMap* map_aux1,
    const CUtensorMap* map_aux2, const bf16* __restrict__ resid, int m,
    int n) {
  const int row = c.row0 + wg * 64;
  const int everything = 1 << 30;  // col_end: no panel skipped
  auto pair = [&](int ch, int i) {
    return make_float2(acc[ch * 4 + i * 2], acc[ch * 4 + i * 2 + 1]);
  };
  if constexpr (EPI == kStore || EPI == kStoreF32) {
    using V = typename std::conditional<EPI == kStore, bf16, float>::type;
    emit<V, BN / 8>(buf, wg, map_out, c.c0, row, c.z, everything, pair);
  } else if constexpr (EPI == kResidual) {  // T(acc) + resid, added in T
    const int lane = threadIdx.x % 32;
    const int rl = (threadIdx.x / 32) % 4 * 16 + lane / 4, q = lane % 4 * 2;
    emit<bf16, BN / 8>(
        buf, wg, map_out, c.c0, row, 0, everything, [&](int ch, int i) {
          float2 v = pair(ch, i);
          const int rg = row + rl + 8 * i, cg = c.c0 + ch * 8 + q;
          if (rg < m && cg < n) {
            const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
                resid + (long)rg * n + cg);
            v.x = round_to<bf16>(v.x) + __bfloat162float(x.x);
            v.y = round_to<bf16>(v.y) + __bfloat162float(x.y);
          }
          return v;
        });
  } else {  // GEGLU: acc is [a | b], output column j's gate BN / 2 later
    constexpr int B0 = BN / 16;  // the first b chunk
    emit<float, BN / 16>(
        buf, wg, map_out, c.c0, row, 0, everything, [&](int ch, int i) {
          float& a0 = acc[ch * 4 + i * 2];
          float& a1 = acc[ch * 4 + i * 2 + 1];
          float& b0 = acc[(ch + B0) * 4 + i * 2];
          float& b1 = acc[(ch + B0) * 4 + i * 2 + 1];
          const GegluParts g0(a0, b0), g1(a1, b1);
          if (EPI == kGegluTriple) {  // keep gelu(b), a * gelu'(b) for later
            const float d0 = a0 * g0.gelu_db(b0), d1 = a1 * g1.gelu_db(b1);
            a0 = g0.gelu_b;
            a1 = g1.gelu_b;
            b0 = d0;
            b1 = d1;
          }
          return make_float2(g0.prod, g1.prod);
        });
    auto b_pair = [&](int ch, int i) { return pair(ch + B0, i); };
    if constexpr (EPI == kGegluTriple) {
      emit<bf16, BN / 16>(buf, wg, map_aux1, c.c0, row, 0, everything, pair);
      emit<bf16, BN / 16>(buf, wg, map_aux2, c.c0, row, 0, everything,
                          b_pair);
    } else if constexpr (EPI == kGegluH) {  // h = [a, b], m x 2n
      // an a panel from column n on would land on b's columns
      emit<bf16, BN / 16>(buf, wg, map_aux1, c.c0, row, 0, n, pair);
      emit<bf16, BN / 16>(buf, wg, map_aux1, n + c.c0, row, 0, everything,
                          b_pair);
    }
  }
}

template <int EPI, bool TA, bool TB, int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_out,
                 const __grid_constant__ CUtensorMap map_aux1,
                 const __grid_constant__ CUtensorMap map_aux2,
                 const bf16* __restrict__ resid, int m, int n, int k,
                 int k_split, int tiles_m, int tiles_n, int tiles) {
  static_assert(!(is_geglu(EPI) && TB), "GEGLU epilogues take B k x 2n");
  using L = GemmTile<BN>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle atoms repeat every 1024 bytes: align the ring to them
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* staging = smem + kGemmStages * L::stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * kStaging);
  uint64_t* empty = full + kGemmStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one thread of each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {  // ------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 256) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileCoord c = tile_coord<EPI, BN>(t, tiles_m, tiles_n, k, k_split);
      for (int k0 = c.kb; k0 < c.ke; k0 += kGemmBK) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* a = smem + stage * L::stage_bytes;
        unsigned char* b = a + L::a_bytes;
        mbar_expect_tx(&full[stage], L::stage_bytes);
        if (TA) {  // A is k x m: two 64-wide panels of m
          tma_load(a, &map_a, &full[stage], c.row0, k0);
          tma_load(a + kPanel, &map_a, &full[stage], c.row0 + 64, k0);
        } else {   // A is m x k: 128 rows of a 64-deep slice
          tma_load(a, &map_a, &full[stage], k0, c.row0);
        }
        if (TB) {  // B is n x k: BN rows of a 64-deep slice
          tma_load(b, &map_b, &full[stage], k0, c.c0);
        } else {
#pragma unroll
          for (int p = 0; p < BN / 64; ++p) {
            // GEGLU: panels [a: c0, c0 + 64, ... | b: n + c0, ...]
            const int col = !is_geglu(EPI) ? c.c0 + 64 * p
                            : p < BN / 128 ? c.c0 + 64 * p
                                           : n + c.c0 + 64 * (p - BN / 128);
            tma_load(b + p * kPanel, &map_b, &full[stage], col, k0);
          }
        }
        if (++stage == kGemmStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const uint32_t base = smem_u32(smem);
  int stage = 0;
  uint32_t phase = 0;
  float acc[BN / 2];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileCoord c = tile_coord<EPI, BN>(t, tiles_m, tiles_n, k, k_split);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int k0 = c.kb; k0 < c.ke; k0 += kGemmBK) {
      mbar_wait(&full[stage], phase);
      __syncwarp();  // the .aligned wgmma instructions need the whole warp
      const uint32_t a = base + stage * L::stage_bytes + wg * kPanel;
      const uint32_t b = base + stage * L::stage_bytes + L::a_bytes;
      const uint64_t da = smem_desc(a, TA ? kPanel : 16, 1024);
      const uint64_t db = smem_desc(b, TB ? 16 : kPanel, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 16; ++kk) {
        // 16 deeper: 32 bytes along a K-major row, 16 rows of an MN-major
        // panel
        const uint64_t step_a = TA ? kk * 2048 >> 4 : kk * 32 >> 4;
        const uint64_t step_b = TB ? kk * 32 >> 4 : kk * 2048 >> 4;
        wgmma_tile<BN, TA, !TB>(acc, da + step_a, db + step_b, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the slice before this one is read: release it
      if (prev >= 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kGemmStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (prev >= 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
    store_tile_sm90<EPI, BN>(acc, c, wg, staging + wg * kStaging, &map_out,
                             &map_aux1, &map_aux2, resid, m, n);
  }
  if (threadIdx.x % 128 == 0) bulk_wait();  // before the block's memory goes
}

// -------------------------------------------------------------- host side

long long g_launches[kGemmInstances];  // kernel launches per instance

template <int EPI, bool TA, bool TB>
int launch_gemm_sm90(const bf16* A, const bf16* B, const bf16* resid,
                     void* out, int m, int n, int k, int parts, int k_split,
                     void* aux1, void* aux2, cudaStream_t st) {
  constexpr int BN = kGemmBN;
  using L = GemmTile<BN>;
  const int ldb = is_geglu(EPI) ? 2 * n : n;
  // out: T (kStore, kResidual) or fp32 (kStoreF32's `parts` partials, the
  // GEGLU product); aux: T, h 2n wide; an unused map repeats out's
  const bool f32_out = EPI == kStoreF32 || is_geglu(EPI);
  CUtensorMap map_a, map_b, map_out, map_aux1, map_aux2;
  bool ok = (TA ? encode_map(&map_a, A, false, k, m, m, 64)
                : encode_map(&map_a, A, false, m, k, k, kGemmBM)) &&
            (TB ? encode_map(&map_b, B, false, n, k, k, BN)
                : encode_map(&map_b, B, false, k, ldb, ldb, 64)) &&
            encode_map(&map_out, out, f32_out, m, n, n, 64,
                       EPI == kStoreF32 ? parts : 1);
  map_aux1 = map_aux2 = map_out;
  if (EPI == kGegluTriple)
    ok = ok && encode_map(&map_aux1, aux1, false, m, n, n, 64, 1) &&
         encode_map(&map_aux2, aux2, false, m, n, n, 64, 1);
  if (EPI == kGegluH)
    ok = ok && encode_map(&map_aux1, aux1, false, m, 2 * n, 2 * n, 64, 1);
  if (!ok || reinterpret_cast<uintptr_t>(resid) % 16)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_sm90_kernel<EPI, TA, TB, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::smem_bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int tiles_m = (m + kGemmBM - 1) / kGemmBM;
  const int tiles_n = is_geglu(EPI) ? (n + BN / 2 - 1) / (BN / 2)
                                    : (n + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n * parts;
  const int grid = std::min(tiles, kGemmSMs);
  gemm_sm90_kernel<EPI, TA, TB, BN><<<grid, kGemmThreads, L::smem_bytes, st>>>(
      map_a, map_b, map_out, map_aux1, map_aux2, resid, m, n, k, k_split,
      tiles_m, tiles_n, tiles);
  XCLIP_CHECK_LAUNCH();
  ++g_launches[gemm_instance(EPI, TA, TB)];
  return 0;
}

}  // namespace

int gemm_instance(int epi, bool ta, bool tb) {
  if (epi == kStoreF32) return ta ? (tb ? -1 : 3) : (tb ? 2 : 1);
  if (ta || tb) return -1;
  switch (epi) {
    case kStore: return 0;
    case kGeglu: return 4;
    case kGegluTriple: return 5;
    case kGegluH: return 6;
    case kResidual: return 7;
  }
  return -1;
}

int gemm_bf16(int epi, bool ta, bool tb, const bf16* A, const bf16* B,
              const bf16* resid, void* out, int m, int n, int k, int parts,
              int k_split, void* aux1, void* aux2, cudaStream_t st) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 64 || parts < 1 ||
      (parts > 1 && (epi != kStoreF32 || k_split <= 0 || k_split % kGemmBK ||
                     (long)(parts - 1) * k_split >= k ||
                     (long)parts * k_split < k)))
    return (int)cudaErrorInvalidValue;
  if (parts == 1) k_split = k;
  switch (gemm_instance(epi, ta, tb)) {
#define XCLIP_GEMM(E, A_T, B_T)                                            \
  return launch_gemm_sm90<E, A_T, B_T>(A, B, resid, out, m, n, k, parts, \
                                       k_split, aux1, aux2, st)
    case 0: XCLIP_GEMM(kStore, false, false);
    case 1: XCLIP_GEMM(kStoreF32, false, false);
    case 2: XCLIP_GEMM(kStoreF32, false, true);
    case 3: XCLIP_GEMM(kStoreF32, true, false);
    case 4: XCLIP_GEMM(kGeglu, false, false);
    case 5: XCLIP_GEMM(kGegluTriple, false, false);
    case 6: XCLIP_GEMM(kGegluH, false, false);
    case 7: XCLIP_GEMM(kResidual, false, false);
#undef XCLIP_GEMM
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace xclip

// ------------------------------------------------------------ entry points

namespace {

// The product alone (kernels/matmul.py `mm`), dtype code `dtype`: bf16 on
// the wgmma kernel, fp32 on the FMA kernel of gemm_f32.cu.
template <typename T>
int mm_any(int instance, const T* A, const T* B, const T* resid, void* out,
           int m, int n, int k, void* aux1, void* aux2, xclip::Split sp,
           cudaStream_t st) {
  using namespace xclip;
  switch (instance) {
#define XCLIP_MM(E, A_T, B_T)                                       \
  return launch_mm<T, E, A_T, B_T>(A, B, resid, out, m, n, k, st, aux1, \
                                   aux2, sp)
    case 0: XCLIP_MM(kStore, false, false);
    case 1: XCLIP_MM(kStoreF32, false, false);
    case 2: XCLIP_MM(kStoreF32, false, true);
    case 3: XCLIP_MM(kStoreF32, true, false);
    case 4: XCLIP_MM(kGeglu, false, false);
    case 5: XCLIP_MM(kGegluTriple, false, false);
    case 6: XCLIP_MM(kGegluH, false, false);
    case 7: XCLIP_MM(kResidual, false, false);
#undef XCLIP_MM
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out = epilogue(opA · opB) (common.cuh launch_mm): epi a common.cuh
// epilogue code, ta / tb the transposes, `parts` k-ranges of k_split (more
// than one only for the fp32 partials of kStoreF32, written at out + z * m
// * n). Returns a cudaError_t code.
extern "C" int xclip_mm(int dtype, int epi, int ta, int tb, const void* A,
                        const void* B, const void* resid, void* out,
                        void* aux1, void* aux2, int m, int n, int k,
                        int parts, int k_split, void* stream) {
  using namespace xclip;
  const int instance = gemm_instance(epi, ta != 0, tb != 0);
  if (instance < 0 || m <= 0 || n <= 0 || k <= 0 || n % 64 || parts < 1 ||
      (parts > 1 && (epi != kStoreF32 || k_split <= 0 ||
                     (long)(parts - 1) * k_split >= k ||
                     (long)parts * k_split < k)))
    return (int)cudaErrorInvalidValue;
  const Split sp{parts, parts > 1 ? k_split : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  XCLIP_DISPATCH(dtype, mm_any<T>(
      instance, XCLIP_PTR(const T*, A), XCLIP_PTR(const T*, B),
      XCLIP_PTR(const T*, resid), out, m, n, k, aux1, aux2, sp, st));
}

// gemm_split's k-range length for an (m x n) product over k in `dtype`
// (k_block > 0: ranges of exactly k_block); the ranges number ceil(k /
// k_split).
extern "C" int xclip_mm_split(int dtype, int m, int n, int k, int k_block) {
  return xclip::gemm_split(m, n, k, dtype == xclip::kBF16, k_block).k_split;
}

// Launches of instance `instance` (0 .. kGemmInstances - 1,
// kernels/matmul.py INSTANCES) of the product kernel of dtype code `dtype`
// (bf16: the wgmma kernel, fp32: the FMA kernel) since the library was
// loaded or last reset, from every caller (the FF and megablock entry
// points, xclip_mm); reset != 0 sets it to 0 after reading it.
extern "C" long long xclip_mm_launches(int dtype, int instance, int reset) {
  if (instance < 0 || instance >= xclip::kGemmInstances ||
      (dtype != xclip::kBF16 && dtype != xclip::kF32))
    return -1;
  long long& count = dtype == xclip::kBF16 ? xclip::g_launches[instance]
                                           : xclip::g_f32_launches[instance];
  const long long n = count;
  if (reset) count = 0;
  return n;
}
