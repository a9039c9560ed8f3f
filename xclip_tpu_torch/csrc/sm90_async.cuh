// Hopper's asynchronous machinery as the port's TMA-fed kernels use it:
// mbarriers, TMA tile loads (cp.async.bulk.tensor) completing on them, the
// proxy fence that hands generic shared-memory writes to bulk stores,
// wgmma shared-memory descriptors of 128-byte-swizzled tiles and the
// wgmma group fences, and the host's tensor-map encoder (taken through
// cudaGetDriverEntryPoint, so the library needs no -lcuda). The bf16
// product kernel (gemm_sm90.cu) and the bf16 attention forward at heads of
// 128 (attention_block_sm90.cuh) are built from these.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace xclip {
namespace {

constexpr int kPanel = 64 * 128;  // one 64-row, 128-byte-wide swizzled panel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// a (box_cols x box_rows) box of a 2-D map at (col, row) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// a (64-column, 64-row, 1) box of a 3-D map at (col, row, z) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(z)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at shared
// address `addr` (1024-aligned atoms): `lbo` the byte stride between
// 64-element chunks of the MN axis (MN-major; unused K-major), `sbo` the
// byte stride between groups of 8 rows (K-major: of the MN axis; MN-major:
// of the k axis)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries
template <int R> __device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// this thread's shared-memory writes become visible to the bulk stores
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// -------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of `layers` row-major matrices (rows x cols, row stride `ld`
// elements, one after another) of 2- (bf16) or 4-byte (fp32) elements, in
// boxes of 128 bytes by box_rows rows with the 128-byte swizzle; loads
// zero-fill past its extent and stores clip there. layers 0: a 2-D map
// (tma_load's); otherwise 3-D (tma_store's).
bool encode_map(CUtensorMap* map, const void* base, bool fp32, long rows,
                long cols, long ld, int box_rows, int layers = 0) {
  EncodeTiled fn = encode_tiled();
  const int es = fp32 ? 4 : 2;
  if (!fn || reinterpret_cast<uintptr_t>(base) % 16 || (ld * es) % 16)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)(layers ? layers : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)(ld * es),
                                 (cuuint64_t)(rows * ld * es)};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / es), (cuuint32_t)box_rows,
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map,
            fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            layers ? 3 : 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace xclip
