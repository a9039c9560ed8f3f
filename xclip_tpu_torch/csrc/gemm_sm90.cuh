// The product kernels as the other translation units see them: the bf16
// kernel (csrc/gemm_sm90.cu) and the fp32 one (csrc/gemm_f32.cu), their
// tiles, and for each one entry that dispatches over the epilogue and the
// operands' layouts. Each kernel and its instantiations live in its own
// .cu file alone, so they are compiled once for the whole library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace xclip {

// Block tile: kGemmBM rows (two consumer warpgroups of 64) by kGemmBN
// columns, k slices kGemmBK deep (128 bytes of bf16: one 128-byte swizzle
// row), one persistent block an SM. Within the 227 KB of shared memory a
// block has: a ring of kGemmStages slices (48 KB each) and an epilogue
// staging buffer of kGemmStagingPanels 8 KB panels for each consumer
// warpgroup (tools/gemm_variants.py times the choice). gemm_split
// (common.cuh) sizes the split-k ranges from the same tile.
constexpr int kGemmBM = 128;
constexpr int kGemmBN = 256;
constexpr int kGemmBK = 64;
constexpr int kGemmStages = 4;
constexpr int kGemmStagingPanels = 2;
constexpr int kGemmSMs = 132;  // NVIDIA H100 SXM

// The fp32 kernel's block tile: kGemmF32Tile rows by as many columns
// (gemm_split sizes the fp32 split-k ranges from it).
constexpr int kGemmF32Tile = 128;

// The (epilogue, TA, TB) instances both kernels are built for, in the order
// of their launch counters (xclip_mm_launches) and of kernels/matmul.py's
// INSTANCES; -1 for any other combination.
int gemm_instance(int epi, bool ta, bool tb);
constexpr int kGemmInstances = 8;

// The fp32 kernel's launches per instance since the library was loaded or
// last reset, from every caller (gemm_f32.cu).
extern long long g_f32_launches[kGemmInstances];

// out (m x n) = epilogue(opA · opB) over `parts` k-ranges of k_split, as
// common.cuh's launch_mm documents it, on the wgmma kernel. Returns a
// cudaError_t code: cudaErrorInvalidValue, launching nothing, for an
// instance it is not built for or operands TMA cannot take (a pointer not
// 16-byte aligned, a row stride not a multiple of 16 bytes, n not a
// multiple of 64, k_split not a multiple of kGemmBK when k is split).
int gemm_bf16(int epi, bool ta, bool tb, const __nv_bfloat16* A,
              const __nv_bfloat16* B, const __nv_bfloat16* resid, void* out,
              int m, int n, int k, int parts, int k_split, void* aux1,
              void* aux2, cudaStream_t st);

// The same product of fp32 operands on the FMA kernel, in full fp32. Any
// pointer, any m and k (16-byte copies where the operands allow them);
// cudaErrorInvalidValue, launching nothing, for an instance it is not
// built for or n not a multiple of 64.
int gemm_f32(int epi, bool ta, bool tb, const float* A, const float* B,
             const float* resid, void* out, int m, int n, int k, int parts,
             int k_split, void* aux1, void* aux2, cudaStream_t st);

}  // namespace xclip
