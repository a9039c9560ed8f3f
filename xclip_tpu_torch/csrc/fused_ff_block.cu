// K-FF: the whole FF block forward,
//     out = x + LN_gin(a * gelu(b)) @ w_out,   [a, b] = LN_gpre(x) @ w_in,
// in place of the Pallas kernel `_fwd_kernel` of
// xclip_tpu/kernels/fused_ff_block.py (reached through `_ff_block_fwd_call`,
// the inference forward of `ff_block`).
//
// Cast order (as the Pallas kernel): LN_pre in fp32, xn cast to the storage
// dtype before the w_in product; h accumulates in fp32 and a = h[:, :inner],
// b = h[:, inner:]; prod = a * gelu(b) in fp32; the inner LN in fp32, y cast
// to the storage dtype; y @ w_out accumulates in fp32, is cast to the
// storage dtype, then x is added in the storage dtype. Both LNs use the
// eps of the storage dtype, which the wrapper passes.
//
// Design: four launches on the caller's stream.
//   1. ln_rows: xn = T(LN_gpre(x))                         (rows x dim, T)
//   2. mm GEGLU: prod = a * gelu(b), both halves of w_in   (rows x inner, fp32)
//   3. ln_rows: y = T(LN_gin(prod))                        (rows x inner, T)
//   4. mm residual: out = T(y @ w_out) + x                 (rows x dim, T)
// The inner LayerNorm couples a whole inner row (2048 wide at dim 512), so
// instead of holding a row block's prod in shared memory this version
// splits the block at it.
//
// What bounds it on the card: the two products (2 * rows * dim * 3 * inner
// FLOPs). In bf16 they run on wmma 128x128 tiles fed by a cp.async ring
// (common.cuh), well short of the tensor cores' rate without wgmma and
// TMA; the weights (6 MB in bf16 at the flagship) come from L2 for every
// row tile. Then the inner LN, which streams the fp32 prod from HBM.
// HBM round-trips a later PR removes first: the fp32 prod (rows x inner x 4
// bytes, written by 2 and read by 3), then y and xn.
#include "common.cuh"

namespace {

template <typename T>
int ff_block_fwd(const T* x, const T* g_pre, const T* w_in, const T* g_inner,
                 const T* w_out, T* out, T* xn, float* prod, T* y, int rows,
                 int dim, int inner, float eps, cudaStream_t st) {
  using namespace xclip;
  int e;
  if ((e = launch_ln_rows<T, T>(x, g_pre, nullptr, xn, rows, dim, eps, st)))
    return e;
  if ((e = launch_mm<T, kGeglu>(xn, w_in, nullptr, prod, rows, inner, dim, st)))
    return e;
  if ((e = launch_ln_rows<float, T>(prod, g_inner, nullptr, y, rows, inner,
                                    eps, st)))
    return e;
  return launch_mm<T, kResidual>(y, w_out, x, out, rows, dim, inner, st);
}

}  // namespace

// Returns a cudaError_t code (0 on success). Pointers are dense row-major
// device buffers of the dtype given by `dtype` (0 fp32, 1 bf16); `prod` is
// fp32 scratch of rows x inner, `xn` (rows x dim) and `y` (rows x inner)
// scratch of the storage dtype. dim and inner must be multiples of 64.
extern "C" int xclip_ff_block_fwd(int dtype, const void* x, const void* g_pre,
                                  const void* w_in, const void* g_inner,
                                  const void* w_out, void* out, void* xn,
                                  void* prod, void* y, int rows, int dim,
                                  int inner, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim % 64 || inner % 64 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (dtype == xclip::kBF16) {
    using T = __nv_bfloat16;
    return ff_block_fwd<T>(
        static_cast<const T*>(x), static_cast<const T*>(g_pre),
        static_cast<const T*>(w_in), static_cast<const T*>(g_inner),
        static_cast<const T*>(w_out), static_cast<T*>(out),
        static_cast<T*>(xn), static_cast<float*>(prod), static_cast<T*>(y),
        rows, dim, inner, eps, st);
  }
  if (dtype == xclip::kF32) {
    using T = float;
    return ff_block_fwd<T>(
        static_cast<const T*>(x), static_cast<const T*>(g_pre),
        static_cast<const T*>(w_in), static_cast<const T*>(g_inner),
        static_cast<const T*>(w_out), static_cast<T*>(out),
        static_cast<T*>(xn), static_cast<float*>(prod), static_cast<T*>(y),
        rows, dim, inner, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}
