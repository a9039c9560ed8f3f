// The whole FF block,
//     out = x + LN_gin(a * gelu(b)) @ w_out,   [a, b] = LN_gpre(x) @ w_in:
//   * K-FF, the inference forward, in place of the Pallas kernel
//     `_fwd_kernel` of xclip_tpu/kernels/fused_ff_block.py (reached through
//     `_ff_block_fwd_call`);
//   * K1, the GEGLU-triple stored variant that training runs
//     (`store_h='geglu'`): the forward in place of `_fwd_kernel_store_geglu`
//     (the same four launches, also keeping the residuals the backward
//     reads) and the two backward passes in place of `_bwd_dx_kernel_geglu`
//     and `_bwd_dw_kernel_geglu` (their source note is further down).
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

// The same four launches serve inference (K-FF) and the training forward
// (K1, `_fwd_kernel_store_geglu`). With `gb`, the GEGLU product's epilogue
// also writes gelu(b) and a * gelu'(b) rounded to T (rows x inner each);
// with `stats` (4 x rows: mean_pre, inv_pre, mean_in, inv_in) the two
// LayerNorm launches keep their fp32 statistics, and the inner one writes
// the fp32 prod rounded to T into `prod_s`. As in
// `_fwd_store_geglu_core`, mean_in and inv_in come from the fp32 prod.
template <typename T>
int ff_block_fwd(const T* x, const T* g_pre, const T* w_in, const T* g_inner,
                 const T* w_out, T* out, T* xn, float* prod, T* y, int rows,
                 int dim, int inner, float eps, cudaStream_t st,
                 T* prod_s = nullptr, T* gb = nullptr, T* agdb = nullptr,
                 float* stats = nullptr) {
  using namespace xclip;
  float* s = stats;
  int e;
  if ((e = launch_ln_rows<T, T>(x, g_pre, nullptr, xn, rows, dim, eps, st, s,
                                s ? s + rows : nullptr)))
    return e;
  e = gb ? launch_mm<T, kGegluTriple>(xn, w_in, nullptr, prod, rows, inner,
                                      dim, st, gb, agdb)
         : launch_mm<T, kGeglu>(xn, w_in, nullptr, prod, rows, inner, dim, st);
  if (e) return e;
  if ((e = launch_ln_rows<float, T>(prod, g_inner, nullptr, y, rows, inner,
                                    eps, st, s ? s + 2 * rows : nullptr,
                                    s ? s + 3 * rows : nullptr, prod_s)))
    return e;
  return launch_mm<T, kResidual>(y, w_out, x, out, rows, dim, inner, st);
}

// ------------------------------------------------------------ K1 backward
//
// Pass 1 (`_p1_geglu_core`): dx (+ the residual), dprod (T), dg_pre and
// dg_inner, and, for pass 2, the operands of its dW products: xn =
// T(xhat_pre * g_pre), dh2 = T([T(dprod) * gelu(b), T(dprod) * a gelu'(b)])
// and y2 = T(xhat_in * g_inner), xhat_in from the stored (rounded) prod,
// exactly as `_p2_geglu_core` rebuilds them. Six launches:
//   1. dy  = do · w_outᵀ                                (rows x inner, fp32)
//   2. inner LN backward + GEGLU backward rows: dprod, dh (from the fp32
//      dprod, for 4), dh2, y2, column partials of dy * xhat_in
//   3. dg_inner = ordered sum of the partials
//   4. dxn = dh · w_inᵀ                                 (rows x dim, fp32)
//   5. pre LN backward rows: dx = T(LN vjp + do), xn, partials of dxn * xhat
//   6. dg_pre
// Pass 2 (`_bwd_dw_kernel_geglu`): dW_in = xnᵀ · dh2 (its a and b halves
// are the column halves of dh2) and dW_out = y2ᵀ · do, each accumulated in
// fp32 over k-ranges of the rows and cast to T once after an ordered sum.
//
// What bounds it on the card: the four products (two of them over the
// 65,792-row axis at the flagship) on wmma, and the HBM round trips of dy
// (fp32) and dh/dh2 that the split at the two LayerNorms costs; the row
// kernels stream rows x inner tensors once each.
template <typename T>
struct FfBwdBuffers {
  float* dy;
  T* dh;
  float* dxn;
  float* part_in;
  float* part_pre;
  FfBwdBuffers(xclip::Workspace& ws, int rows, int dim, int inner) {
    dy = ws.take<float>((size_t)rows * inner);
    // fp32: dh2 equals dh and pass 1 writes it once, into the output
    dh = std::is_same<T, float>::value ? nullptr
                                       : ws.take<T>((size_t)rows * 2 * inner);
    dxn = ws.take<float>((size_t)rows * dim);
    part_in = ws.take<float>((size_t)xclip::ln_bwd_blocks(rows) * inner);
    part_pre = ws.take<float>((size_t)xclip::ln_bwd_blocks(rows) * dim);
  }
};

template <typename T>
size_t ff_block_bwd_workspace(int rows, int dim, int inner) {
  using namespace xclip;
  Workspace p1(nullptr);
  FfBwdBuffers<T> b(p1, rows, dim, inner);
  const bool tc = std::is_same<T, bf16>::value;
  const size_t p2 = std::max(weight_grad_part_bytes(dim, 2 * inner, rows, tc),
                             weight_grad_part_bytes(inner, dim, rows, tc));
  return std::max(p1.used, p2);
}

template <typename T>
int ff_block_bwd_p1(const T* x, const T* g_pre, const T* w_in,
                    const T* g_inner, const T* w_out, const T* dout,
                    const T* prod_s, const T* gb, const T* agdb,
                    const float* stats, T* dx, T* dprod, T* dg_pre,
                    T* dg_inner, T* xn, T* dh2, T* y2, void* workspace,
                    int rows, int dim, int inner, cudaStream_t st) {
  using namespace xclip;
  Workspace ws(workspace);
  FfBwdBuffers<T> b(ws, rows, dim, inner);
  T* dh = b.dh ? b.dh : dh2;
  const int nblk = ln_bwd_blocks(rows);
  int e;
  if ((e = launch_gemm<T, false, true>(dout, w_out, b.dy, rows, inner, dim,
                                       st)))
    return e;
  if ((e = launch_ln_bwd_rows<float, T, kLnBwdGeglu>(
           b.dy, prod_s, stats + 2 * rows, stats + 3 * rows, g_inner,
           nullptr, dprod, b.part_in, rows, inner, st, nullptr, gb, agdb, dh,
           dh2, y2)))
    return e;
  if ((e = launch_reduce_parts<T>(b.part_in, dg_inner, nblk, inner, st)))
    return e;
  if ((e = launch_gemm<T, false, true>(dh, w_in, b.dxn, rows, dim, 2 * inner,
                                       st)))
    return e;
  if ((e = launch_ln_bwd_rows<float, T, kLnBwd>(
           b.dxn, x, stats, stats + rows, g_pre, dout, dx, b.part_pre, rows,
           dim, st, xn)))
    return e;
  return launch_reduce_parts<T>(b.part_pre, dg_pre, nblk, dim, st);
}

template <typename T>
int ff_block_bwd_p2(const T* xn, const T* dh2, const T* y2, const T* dout,
                    T* dw_in, T* dw_out, void* workspace, int rows, int dim,
                    int inner, cudaStream_t st) {
  using namespace xclip;
  float* part = static_cast<float*>(workspace);
  int e;
  if ((e = launch_weight_grad<T>(xn, dh2, dw_in, part, dim, 2 * inner, rows,
                                 st)))
    return e;
  return launch_weight_grad<T>(y2, dout, dw_out, part, inner, dim, rows, st);
}

}  // namespace

// Returns a cudaError_t code (0 on success). Pointers are dense row-major
// device buffers of the dtype given by `dtype` (0 fp32, 1 bf16); `prod` is
// fp32 scratch of rows x inner, `xn` (rows x dim) and `y` (rows x inner)
// scratch of the storage dtype. dim and inner must be multiples of 64.
// K-FF passes null residual pointers; K1 passes prod_s, gb, agdb (rows x
// inner, dtype) and stats (4 x rows, fp32).
extern "C" int xclip_ff_block_fwd(int dtype, const void* x, const void* g_pre,
                                  const void* w_in, const void* g_inner,
                                  const void* w_out, void* out, void* xn,
                                  void* prod, void* y, void* prod_s, void* gb,
                                  void* agdb, void* stats, int rows, int dim,
                                  int inner, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim % 64 || inner % 64 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  XCLIP_DISPATCH(dtype, ff_block_fwd<T>(
      XCLIP_PTR(const T*, x), XCLIP_PTR(const T*, g_pre),
      XCLIP_PTR(const T*, w_in), XCLIP_PTR(const T*, g_inner),
      XCLIP_PTR(const T*, w_out), XCLIP_PTR(T*, out), XCLIP_PTR(T*, xn),
      XCLIP_PTR(float*, prod), XCLIP_PTR(T*, y), rows, dim, inner, eps, st,
      XCLIP_PTR(T*, prod_s), XCLIP_PTR(T*, gb), XCLIP_PTR(T*, agdb),
      XCLIP_PTR(float*, stats)));
}

// Bytes of the workspace both K1 backward passes take.
extern "C" long long xclip_ff_block_bwd_workspace(int dtype, int rows, int dim,
                                                  int inner) {
  if (dtype == xclip::kBF16)
    return (long long)ff_block_bwd_workspace<__nv_bfloat16>(rows, dim, inner);
  return (long long)ff_block_bwd_workspace<float>(rows, dim, inner);
}

// K1 backward pass 1. Inputs as saved by the forward plus dout (rows x dim);
// outputs dx (rows x dim), dprod, y2 (rows x inner), dh2 (rows x 2 inner),
// xn (rows x dim), dg_pre (dim), dg_inner (inner), all of the dtype.
extern "C" int xclip_ff_block_bwd_p1(
    int dtype, const void* x, const void* g_pre, const void* w_in,
    const void* g_inner, const void* w_out, const void* dout,
    const void* prod_s, const void* gb, const void* agdb, const void* stats,
    void* dx, void* dprod, void* dg_pre, void* dg_inner, void* xn, void* dh2,
    void* y2, void* workspace, int rows, int dim, int inner, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim % 64 || inner % 64 || rows <= 0) return (int)cudaErrorInvalidValue;
  XCLIP_DISPATCH(dtype, ff_block_bwd_p1<T>(
      XCLIP_PTR(const T*, x), XCLIP_PTR(const T*, g_pre),
      XCLIP_PTR(const T*, w_in), XCLIP_PTR(const T*, g_inner),
      XCLIP_PTR(const T*, w_out), XCLIP_PTR(const T*, dout),
      XCLIP_PTR(const T*, prod_s), XCLIP_PTR(const T*, gb),
      XCLIP_PTR(const T*, agdb), XCLIP_PTR(const float*, stats),
      XCLIP_PTR(T*, dx), XCLIP_PTR(T*, dprod), XCLIP_PTR(T*, dg_pre),
      XCLIP_PTR(T*, dg_inner), XCLIP_PTR(T*, xn), XCLIP_PTR(T*, dh2),
      XCLIP_PTR(T*, y2), workspace, rows, dim, inner, st));
}

// K1 backward pass 2: dw_in (dim x 2 inner) and dw_out (inner x dim) from
// pass 1's xn, dh2, y2 and dout.
extern "C" int xclip_ff_block_bwd_p2(int dtype, const void* xn,
                                     const void* dh2, const void* y2,
                                     const void* dout, void* dw_in,
                                     void* dw_out, void* workspace, int rows,
                                     int dim, int inner, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim % 64 || inner % 64 || rows <= 0) return (int)cudaErrorInvalidValue;
  XCLIP_DISPATCH(dtype, ff_block_bwd_p2<T>(
      XCLIP_PTR(const T*, xn), XCLIP_PTR(const T*, dh2),
      XCLIP_PTR(const T*, y2), XCLIP_PTR(const T*, dout), XCLIP_PTR(T*, dw_in),
      XCLIP_PTR(T*, dw_out), workspace, rows, dim, inner, st));
}
