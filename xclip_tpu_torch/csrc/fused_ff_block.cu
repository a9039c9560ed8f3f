// The whole FF block,
//     out = x + LN_gin(a * gelu(b)) @ w_out,   [a, b] = LN_gpre(x) @ w_in:
//   * K-FF, the inference forward, in place of the Pallas kernel
//     `_fwd_kernel` of xclip_tpu/kernels/fused_ff_block.py (reached through
//     `_ff_block_fwd_call`);
//   * K1, the GEGLU-triple stored variant that training runs
//     (`store_h='geglu'`): the forward in place of `_fwd_kernel_store_geglu`
//     (the same four launches, also keeping the residuals the backward
//     reads) and the two backward passes in place of `_bwd_dx_kernel_geglu`
//     and `_bwd_dw_kernel_geglu` (their source note is further down);
//   * K1-h, the stored-h variant (`store_h=True`, XCLIP_FF_STORE=h): the
//     forward in place of `_fwd_kernel_store` (K1's launches keeping h =
//     xn · w_in rounded to the storage dtype and the four fp32 row
//     statistics) and the backward in place of `_bwd_dx_kernel_stored` and
//     `_bwd_dw_kernel_stored` (its note is with K1's backward);
//   * K-FF-s and the recompute backward that the memory-lean training runs
//     (`store_h=False`): the forward in place of `_fwd_kernel_stats` (the
//     same four launches keeping only the four fp32 row statistics) and the
//     backward in place of `_bwd_dx_kernel` + `_bwd_dw_kernel` and of K4's
//     fed pair `_bwd_dx_kernel_fed` + `_bwd_dw_kernel_fed` (one design for
//     both, since they compute the same gradients; its note is at the end).
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
// FLOPs). In bf16 they run on the TMA-fed wgmma kernel (gemm_sm90.cu) at
// about half the tensor cores' rate; the weights (6 MB in bf16 at the
// flagship) come from L2 for every row tile. Then the inner LN, which
// streams the fp32 prod from HBM.
// HBM round-trips a later PR removes first: the fp32 prod (rows x inner x 4
// bytes, written by 2 and read by 3), then y and xn.
#include "common.cuh"

namespace {

// The same four launches serve inference (K-FF) and the training forwards
// (K1, `_fwd_kernel_store_geglu`; K1-h, `_fwd_kernel_store`). With `gb`,
// the GEGLU product's epilogue also writes gelu(b) and a * gelu'(b) rounded
// to T (rows x inner each); with `h_s`, it writes h = xn · w_in rounded to T
// instead (rows x 2 inner: a, then b). With `stats` (4 x rows: mean_pre,
// inv_pre, mean_in, inv_in) the two LayerNorm launches keep their fp32
// statistics, and with `prod_s` the inner one writes the fp32 prod rounded
// to T there. As in `_fwd_store_geglu_core` and `_fwd_store_core`, mean_in
// and inv_in come from the fp32 prod. Statistic k of row r is
// stats[k * stats_ld + r]: a row chunk of a longer call writes into its
// columns of the caller's (4 x total rows) array.
template <typename T>
int ff_block_fwd(const T* x, const T* g_pre, const T* w_in, const T* g_inner,
                 const T* w_out, T* out, T* xn, float* prod, T* y, int rows,
                 int dim, int inner, float eps, cudaStream_t st,
                 T* prod_s = nullptr, T* gb = nullptr, T* agdb = nullptr,
                 float* stats = nullptr, long stats_ld = 0,
                 T* h_s = nullptr) {
  using namespace xclip;
  float* s = stats;
  const long ld = stats_ld;
  int e;
  if ((e = launch_ln_rows<T, T>(x, g_pre, nullptr, xn, rows, dim, eps, st, s,
                                s ? s + ld : nullptr)))
    return e;
  e = gb    ? launch_mm<T, kGegluTriple>(xn, w_in, nullptr, prod, rows, inner,
                                         dim, st, gb, agdb)
      : h_s ? launch_mm<T, kGegluH>(xn, w_in, nullptr, prod, rows, inner, dim,
                                    st, h_s)
            : launch_mm<T, kGeglu>(xn, w_in, nullptr, prod, rows, inner, dim,
                                   st);
  if (e) return e;
  if ((e = launch_ln_rows<float, T>(prod, g_inner, nullptr, y, rows, inner,
                                    eps, st, s ? s + 2 * ld : nullptr,
                                    s ? s + 3 * ld : nullptr, prod_s)))
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
// 65,792-row axis at the flagship) on the wgmma kernel, and the HBM round
// trips of dy (fp32) and dh/dh2 that the split at the two LayerNorms
// costs; the row kernels stream rows x inner tensors once each.
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

// ----------------------------------------------------------- K1-h backward
//
// The stored-h variant (`store_h=True`: `_bwd_dx_kernel_stored` via
// `_p1_stored_core`, `_bwd_dw_kernel_stored` via `_p2_stored_core`) is the
// same six launches with another launch 2: geglu_bwd_rows in its stored-h
// mode rebuilds prod, gelu(b) and a * gelu'(b) from the rounded h and takes
// xhat_in from the forward's stored statistics (which came from the fp32 h:
// the reference's precision quirk, reproduced), writing dprod, dh (from the
// fp32 dprod), dh2 (from T(dprod), gelu from the rounded b, as
// `_p2_stored_core` rebuilds it) and y2. Pass 2 is then K1's: the three
// products `_bwd_dw_kernel_stored` computes, on the operands pass 1 handed
// it. What bounds it: K1's products, and the row kernel's bytes (the
// rows x 2 inner h, fp32 dy, four outputs) and erf/exp per element, where
// K1 reads the triple.
template <typename T>
int ff_block_bwd_p1(const T* x, const T* g_pre, const T* w_in,
                    const T* g_inner, const T* w_out, const T* dout,
                    const T* prod_s, const T* gb, const T* agdb,
                    const float* stats, T* dx, T* dprod, T* dg_pre,
                    T* dg_inner, T* xn, T* dh2, T* y2, void* workspace,
                    int rows, int dim, int inner, cudaStream_t st,
                    const T* h_s = nullptr) {
  using namespace xclip;
  Workspace ws(workspace);
  FfBwdBuffers<T> b(ws, rows, dim, inner);
  T* dh = b.dh ? b.dh : dh2;
  const int nblk = ln_bwd_blocks(rows);
  int e;
  if ((e = launch_gemm<T, false, true>(dout, w_out, b.dy, rows, inner, dim,
                                       st)))
    return e;
  e = h_s ? launch_geglu_bwd_rows<T, float, T, kGegluStoredH>(
                b.dy, h_s, stats + 2 * rows, stats + 3 * rows, g_inner,
                b.part_in, rows, inner, dh, st, 0.f, y2, dprod, dh2)
          : launch_ln_bwd_rows<float, T, T, kLnBwdGeglu>(
                b.dy, prod_s, stats + 2 * rows, stats + 3 * rows, g_inner,
                nullptr, dprod, b.part_in, rows, inner, st, nullptr, gb, agdb,
                dh, dh2, y2);
  if (e) return e;
  if ((e = launch_reduce_parts<T>(b.part_in, dg_inner, nblk, inner, st)))
    return e;
  if ((e = launch_gemm<T, false, true>(dh, w_in, b.dxn, rows, dim, 2 * inner,
                                       st)))
    return e;
  if ((e = launch_ln_bwd_rows<float, T, T, kLnBwd>(
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

// ------------------------------------------------- the recompute backward
//
// In place of `_bwd_dx_kernel` + `_bwd_dw_kernel` and of K4's fed pair
// `_bwd_dx_kernel_fed` + `_bwd_dw_kernel_fed` (`_ff_block_bwd_fed`): the
// two compute the same gradients, and the fed pair's design is the one
// that suits the card (pass 2 is its products alone, fed by pass 1's dh, y
// and xn). One call handles one chunk of rows; the wrapper walks the rows
// in chunks whose transients stay under its bound (the fed variant's row
// chunking) and sums the chunks' dW and dg in chunk order (`acc`: 1 for the
// first chunk, 2 after). The chunks start at multiples of `row_block`
// rows, and the weight gradients' split-k partials cover row_block rows
// each, summed in row order onto the running fp32 sum, as are the dg
// partials of 64-row blocks: the gradients come out bit for bit the same
// whatever the chunking. From x, dout and the forward's stored fp32
// statistics (K-FF-s), per chunk (`_p1_recompute_core`):
//   1. ln_rows: xn = T(LN_gpre(x))                       (rows x dim, T)
//   2. h = xn · w_in in fp32, not rounded                (rows x 2 inner)
//   3. dy = dout · w_outᵀ                                (rows x inner, fp32)
//   4. geglu_bwd_rows: dh = T([da, db]) from the fp32 dprod,
//      y = T(xhat_in * g_inner), the partials of dy * xhat_in
//   5. dg_inner (+)= their ordered sum
//   6. dxn = dh · w_inᵀ                                  (rows x dim, fp32)
//   7. pre LN backward rows: dx = T(LN vjp + dout), partials of dxn * xhat
//   8. dg_pre (+)= their ordered sum
//   9. dW_in (+)= xnᵀ · dh, dW_out (+)= yᵀ · dout, split-k fp32 partials
//      summed in order.
// The same rounded dh feeds the dx product (6) and dW_in (9), as in the
// Pallas bodies. The inner LN statistics are not re-reduced: the stored
// mean_in / inv_in are the forward's, and h comes from the same product
// kernel on the same xn (each output's k-sum in the same order) with the
// same GEGLU op sequence, so xhat_in is the forward's; a recompute that
// summed in another order would differ from it at the fp32 ulp level. xn
// is recomputed by ln_rows rather than from the stored mean_pre / inv_pre:
// the same launch on the same x gives the same bits.
//
// What bounds it on the card: the five products (2 * rows * dim * 2 inner
// FLOPs each for h, dxn and dW_in; 2 * rows * inner * dim for dy and
// dW_out) on the wgmma kernel, then the fp32 h and dy round trips through
// HBM (16 + 8 KB per row at inner 2048), which the GEGLU backward rows
// read once each.
template <typename T>
struct FfRecomputeBuffers {
  T* xn;
  float* h;
  float* dy;  // dy, then dxn (inner >= dim)
  T* dh;
  T* y;
  float* part_in;
  float* part_pre;
  float* wpart;
  FfRecomputeBuffers(xclip::Workspace& ws, int rows, int dim, int inner,
                     int row_block) {
    using namespace xclip;
    const bool tc = std::is_same<T, bf16>::value;
    xn = ws.take<T>((size_t)rows * dim);
    h = ws.take<float>((size_t)rows * 2 * inner);
    dy = ws.take<float>((size_t)rows * std::max(inner, dim));
    dh = ws.take<T>((size_t)rows * 2 * inner);
    y = ws.take<T>((size_t)rows * inner);
    part_in = ws.take<float>((size_t)ln_bwd_blocks(rows) * inner);
    part_pre = ws.take<float>((size_t)ln_bwd_blocks(rows) * dim);
    wpart = ws.take<float>(
        std::max(weight_grad_part_bytes(dim, 2 * inner, rows, tc, row_block),
                 weight_grad_part_bytes(inner, dim, rows, tc, row_block)) /
        sizeof(float));
  }
};

template <typename T>
int ff_block_bwd_recompute(const T* x, const T* g_pre, const T* w_in,
                           const T* g_inner, const T* w_out, const T* dout,
                           const float* stats, long stats_ld, T* dx,
                           float* dg_pre, float* dw_in, float* dg_inner,
                           float* dw_out, void* workspace, int rows, int dim,
                           int inner, int row_block, float eps, int acc,
                           cudaStream_t st) {
  using namespace xclip;
  Workspace ws(workspace);
  FfRecomputeBuffers<T> b(ws, rows, dim, inner, row_block);
  const int nblk = ln_bwd_blocks(rows);
  const long ld = stats_ld;
  int e;
  if ((e = launch_ln_rows<T, T>(x, g_pre, nullptr, b.xn, rows, dim, eps, st)))
    return e;
  if ((e = launch_gemm<T, false, false>(b.xn, w_in, b.h, rows, 2 * inner, dim,
                                        st)))
    return e;
  if ((e = launch_gemm<T, false, true>(dout, w_out, b.dy, rows, inner, dim,
                                       st)))
    return e;
  if ((e = launch_geglu_bwd_rows<float, float, T, kGegluRecompute>(
           b.dy, b.h, stats + 2 * ld, stats + 3 * ld, g_inner, b.part_in,
           rows, inner, b.dh, st, 0.f, b.y)))
    return e;
  if ((e = launch_emit_sum<T>(b.part_in, dg_inner, nblk, inner, acc, st)))
    return e;
  float* dxn = b.dy;
  if ((e = launch_gemm<T, false, true>(b.dh, w_in, dxn, rows, dim, 2 * inner,
                                       st)))
    return e;
  if ((e = launch_ln_bwd_rows<float, T, T, kLnBwd>(
           dxn, x, stats, stats + ld, g_pre, dout, dx, b.part_pre, rows, dim,
           st)))
    return e;
  if ((e = launch_emit_sum<T>(b.part_pre, dg_pre, nblk, dim, acc, st)))
    return e;
  if ((e = launch_weight_grad<T>(b.xn, b.dh, dw_in, b.wpart, dim, 2 * inner,
                                 rows, st, acc, row_block)))
    return e;
  return launch_weight_grad<T>(b.y, dout, dw_out, b.wpart, inner, dim, rows,
                               st, acc, row_block);
}

}  // namespace

// Returns a cudaError_t code (0 on success). Pointers are dense row-major
// device buffers of the dtype given by `dtype` (0 fp32, 1 bf16); `prod` is
// fp32 scratch of rows x inner, `xn` (rows x dim) and `y` (rows x inner)
// scratch of the storage dtype. dim and inner must be multiples of 64.
// K-FF passes null residual pointers; K1 passes prod_s, gb, agdb (rows x
// inner, dtype) and stats (4 x stats_ld, fp32); K1-h passes h_s (rows x 2
// inner, dtype) and stats; K-FF-s passes stats alone.
extern "C" int xclip_ff_block_fwd(int dtype, const void* x, const void* g_pre,
                                  const void* w_in, const void* g_inner,
                                  const void* w_out, void* out, void* xn,
                                  void* prod, void* y, void* prod_s, void* gb,
                                  void* agdb, void* h_s, void* stats,
                                  long long stats_ld, int rows, int dim,
                                  int inner, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim % 64 || inner % 64 || rows < 0 || (stats && stats_ld < rows))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  XCLIP_DISPATCH(dtype, ff_block_fwd<T>(
      XCLIP_PTR(const T*, x), XCLIP_PTR(const T*, g_pre),
      XCLIP_PTR(const T*, w_in), XCLIP_PTR(const T*, g_inner),
      XCLIP_PTR(const T*, w_out), XCLIP_PTR(T*, out), XCLIP_PTR(T*, xn),
      XCLIP_PTR(float*, prod), XCLIP_PTR(T*, y), rows, dim, inner, eps, st,
      XCLIP_PTR(T*, prod_s), XCLIP_PTR(T*, gb), XCLIP_PTR(T*, agdb),
      XCLIP_PTR(float*, stats), (long)stats_ld, XCLIP_PTR(T*, h_s)));
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

// K1-h backward pass 1: as xclip_ff_block_bwd_p1, from the forward's h_s
// (rows x 2 inner, dtype) and stats in place of prod_s, gb and agdb; the
// workspace is xclip_ff_block_bwd_workspace's.
extern "C" int xclip_ff_block_bwd_p1_h(
    int dtype, const void* x, const void* g_pre, const void* w_in,
    const void* g_inner, const void* w_out, const void* dout, const void* h_s,
    const void* stats, void* dx, void* dprod, void* dg_pre, void* dg_inner,
    void* xn, void* dh2, void* y2, void* workspace, int rows, int dim,
    int inner, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim % 64 || inner % 64 || rows <= 0) return (int)cudaErrorInvalidValue;
  XCLIP_DISPATCH(dtype, ff_block_bwd_p1<T>(
      XCLIP_PTR(const T*, x), XCLIP_PTR(const T*, g_pre),
      XCLIP_PTR(const T*, w_in), XCLIP_PTR(const T*, g_inner),
      XCLIP_PTR(const T*, w_out), XCLIP_PTR(const T*, dout), nullptr,
      nullptr, nullptr, XCLIP_PTR(const float*, stats), XCLIP_PTR(T*, dx),
      XCLIP_PTR(T*, dprod), XCLIP_PTR(T*, dg_pre), XCLIP_PTR(T*, dg_inner),
      XCLIP_PTR(T*, xn), XCLIP_PTR(T*, dh2), XCLIP_PTR(T*, y2), workspace,
      rows, dim, inner, st, XCLIP_PTR(const T*, h_s)));
}

// K1 (and K1-h) backward pass 2: dw_in (dim x 2 inner) and dw_out (inner x dim) from
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

// Bytes of the workspace the recompute backward takes for `rows` rows.
extern "C" long long xclip_ff_block_bwd_recompute_workspace(
    int dtype, int rows, int dim, int inner, int row_block) {
  xclip::Workspace ws(nullptr);
  if (dtype == xclip::kBF16) {
    FfRecomputeBuffers<__nv_bfloat16> sizes(ws, rows, dim, inner, row_block);
  } else {
    FfRecomputeBuffers<float> sizes(ws, rows, dim, inner, row_block);
  }
  return (long long)ws.used;
}

// The recompute backward of one chunk of `rows` rows: x, dout, dx (rows x
// dim, dtype) and the chunk's columns of the forward's fp32 stats (4 x
// stats_ld). dg_pre (dim), dw_in (dim x 2 inner), dg_inner (inner) and
// dw_out (inner x dim) are fp32: written when acc is 1, added to when 2.
// row_block: a multiple of 64 that every chunk but the last is a multiple
// of.
extern "C" int xclip_ff_block_bwd_recompute(
    int dtype, const void* x, const void* g_pre, const void* w_in,
    const void* g_inner, const void* w_out, const void* dout,
    const void* stats, long long stats_ld, void* dx, void* dg_pre,
    void* dw_in, void* dg_inner, void* dw_out, void* workspace, int rows,
    int dim, int inner, int row_block, float eps, int acc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim % 64 || inner % 64 || rows <= 0 || stats_ld < rows ||
      row_block <= 0 || row_block % 64 || (acc != 1 && acc != 2))
    return (int)cudaErrorInvalidValue;
  XCLIP_DISPATCH(dtype, ff_block_bwd_recompute<T>(
      XCLIP_PTR(const T*, x), XCLIP_PTR(const T*, g_pre),
      XCLIP_PTR(const T*, w_in), XCLIP_PTR(const T*, g_inner),
      XCLIP_PTR(const T*, w_out), XCLIP_PTR(const T*, dout),
      XCLIP_PTR(const float*, stats), (long)stats_ld, XCLIP_PTR(T*, dx),
      XCLIP_PTR(float*, dg_pre), XCLIP_PTR(float*, dw_in),
      XCLIP_PTR(float*, dg_inner), XCLIP_PTR(float*, dw_out), workspace,
      rows, dim, inner, row_block, eps, acc, st));
}
