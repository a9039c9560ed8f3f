// The whole attention block,
//     out = x + LN_gout(attention(LN_gpre(x) @ w_qkv) @ w_out):
//   * K-MEGA, the inference forward, in place of the Pallas kernel
//     `_fwd_kernel` (with `_fwd_common`) of
//     xclip_tpu/kernels/attention_megablock.py, reached through `_mega_fwd`
//     with need_residuals=False;
//   * K2, the stored variant that training runs (`store_qkv=True`): the
//     forward in place of `_fwd_kernel_stored` (the same five launches,
//     also keeping the residuals and statistics the backward reads) and
//     the backward in place of `_bwd_kernel_stored` with `_mega_bwd_vjp`'s
//     dW_qkv product (its source note is further down);
//   * K3, the memory-lean variants (`store_qkv=False` / "qkv"): the
//     forward in place of `_fwd_kernel_stats` and `_fwd_kernel_qkv` (the
//     same five launches keeping only the fp32 statistics, and qkv for the
//     second), the backward in place of `_bwd_kernel` and `_bwd_kernel_qkv`
//     (its note is at the end).
//
// Cast order (as the Pallas kernel): LN_pre in fp32, xn cast to the storage
// dtype; qkv = xn @ w_qkv accumulates in fp32 and is cast to the storage
// dtype; the attention core's cast order is in attention_core.cuh and
// attention_block_sm90.cuh. proj =
// attnout @ w_out in fp32, LN_out in fp32, cast to the storage dtype, then
// x is added in the storage dtype.
//
// Design: five launches on the caller's stream.
//   1. ln_rows: xn = T(LN_gpre(x))                           (b*n x dim, T)
//   2. mm: qkv = T(xn @ w_qkv)                               (b*n x 3hd, T)
//   3. attention (launch_attention, attention_core.cuh): bf16 on the
//      megablock mode of attention_block_sm90.cuh's forward, one block per
//      (64-query tile, head, batch element), two passes over the 64-key
//      tiles (heads of 64 on register-resident mma.sync tiles, of 128 on
//      TMA-fed wgmma), causal and all-masked key tiles skipped; fp32 on
//      the FMA core                                         (b*n x hd, T)
//   4. mm: proj = attnout @ w_out                            (b*n x dim, fp32)
//   5. ln_rows with residual: out = T(LN_gout(proj)) + x     (b*n x dim, T)
//
// What bounds it on the card: the qkv and output products (on the
// TMA-fed wgmma kernel, gemm_sm90.cu) and the attention (on the kernels
// of attention_block_sm90.cuh, whose notes give their bound). HBM round-trips a later PR removes first: qkv (b*n x 3hd) and
// the fp32 proj, then xn and attnout.
#include "attention_core.cuh"

namespace {

// The same five launches serve inference (K-MEGA) and the training
// forwards (K2, `_fwd_kernel_stored`; K3, `_fwd_kernel_stats` and
// `_fwd_kernel_qkv`): with `sm`, the attention kernel also keeps its
// softmax statistics; with `ln_stats` (statistic k of row r at
// ln_stats[k * stats_ld + r]: mean_pre, inv_pre, mean_o, inv_o) the two
// LayerNorm launches keep theirs, and with `proj_s` the out-LN launch
// writes proj rounded to T there (the statistics come from the fp32 proj,
// as in the Pallas kernel). qkv and attnout are K2's residuals as they
// stand, and qkv K3's "qkv" residual; K3 "stats" keeps neither. A batch
// chunk of a longer call writes into its columns of the caller's
// statistics (stats_ld the caller's rows).
template <typename T>
int attention_block_fwd(const T* x, const T* g_pre, const T* w_qkv,
                        const T* w_out, const T* g_out, const uint8_t* mask,
                        T* out, T* xn, T* qkv, T* attnout, float* proj, int b,
                        int n, int dim, int heads, int dh, float scale,
                        int causal, int maybe_dead, float eps, cudaStream_t st,
                        T* proj_s = nullptr, float* sm = nullptr,
                        float* ln_stats = nullptr, long stats_ld = 0) {
  using namespace xclip;
  const int rows = b * n, hd = heads * dh;
  float* ls = ln_stats;
  const long ld = stats_ld;
  int e;
  if ((e = launch_ln_rows<T, T>(x, g_pre, nullptr, xn, rows, dim, eps, st,
                                ls, ls ? ls + ld : nullptr)))
    return e;
  if ((e = launch_mm<T, kStore>(xn, w_qkv, nullptr, qkv, rows, 3 * hd, dim, st)))
    return e;
  if ((e = launch_attention<T>(qkv, mask, attnout, b, n, heads, dh, scale,
                               causal, maybe_dead, sm, st)))
    return e;
  if ((e = launch_mm<T, kStoreF32>(attnout, w_out, nullptr, proj, rows, dim,
                                   hd, st)))
    return e;
  return launch_ln_rows<float, T>(proj, g_out, x, out, rows, dim, eps, st,
                                  ls ? ls + 2 * ld : nullptr,
                                  ls ? ls + 3 * ld : nullptr, proj_s);
}

// ------------------------------------------------------------ K2 backward
//
// In place of `_bwd_kernel_stored` (with `_mega_bwd_vjp`'s dW_qkv product)
// of xclip_tpu/kernels/attention_megablock.py. From the forward's stored
// qkv, attnout, proj (T) and fp32 statistics, per batch element:
//   dproj = T(LN_out vjp of do)           dg_out = sum of do * xhat_o
//   dattn = dproj · w_outᵀ (fp32)          dW_out = attnoutᵀ · dproj
//   per head: p = (dead ? 1 : exp(s - m)) / l from the stored m, l (not
//   re-reduced), delta = scale * sum_d dattn * attnout, dp = T(dattn *
//   scale) · vᵀ, ds = T(dead ? 0 : p * (dp - delta)), dq = ds · k,
//   dk = dsᵀ · q, dv = T(p)ᵀ · T(dattn), each cast to T once
//   dxn = dqkv · w_qkvᵀ (fp32), dx = T(LN_pre vjp + do), dg_pre
//   dW_qkv = xnᵀ · dqkv, xn rebuilt from the stored mean_pre / inv_pre.
// The attention part is launch_mega_attention_bwd (attention_core.cuh):
// in bf16 the megablock mode of attention_block_sm90.cuh's two backward
// kernels (a query-tile kernel for delta and dq, which also rewrites each
// head's fp32 dattn rows in place as the two bf16 copies T(dattn * scale)
// and T(dattn), and a key-tile kernel for dk and dv that streams them; no
// atomics); fp32 on the FMA core. The products, LN backwards and column
// sums are common.cuh's, dW through ordered split partials, so two runs
// agree bit for bit.
//
// What bounds it on the card: the surrounding products on the wgmma
// kernel (four of them, and the dW sums); the attention kernels compute s twice
// (once per kernel) on mma.sync; the fp32 dattn and dxn round trips
// through HBM.
template <typename T>
struct MegaBwdBuffers {
  T* dproj;
  float* dattn;
  float* delta;
  float* dxn;
  T* xn;
  float* part_out;
  float* part_pre;
  float* wpart;
  MegaBwdBuffers(xclip::Workspace& ws, int b, int n, int dim, int heads,
                 int dh) {
    using namespace xclip;
    const int rows = b * n, hd = heads * dh;
    const bool tc = std::is_same<T, bf16>::value;
    dproj = ws.take<T>((size_t)rows * dim);
    dattn = ws.take<float>((size_t)rows * hd);
    delta = ws.take<float>((size_t)rows * heads);
    dxn = ws.take<float>((size_t)rows * dim);
    xn = ws.take<T>((size_t)rows * dim);
    part_out = ws.take<float>((size_t)ln_bwd_blocks(rows) * dim);
    part_pre = ws.take<float>((size_t)ln_bwd_blocks(rows) * dim);
    wpart = ws.take<float>(
        std::max(weight_grad_part_bytes(hd, dim, rows, tc),
                 weight_grad_part_bytes(dim, 3 * hd, rows, tc)) /
        sizeof(float));
  }
};

// The backward from qkv, attnout, proj (T for K2's stored proj, fp32 for
// K3's recomputed one) and the statistics (`ln_stats` with row stride
// stats_ld), into dx and dqkv; dW_qkv, dW_out, dg_pre and dg_out are
// emitted as launch_emit_sum's `acc` says (0: T, K2; 1, 2: fp32 chunk sums,
// K3).
template <typename T, typename Tp>
int attention_block_bwd_core(const T* x, const T* g_pre, const T* w_qkv,
                             const T* w_out, const T* g_out,
                             const uint8_t* mask, const T* dout,
                             const T* qkv, const T* attnout, const Tp* proj,
                             const float* sm, const float* ln_stats,
                             long stats_ld, T* dx, T* dqkv, void* dw_qkv,
                             void* dw_out, void* dg_pre, void* dg_out,
                             MegaBwdBuffers<T>& w, int b, int n, int dim,
                             int heads, int dh, float scale, int causal,
                             int maybe_dead, int acc, cudaStream_t st) {
  using namespace xclip;
  const int rows = b * n, hd = heads * dh, nblk = ln_bwd_blocks(rows);
  const long ld = stats_ld;
  int e;
  if ((e = launch_ln_bwd_rows<T, Tp, T, kLnBwd>(
           dout, proj, ln_stats + 2 * ld, ln_stats + 3 * ld, g_out, nullptr,
           w.dproj, w.part_out, rows, dim, st)))
    return e;
  if ((e = launch_emit_sum<T>(w.part_out, dg_out, nblk, dim, acc, st)))
    return e;
  if ((e = launch_gemm<T, false, true>(w.dproj, w_out, w.dattn, rows, hd, dim,
                                       st)))
    return e;
  if ((e = launch_weight_grad<T>(attnout, w.dproj, dw_out, w.wpart, hd, dim,
                                 rows, st, acc)))
    return e;
  if ((e = launch_mega_attention_bwd<T>(qkv, mask, w.dattn, attnout, sm, dqkv,
                                        w.delta, b, n, heads, dh, scale,
                                        causal, maybe_dead, st)))
    return e;
  if ((e = launch_gemm<T, false, true>(dqkv, w_qkv, w.dxn, rows, dim, 3 * hd,
                                       st)))
    return e;
  if ((e = launch_ln_bwd_rows<float, T, T, kLnBwd>(
           w.dxn, x, ln_stats, ln_stats + ld, g_pre, dout, dx, w.part_pre,
           rows, dim, st, w.xn)))
    return e;
  if ((e = launch_emit_sum<T>(w.part_pre, dg_pre, nblk, dim, acc, st)))
    return e;
  return launch_weight_grad<T>(w.xn, dqkv, dw_qkv, w.wpart, dim, 3 * hd, rows,
                               st, acc);
}

template <typename T>
int attention_block_bwd(const T* x, const T* g_pre, const T* w_qkv,
                        const T* w_out, const T* g_out, const uint8_t* mask,
                        const T* dout, const T* qkv, const T* attnout,
                        const T* proj_s, const float* sm,
                        const float* ln_stats, T* dx, T* dqkv, T* dw_qkv,
                        T* dw_out, T* dg_pre, T* dg_out, void* workspace,
                        int b, int n, int dim, int heads, int dh, float scale,
                        int causal, int maybe_dead, cudaStream_t st) {
  xclip::Workspace ws(workspace);
  MegaBwdBuffers<T> w(ws, b, n, dim, heads, dh);
  return attention_block_bwd_core<T, T>(
      x, g_pre, w_qkv, w_out, g_out, mask, dout, qkv, attnout, proj_s, sm,
      ln_stats, (long)b * n, dx, dqkv, dw_qkv, dw_out, dg_pre, dg_out, w, b,
      n, dim, heads, dh, scale, causal, maybe_dead, 0, st);
}

// ------------------------------------------------ K3 recompute backward
//
// In place of `_bwd_kernel` (recompute) and `_bwd_kernel_qkv` (qkv kept).
// One call handles one chunk of batch elements; the wrapper walks the
// batch in chunks whose transients stay under its bound and sums the
// chunks' dW and dg in chunk order (`acc` 1 for the first chunk, 2 after),
// as the Pallas grid accumulates them over batch elements. Per chunk:
//   1. ln_rows: xn = T(LN_gpre(x)); 2. mm: qkv = T(xn · w_qkv) — skipped
//      when the forward kept qkv (then xn for dW_qkv comes from the stored
//      statistics in the pre-LN backward rows, `_bwd_kernel_qkv`:628-630);
//   3. attention: attnout in T (p from the kernel's own m and l, which are
//      the stored ones: the same launch on the same qkv);
//   4. mm: proj = attnout · w_out in fp32, NOT rounded (`_bwd_kernel`
//      :512-518, unlike K2, which reads the rounded stored proj);
//   then K2's backward launches (attention_block_bwd_core) with the fp32
//   proj: xhat_o = (proj - mean_o) * inv_o, dproj rounded, delta from the
//   fp32 dattn, p rebuilt from the stored m and l, ds zeroed on dead rows
//   then rounded, dqkv rounded once; dW and dg in fp32 across the batch.
// The recompute launches are the forward's own, on the same inputs, so
// qkv, attnout and proj are bit for bit what the forward computed.
//
// What bounds it on the card: K2's backward plus the forward's qkv,
// attention and projection launches again; transients of one chunk cross
// HBM (xn, qkv, attnout, the fp32 proj, dqkv and K2's workspace, ~16 KB
// per row at dim 512).
template <typename T>
struct RecomputeBuffers {
  T* xn;
  T* qkv;
  T* attnout;
  float* proj;
  T* dqkv;
  RecomputeBuffers(xclip::Workspace& ws, int b, int n, int dim, int heads,
                   int dh, bool keep_qkv) {
    const size_t rows = (size_t)b * n, hd = (size_t)heads * dh;
    xn = keep_qkv ? nullptr : ws.take<T>(rows * dim);
    qkv = keep_qkv ? nullptr : ws.take<T>(rows * 3 * hd);
    attnout = ws.take<T>(rows * hd);
    proj = ws.take<float>(rows * dim);
    dqkv = ws.take<T>(rows * 3 * hd);
  }
};

template <typename T>
int attention_block_bwd_recompute(
    const T* x, const T* g_pre, const T* w_qkv, const T* w_out,
    const T* g_out, const uint8_t* mask, const T* dout, const T* kept_qkv,
    const float* sm, const float* ln_stats, long stats_ld, T* dx,
    float* dw_qkv, float* dw_out, float* dg_pre, float* dg_out,
    void* workspace, int b, int n, int dim, int heads, int dh, float scale,
    int causal, int maybe_dead, float eps, int acc, cudaStream_t st) {
  using namespace xclip;
  const int rows = b * n, hd = heads * dh;
  Workspace ws(workspace);
  RecomputeBuffers<T> r(ws, b, n, dim, heads, dh, kept_qkv != nullptr);
  MegaBwdBuffers<T> w(ws, b, n, dim, heads, dh);
  const T* qkv = kept_qkv;
  int e;
  if (!qkv) {
    if ((e = launch_ln_rows<T, T>(x, g_pre, nullptr, r.xn, rows, dim, eps,
                                  st)))
      return e;
    if ((e = launch_mm<T, kStore>(r.xn, w_qkv, nullptr, r.qkv, rows, 3 * hd,
                                  dim, st)))
      return e;
    qkv = r.qkv;
  }
  if ((e = launch_attention<T>(qkv, mask, r.attnout, b, n, heads, dh, scale,
                               causal, maybe_dead, nullptr, st)))
    return e;
  if ((e = launch_mm<T, kStoreF32>(r.attnout, w_out, nullptr, r.proj, rows,
                                   dim, hd, st)))
    return e;
  return attention_block_bwd_core<T, float>(
      x, g_pre, w_qkv, w_out, g_out, mask, dout, qkv, r.attnout, r.proj, sm,
      ln_stats, stats_ld, dx, r.dqkv, dw_qkv, dw_out, dg_pre, dg_out, w, b, n,
      dim, heads, dh, scale, causal, maybe_dead, acc, st);
}

}  // namespace

// Largest sequence length the attention core's forward takes, for dtype
// code `dtype`: 64 * K6_MAX_TILES = 2048 in both (the mask words of the
// mma.sync kernels, K6's too, and of the FMA core).
extern "C" int xclip_attention_block_max_n(int dtype) {
  return attention_max_n(dtype);
}

// Largest sequence length the attention core's backward takes in `dtype`:
// 2048 in both (the mask words of 32 key tiles), the forward's.
extern "C" int xclip_attention_block_bwd_max_n(int dtype) {
  return attention_bwd_max_n(dtype);
}

// The attention core alone, as the megablock launches it (step 3 of the
// forward, the attention launches of the backward), for tests and timing.
// Returns a cudaError_t code. qkv (b*n, 3*heads*dh) and attnout (b*n,
// heads*dh) of the storage dtype, dh 64 or 128, mask (b, n) uint8, sm
// (b*n, 2*heads) fp32 or null.
extern "C" int xclip_mega_core_fwd(int dtype, const void* qkv,
                                   const void* mask, void* attnout, void* sm,
                                   int b, int n, int heads, int dh,
                                   float scale, int causal, int maybe_dead,
                                   void* stream) {
  if (b <= 0 || n <= 0 || heads <= 0 || n > attention_max_n(dtype))
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  XCLIP_DISPATCH(dtype, launch_attention<T>(
      XCLIP_PTR(const T*, qkv), m, XCLIP_PTR(T*, attnout), b, n, heads, dh,
      scale, causal, maybe_dead, XCLIP_PTR(float*, sm), st));
}

// Its backward: dqkv (b*n, 3*heads*dh) from qkv, the fp32 row cotangents
// dattn (b*n, heads*dh), attnout and sm; delta (b*n, heads) fp32 scratch;
// in bf16 `dcopy` (b*n, 2*heads*dh, bf16) takes dattn's two bf16 copies
// (the megablock passes dattn's own storage), in fp32 it is unused.
extern "C" int xclip_mega_core_bwd(int dtype, const void* qkv,
                                   const void* mask, const void* dattn,
                                   const void* attnout, const void* sm,
                                   void* dqkv, void* delta, void* dcopy,
                                   int b, int n, int heads, int dh,
                                   float scale, int causal, int maybe_dead,
                                   void* stream) {
  if (b <= 0 || n <= 0 || heads <= 0 || n > attention_bwd_max_n(dtype))
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == xclip::kBF16)
    return xclip::launch_k6_bwd<true>(
        XCLIP_PTR(const xclip::bf16*, qkv), m,
        XCLIP_PTR(const xclip::bf16*, attnout), XCLIP_PTR(const float*, sm),
        XCLIP_PTR(const float*, dattn), XCLIP_PTR(xclip::bf16*, dcopy),
        XCLIP_PTR(xclip::bf16*, dqkv), XCLIP_PTR(float*, delta), b, n, heads,
        dh, scale, causal, maybe_dead, st);
  if (dtype != xclip::kF32) return (int)cudaErrorInvalidValue;
  return launch_attention_fma_bwd<kMega>(
      XCLIP_PTR(const float*, qkv), m, XCLIP_PTR(const float*, dattn),
      XCLIP_PTR(const float*, attnout), XCLIP_PTR(const float*, sm),
      XCLIP_PTR(float*, dqkv), XCLIP_PTR(float*, delta), b, n, heads, dh,
      scale, causal, maybe_dead, st);
}

static bool mega_args_ok(int dtype, int b, int n, int dim, int heads,
                         int dh) {
  return !(dim % 64 || b < 0 || n < 0 || heads <= 0 ||
           !xclip::k6_halves(dh) || n > xclip_attention_block_max_n(dtype));
}

// Returns a cudaError_t code (0 on success). x/out are (b, n, dim), mask is
// (b, n) uint8 (nonzero = valid key); w_qkv (dim, 3*heads*dh), w_out
// (heads*dh, dim), dh 64 or 128, gains (dim). Scratch: xn (b*n, dim) and
// proj (b*n, dim)
// fp32; qkv (b*n, 3hd) and attnout (b*n, hd) of the storage dtype, which
// K2 keeps as residuals (K3 "qkv" keeps qkv). K-MEGA passes null residual
// pointers; K2 passes proj_s (b*n x dim, dtype), sm (b*n x 2*heads, fp32: m
// then l per head) and ln_stats (4 x stats_ld, fp32: mean_pre, inv_pre,
// mean_o, inv_o); K3 passes sm and ln_stats.
extern "C" int xclip_attention_block_fwd(
    int dtype, const void* x, const void* g_pre, const void* w_qkv,
    const void* w_out, const void* g_out, const void* mask, void* out,
    void* xn, void* qkv, void* attnout, void* proj, void* proj_s, void* sm,
    void* ln_stats, long long stats_ld, int b, int n, int dim, int heads,
    int dh, float scale, int causal, int maybe_dead, float eps,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mega_args_ok(dtype, b, n, dim, heads, dh) ||
      (ln_stats && stats_ld < (long long)b * n))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return 0;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  XCLIP_DISPATCH(dtype, attention_block_fwd<T>(
      XCLIP_PTR(const T*, x), XCLIP_PTR(const T*, g_pre),
      XCLIP_PTR(const T*, w_qkv), XCLIP_PTR(const T*, w_out),
      XCLIP_PTR(const T*, g_out), m, XCLIP_PTR(T*, out), XCLIP_PTR(T*, xn),
      XCLIP_PTR(T*, qkv), XCLIP_PTR(T*, attnout), XCLIP_PTR(float*, proj), b,
      n, dim, heads, dh, scale, causal, maybe_dead, eps, st,
      XCLIP_PTR(T*, proj_s), XCLIP_PTR(float*, sm),
      XCLIP_PTR(float*, ln_stats), (long)stats_ld));
}

// Bytes of the workspace the K2 backward takes.
extern "C" long long xclip_attention_block_bwd_workspace(int dtype, int b,
                                                         int n, int dim,
                                                         int heads, int dh) {
  xclip::Workspace ws(nullptr);
  if (dtype == xclip::kBF16) {
    MegaBwdBuffers<__nv_bfloat16> sizes(ws, b, n, dim, heads, dh);
  } else {
    MegaBwdBuffers<float> sizes(ws, b, n, dim, heads, dh);
  }
  return (long long)ws.used;
}

// K2 backward. Inputs as saved by the forward plus dout (b*n x dim);
// outputs dx (b*n x dim), dqkv (b*n x 3*heads*dh), dw_qkv, dw_out, dg_pre,
// dg_out, all of the dtype.
extern "C" int xclip_attention_block_bwd(
    int dtype, const void* x, const void* g_pre, const void* w_qkv,
    const void* w_out, const void* g_out, const void* mask, const void* dout,
    const void* qkv, const void* attnout, const void* proj_s, const void* sm,
    const void* ln_stats, void* dx, void* dqkv, void* dw_qkv, void* dw_out,
    void* dg_pre, void* dg_out, void* workspace, int b, int n, int dim,
    int heads, int dh, float scale, int causal, int maybe_dead,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mega_args_ok(dtype, b, n, dim, heads, dh) || b == 0 || n == 0 ||
      n > xclip_attention_block_bwd_max_n(dtype))
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  XCLIP_DISPATCH(dtype, attention_block_bwd<T>(
      XCLIP_PTR(const T*, x), XCLIP_PTR(const T*, g_pre),
      XCLIP_PTR(const T*, w_qkv), XCLIP_PTR(const T*, w_out),
      XCLIP_PTR(const T*, g_out), m, XCLIP_PTR(const T*, dout),
      XCLIP_PTR(const T*, qkv), XCLIP_PTR(const T*, attnout),
      XCLIP_PTR(const T*, proj_s), XCLIP_PTR(const float*, sm),
      XCLIP_PTR(const float*, ln_stats), XCLIP_PTR(T*, dx),
      XCLIP_PTR(T*, dqkv), XCLIP_PTR(T*, dw_qkv), XCLIP_PTR(T*, dw_out),
      XCLIP_PTR(T*, dg_pre), XCLIP_PTR(T*, dg_out), workspace, b, n, dim,
      heads, dh, scale, causal, maybe_dead, st));
}

// Bytes of the workspace the K3 recompute backward takes for b elements.
extern "C" long long xclip_attention_block_bwd_recompute_workspace(
    int dtype, int b, int n, int dim, int heads, int dh, int keep_qkv) {
  xclip::Workspace ws(nullptr);
  if (dtype == xclip::kBF16) {
    RecomputeBuffers<__nv_bfloat16> r(ws, b, n, dim, heads, dh, keep_qkv);
    MegaBwdBuffers<__nv_bfloat16> w(ws, b, n, dim, heads, dh);
  } else {
    RecomputeBuffers<float> r(ws, b, n, dim, heads, dh, keep_qkv);
    MegaBwdBuffers<float> w(ws, b, n, dim, heads, dh);
  }
  return (long long)ws.used;
}

// The K3 backward of one chunk of b batch elements: x, dout, dx (b*n x
// dim), qkv (b*n x 3*heads*dh, the forward's, or null to recompute it) and
// sm (b*n x 2*heads) of the chunk, its columns of the forward's fp32
// ln_stats (4 x stats_ld); dw_qkv, dw_out, dg_pre, dg_out fp32, written
// when acc is 1 and added to when 2.
extern "C" int xclip_attention_block_bwd_recompute(
    int dtype, const void* x, const void* g_pre, const void* w_qkv,
    const void* w_out, const void* g_out, const void* mask, const void* dout,
    const void* qkv, const void* sm, const void* ln_stats,
    long long stats_ld, void* dx, void* dw_qkv, void* dw_out, void* dg_pre,
    void* dg_out, void* workspace, int b, int n, int dim, int heads, int dh,
    float scale, int causal, int maybe_dead, float eps, int acc,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mega_args_ok(dtype, b, n, dim, heads, dh) || b == 0 || n == 0 ||
      n > xclip_attention_block_bwd_max_n(dtype) ||
      stats_ld < (long long)b * n || (acc != 1 && acc != 2))
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  XCLIP_DISPATCH(dtype, attention_block_bwd_recompute<T>(
      XCLIP_PTR(const T*, x), XCLIP_PTR(const T*, g_pre),
      XCLIP_PTR(const T*, w_qkv), XCLIP_PTR(const T*, w_out),
      XCLIP_PTR(const T*, g_out), m, XCLIP_PTR(const T*, dout),
      XCLIP_PTR(const T*, qkv), XCLIP_PTR(const float*, sm),
      XCLIP_PTR(const float*, ln_stats), (long)stats_ld, XCLIP_PTR(T*, dx),
      XCLIP_PTR(float*, dw_qkv), XCLIP_PTR(float*, dw_out),
      XCLIP_PTR(float*, dg_pre), XCLIP_PTR(float*, dg_out), workspace, b, n,
      dim, heads, dh, scale, causal, maybe_dead, eps, acc, st));
}
