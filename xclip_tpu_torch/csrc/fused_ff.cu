// K8: the GEGLU + inner-LayerNorm middle of the FF block on its own,
//     out = LN_g(a * gelu(b)),   [a, b] = h   (h: rows x 2 inner),
// the route `ff_impl='fused'` takes between the w_in and w_out products
// (which stay plain products, as the JAX package leaves them to XLA):
//   * the forward in place of the Pallas kernel `_fwd_kernel` of
//     xclip_tpu/kernels/fused_ff.py (via `_forward_math`);
//   * the backward in place of `_dg_out_kernel` / `_bwd_kernel`: dh and the
//     gain's gradient dg, the row statistics recomputed from h as the
//     forward took them (nothing is stored between the two).
//
// Cast order (as the Pallas kernels): h read in the storage dtype and
// widened to fp32; prod, the two-pass statistics and the normalisation in
// fp32; out rounded once. The backward takes the cotangent in the storage
// dtype (the wrapper casts it, as `_geglu_ln_bwd` does), writes dh rounded
// once, and sums dg over every row in fp32, cast once.
//
// Design: no shared row tile. The forward is one launch of row_kernels.cuh's
// LayerNorm forward rows with their GEGLU prologue (each row read once into
// registers as 16-byte vectors, a * gelu(b) evaluated once an element, the
// two-pass statistics reduced from there). The backward is row_kernels.cuh's
// GEGLU backward rows in
// their K8 mode (each row read once into registers, the two-pass
// statistics and the cotangent sums reduced from there, 64-row blocks) and
// an ordered sum of the blocks' dg partials (reduce_parts): no float
// atomics, so two runs agree bit for bit.
// The Pallas kernel's row padding to 256-row blocks (and its halved
// backward tile) are TPU artefacts: the kernels stop at the last row.
//
// What bounds it on the card: bytes. The forward reads h once (rows x 2
// inner) and writes out (rows x inner); the backward reads h and do and
// writes dh. The forward evaluates one erf an element, the backward one
// erf and one exp, ~30 fp32 operations, below the card's fp32 rate at
// these byte counts. Both take inner widths up to 8,192 (the row kernels'
// widest row).
#include "common.cuh"

namespace {

template <typename T>
int geglu_ln_fwd(const T* h, const T* g, T* out, int rows, int inner,
                 float eps, cudaStream_t st) {
  return xclip::launch_ln_rows<T, T, true>(h, g, nullptr, out, rows, inner,
                                           eps, st);
}

template <typename T>
int geglu_ln_bwd(const T* h, const T* g, const T* dout, T* dh, T* dg,
                 float* part, int rows, int inner, float eps,
                 cudaStream_t st) {
  using namespace xclip;
  int e;
  if ((e = launch_geglu_bwd_rows<T, T, T, kGegluLn>(
           dout, h, nullptr, nullptr, g, part, rows, inner, dh, st, eps)))
    return e;
  return launch_reduce_parts<T>(part, dg, ln_bwd_blocks(rows), inner, st);
}

}  // namespace

// Returns a cudaError_t code (0 on success). h (rows x 2 inner), g (inner),
// out (rows x inner): dense row-major device buffers of the dtype (0 fp32,
// 1 bf16).
extern "C" int xclip_geglu_ln_fwd(int dtype, const void* h, const void* g,
                                  void* out, int rows, int inner, float eps,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 0 || inner <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  XCLIP_DISPATCH(dtype, geglu_ln_fwd<T>(
      XCLIP_PTR(const T*, h), XCLIP_PTR(const T*, g), XCLIP_PTR(T*, out),
      rows, inner, eps, st));
}

// Bytes of the backward's workspace: the fp32 dg partials of its 64-row
// blocks.
extern "C" long long xclip_geglu_ln_bwd_workspace(int rows, int inner) {
  return (long long)xclip::ln_bwd_blocks(rows) * inner * sizeof(float);
}

// The backward: h (rows x 2 inner), g (inner) and dout (rows x inner) →
// dh (rows x 2 inner) and dg (inner), all of the dtype.
extern "C" int xclip_geglu_ln_bwd(int dtype, const void* h, const void* g,
                                  const void* dout, void* dh, void* dg,
                                  void* workspace, int rows, int inner,
                                  float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || inner <= 0) return (int)cudaErrorInvalidValue;
  XCLIP_DISPATCH(dtype, geglu_ln_bwd<T>(
      XCLIP_PTR(const T*, h), XCLIP_PTR(const T*, g),
      XCLIP_PTR(const T*, dout), XCLIP_PTR(T*, dh), XCLIP_PTR(T*, dg),
      static_cast<float*>(workspace), rows, inner, eps, st));
}
