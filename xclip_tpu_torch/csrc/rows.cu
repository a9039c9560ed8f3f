// The row kernels of row_kernels.cuh alone, mode by mode, for tests and
// timing (kernels/rows.py): the LayerNorm forward rows, the GEGLU backward
// rows and the LayerNorm backward rows, which the FF blocks, K8 and the
// attention megablock launch inside their own entry points; the ordered
// sums of partials (common.cuh launch_emit_sum) alone. Also the kernels'
// launch counters, counted by every caller.
#include "common.cuh"

namespace xclip {
long long g_row_launches[kRowCounters];
SumSite g_sum_sites[kSumSites];
long long g_sum_unrecorded = 0;
}  // namespace xclip

namespace {

// The input types each mode's callers give it: the recompute mode fp32 h
// and dy, K8's T h and dy, the stored-h mode T h and fp32 dy.
template <typename T>
int geglu_rows(int mode, const void* dy, const void* h, const float* mean,
               const float* inv, const T* g, float* dg_part, int rows, int d,
               float eps, T* dh, T* y, T* dprod, T* dh2, cudaStream_t st) {
  using namespace xclip;
  switch (mode) {
    case kGegluRecompute:
      return launch_geglu_bwd_rows<float, float, T, kGegluRecompute>(
          static_cast<const float*>(dy), static_cast<const float*>(h), mean,
          inv, g, dg_part, rows, d, dh, st, 0.f, y);
    case kGegluLn:
      return launch_geglu_bwd_rows<T, T, T, kGegluLn>(
          static_cast<const T*>(dy), static_cast<const T*>(h), nullptr,
          nullptr, g, dg_part, rows, d, dh, st, eps);
    case kGegluStoredH:
      return launch_geglu_bwd_rows<T, float, T, kGegluStoredH>(
          static_cast<const float*>(dy), static_cast<const T*>(h), mean, inv,
          g, dg_part, rows, d, dh, st, 0.f, y, dprod, dh2);
  }
  return (int)cudaErrorInvalidValue;
}

// kLnBwd as its callers give it: fp32 dy and T v (the pre-LayerNorms), T dy
// and T or fp32 v (the megablock's out LayerNorm, K2 and K3); kLnBwdGeglu
// fp32 dy and the T product.
template <typename T>
int ln_rows(int mode, int dy_f32, int v_f32, const void* dy, const void* v,
            const float* mean, const float* inv, const T* g, const T* resid,
            T* out, float* dg_part, int rows, int d, T* xn_out, const T* gb,
            const T* agdb, T* dh, T* dh2, T* y2, cudaStream_t st) {
  using namespace xclip;
  const float* dy32 = static_cast<const float*>(dy);
  const T* dyT = static_cast<const T*>(dy);
  const T* vT = static_cast<const T*>(v);
  if (mode == kLnBwdGeglu && dy_f32 && !v_f32)
    return launch_ln_bwd_rows<float, T, T, kLnBwdGeglu>(
        dy32, vT, mean, inv, g, nullptr, out, dg_part, rows, d, st, nullptr,
        gb, agdb, dh, dh2, y2);
  if (mode != kLnBwd) return (int)cudaErrorInvalidValue;
  if (dy_f32 && !v_f32)
    return launch_ln_bwd_rows<float, T, T, kLnBwd>(
        dy32, vT, mean, inv, g, resid, out, dg_part, rows, d, st, xn_out);
  if (!dy_f32 && !v_f32)
    return launch_ln_bwd_rows<T, T, T, kLnBwd>(
        dyT, vT, mean, inv, g, resid, out, dg_part, rows, d, st, xn_out);
  if (!dy_f32 && v_f32)
    return launch_ln_bwd_rows<T, float, T, kLnBwd>(
        dyT, static_cast<const float*>(v), mean, inv, g, resid, out,
        dg_part, rows, d, st, xn_out);
  return (int)cudaErrorInvalidValue;
}

// The LayerNorm forward as its callers give it: T rows (the pre-LayerNorms),
// fp32 rows (the FF inner LayerNorm, the megablock's out LayerNorm), or T
// rows [a, b] twice as wide with the GEGLU prologue (K8).
template <typename T>
int ln_fwd(int in_f32, int geglu, const void* in, const T* g, const T* resid,
           T* out, int rows, int d, float eps, float* mean, float* inv,
           T* in_copy, cudaStream_t st) {
  using namespace xclip;
  if (geglu && in_f32 && !std::is_same<T, float>::value)
    return (int)cudaErrorInvalidValue;
  if (geglu)
    return launch_ln_rows<T, T, true>(static_cast<const T*>(in), g, resid,
                                      out, rows, d, eps, st, mean, inv,
                                      in_copy);
  if (in_f32)
    return launch_ln_rows<float, T>(static_cast<const float*>(in), g, resid,
                                    out, rows, d, eps, st, mean, inv,
                                    in_copy);
  return launch_ln_rows<T, T>(static_cast<const T*>(in), g, resid, out, rows,
                              d, eps, st, mean, inv, in_copy);
}

}  // namespace

// Returns a cudaError_t code (0 on success). The LayerNorm forward rows:
// in (rows x d; rows x 2d with `geglu`) fp32 when in_f32, else of the
// dtype (0 fp32, 1 bf16), as g, resid, out and in_copy (rows x d); mean,
// inv (rows) fp32. resid, mean / inv and in_copy are optional (null), and
// the call's mode (row_kernels.cuh kLnFwd*) follows from which are given.
extern "C" int xclip_ln_fwd_rows(int dtype, int in_f32, int geglu,
                                 const void* in, const void* g,
                                 const void* resid, void* out, int rows,
                                 int d, float eps, void* mean, void* inv,
                                 void* in_copy, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || (mean == nullptr) != (inv == nullptr))
    return (int)cudaErrorInvalidValue;
  XCLIP_DISPATCH(dtype, ln_fwd<T>(
      in_f32, geglu, in, XCLIP_PTR(const T*, g), XCLIP_PTR(const T*, resid),
      XCLIP_PTR(T*, out), rows, d, eps, static_cast<float*>(mean),
      static_cast<float*>(inv), XCLIP_PTR(T*, in_copy), st));
}

// Returns a cudaError_t code (0 on success). `mode` is row_kernels.cuh's
// kGegluRecompute / kGegluLn / kGegluStoredH; the outputs (dh rows x 2d; y,
// dprod rows x d; dh2 rows x 2d, or dh itself to skip it) and g are of
// the dtype (0 fp32, 1 bf16), dy and h as geglu_rows says; mean, inv (rows)
// fp32; dg_part (ln_bwd_blocks(rows) x d) fp32, one partial per 64-row
// block.
extern "C" int xclip_geglu_bwd_rows(int mode, int dtype, const void* dy,
                                    const void* h, const void* mean,
                                    const void* inv, const void* g,
                                    void* dg_part, int rows, int d, float eps,
                                    void* dh, void* y, void* dprod, void* dh2,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  XCLIP_DISPATCH(dtype, geglu_rows<T>(
      mode, dy, h, static_cast<const float*>(mean),
      static_cast<const float*>(inv), XCLIP_PTR(const T*, g),
      static_cast<float*>(dg_part), rows, d, eps, XCLIP_PTR(T*, dh),
      XCLIP_PTR(T*, y), XCLIP_PTR(T*, dprod), XCLIP_PTR(T*, dh2), st));
}

// As xclip_geglu_bwd_rows for the LayerNorm backward rows: `mode` kLnBwd or
// kLnBwdGeglu; dy fp32 when dy_f32 (else the dtype), v likewise; resid and
// xn_out optional (kLnBwd); gb, agdb, dh, dh2, y2 for kLnBwdGeglu.
extern "C" int xclip_ln_bwd_rows(int mode, int dtype, int dy_f32, int v_f32,
                                 const void* dy, const void* v,
                                 const void* mean, const void* inv,
                                 const void* g, const void* resid, void* out,
                                 void* dg_part, int rows, int d, void* xn_out,
                                 const void* gb, const void* agdb, void* dh,
                                 void* dh2, void* y2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  XCLIP_DISPATCH(dtype, ln_rows<T>(
      mode, dy_f32, v_f32, dy, v, static_cast<const float*>(mean),
      static_cast<const float*>(inv), XCLIP_PTR(const T*, g),
      XCLIP_PTR(const T*, resid), XCLIP_PTR(T*, out),
      static_cast<float*>(dg_part), rows, d, XCLIP_PTR(T*, xn_out),
      XCLIP_PTR(const T*, gb), XCLIP_PTR(const T*, agdb), XCLIP_PTR(T*, dh),
      XCLIP_PTR(T*, dh2), XCLIP_PTR(T*, y2), st));
}

// The ordered sum every backward's split-k and dg partials take
// (common.cuh launch_emit_sum), alone: out (n) = (acc == 2 ? out : 0) +
// part[0][i] + part[1][i] + ..., in order, written in fp32 (acc 1, 2) or
// rounded to `dtype` (acc 0).
extern "C" int xclip_reduce_parts(int dtype, const void* part, void* out,
                                  int parts, long long n, int acc,
                                  void* stream) {
  if (parts < 1 || n < 1 || acc < 0 || acc > 2)
    return (int)cudaErrorInvalidValue;
  if (acc != 0 && dtype != xclip::kF32) return (int)cudaErrorInvalidValue;
  XCLIP_DISPATCH(dtype, xclip::launch_emit_sum<T>(
      static_cast<const float*>(part), out, parts, (long)n, acc,
      static_cast<cudaStream_t>(stream)));
}

// The ordered sums' launches by (regime, width) from every caller
// (common.cuh g_sum_sites): up to `cap` widths into n[], wide[] (1: the
// wide kernel) and launches[]; returns how many, or -1 when a launch went
// unrecorded (more widths than the table holds). `reset` empties the
// table.
extern "C" long long xclip_sum_launches(long long* n, int* wide,
                                        long long* launches, int cap,
                                        int reset) {
  long long k = xclip::g_sum_unrecorded ? -1 : 0;
  for (xclip::SumSite& s : xclip::g_sum_sites) {
    if (s.launches == 0) break;
    if (k >= 0 && k < cap) {
      n[k] = s.n;
      wide[k] = s.wide;
      launches[k] = s.launches;
      ++k;
    }
  }
  if (reset) {
    for (xclip::SumSite& s : xclip::g_sum_sites) s = xclip::SumSite{};
    xclip::g_sum_unrecorded = 0;
  }
  return k;
}

// Launches of row kernel `counter` (the GEGLU modes 0-2, then kLnBwd,
// kLnBwdGeglu, then the LayerNorm forward's kLnFwdPlain, kLnFwdStats,
// kLnFwdResidual, kLnFwdInCopy, kLnFwdGeglu) by every caller since the
// library was loaded or last reset;
// `reset` sets it to 0 after reading it.
extern "C" long long xclip_rows_launches(int counter, int reset) {
  if (counter < 0 || counter >= xclip::kRowCounters) return -1;
  const long long n = xclip::g_row_launches[counter];
  if (reset) xclip::g_row_launches[counter] = 0;
  return n;
}
