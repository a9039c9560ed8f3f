// K7: FlashAttention-2 forward and backward, in place of the Pallas kernels
// of xclip_tpu/kernels/flash_attention.py: the forward `_fwd_kernel`
// (reached through `_flash_forward`) and the backward `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (through `_flash_backward`). The route of
// `attn_impl='flash'`, and the long-sequence one: no score row is ever
// whole, so the length has no limit.
//
// Shapes: q, k, v, out (bh, n, d) of the storage dtype, q pre-scaled (d
// in bf16 any multiple of 8 up to 256, read at its true width as ⌈d / 64⌉
// 64-column halves; in fp32 64 or 128); the
// key mask (bh, n) uint8 (nonzero = valid), already repeated per head; n a
// multiple of 64 (the wrapper pads, masking the padded keys); lse and
// delta (bh, n) fp32.
//
// Forward: the online softmax over 64-key tiles in fp32, as the Pallas
// kernel's (per row: m_new = max(m, max s), m_safe = 0 where m_new = -inf,
// p = exp(s - m_safe) and 0 on masked entries, correction = 0 where m =
// -inf else exp(m - m_safe), l = l * correction + sum p, acc = acc *
// correction + T(p) . v). At the end l = max(l, 1e-30), out = T(acc / l),
// lse = m_safe + log l: a row with no valid key gives 0 and log 1e-30.
// Key tiles wholly past the query tile (causal) or with no valid key are
// skipped: their p is 0, so they would change nothing.
// Backward: p = exp(s - lse), 0 on masked entries; ds = p (dp - delta),
// dp = dO . vᵀ, delta = sum dO * O per row.
//   * dq kernel, one block per (bh, 64-query tile), looping over key
//     tiles: dq = sum T(ds) . k;
//   * dk/dv kernel, one block per (bh, 64-key tile), looping over query
//     tiles: dv = sum T(p)ᵀ . dO, dk = sum T(ds)ᵀ . q.
// Each owns its outputs: no atomics, two runs agree bit for bit.
//
// bf16 runs the kernels of flash_attention_sm90.cuh (register-resident
// mma.sync tiles on a cp.async ring that skip causal and all-masked key
// tiles, delta computed in the dq kernel; their note gives the design and
// what bounds it). fp32 runs the attention core's tiled FMA kernels
// (attention_core.cuh), forward and backward, in their K7 mode: K6's with
// scale 1 and no dead-row rule, on the separate (bh, n, d) tensors, a 1-D
// grid over bh x tiles, each tile's mask word read as it is walked, causal
// and all-masked tiles skipped, delta computed in the dq kernel, no length
// limit (that file's note gives the design and what bounds it).
#include "attention_core.cuh"
#include "flash_attention_sm90.cuh"

using xclip::bf16;

// bh, n and d as the kernels take them: n a multiple of 64, d as
// bf16_halves (bf16) or f32_halves (fp32) takes it; bf16 puts the query
// tiles on its grid's y axis (at most 65,535 of them), fp32 has a 1-D grid
// over bh x tiles.
static bool flash_args_ok(int dtype, int bh, int n, int d) {
  if (bh <= 0 || n <= 0 || n % 64) return false;
  if (!(dtype == xclip::kBF16 ? xclip::bf16_halves(d) : xclip::f32_halves(d)))
    return false;
  return dtype == xclip::kF32 || n / 64 <= 65535;
}

// Returns a cudaError_t code (0 on success). q (pre-scaled), k, v, out
// (bh, n, d) of the storage dtype (d: flash_args_ok); mask (bh, n) uint8; lse
// (bh, n) fp32.
extern "C" int xclip_flash_fwd(int dtype, const void* q, const void* k,
                               const void* v, const void* mask, void* out,
                               void* lse, int bh, int n, int d, int causal,
                               void* stream) {
  if (!flash_args_ok(dtype, bh, n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == xclip::kBF16)
    return xclip::launch_k7_fwd(
        XCLIP_PTR(const bf16*, q), XCLIP_PTR(const bf16*, k),
        XCLIP_PTR(const bf16*, v), m, XCLIP_PTR(bf16*, out),
        XCLIP_PTR(float*, lse), bh, n, d, causal, st);
  if (dtype != xclip::kF32) return (int)cudaErrorInvalidValue;
  return launch_fma_fwd<kK7>(
      XCLIP_PTR(const float*, q), XCLIP_PTR(const float*, k),
      XCLIP_PTR(const float*, v), d, m, XCLIP_PTR(float*, out),
      XCLIP_PTR(float*, lse), bh, n, 1, d, 1.f, causal, 0, st);
}

// The backward: q, k, v, mask, lse, d as the forward's; out and dout (bh,
// n, d); delta (bh, n) fp32 scratch the dq kernel fills with sum dout * out
// for the dk/dv kernel; dq, dk, dv (bh, n, d). fp32: every tensor 16-byte
// aligned, the mask 8-byte aligned.
extern "C" int xclip_flash_bwd(int dtype, const void* q, const void* k,
                               const void* v, const void* mask,
                               const void* out, const void* dout,
                               const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int bh, int n, int d,
                               int causal, void* stream) {
  if (!flash_args_ok(dtype, bh, n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == xclip::kBF16)
    return xclip::launch_k7_bwd(
        XCLIP_PTR(const bf16*, q), XCLIP_PTR(const bf16*, k),
        XCLIP_PTR(const bf16*, v), m, XCLIP_PTR(const bf16*, out),
        XCLIP_PTR(const float*, lse), XCLIP_PTR(const bf16*, dout),
        XCLIP_PTR(bf16*, dq), XCLIP_PTR(bf16*, dk), XCLIP_PTR(bf16*, dv),
        XCLIP_PTR(float*, delta), bh, n, d, causal, st);
  if (dtype != xclip::kF32) return (int)cudaErrorInvalidValue;
  return launch_fma_bwd<kK7>(
      XCLIP_PTR(const float*, q), XCLIP_PTR(const float*, k),
      XCLIP_PTR(const float*, v), d, m, XCLIP_PTR(const float*, dout),
      XCLIP_PTR(const float*, out), XCLIP_PTR(const float*, lse),
      XCLIP_PTR(float*, dq), XCLIP_PTR(float*, dk), XCLIP_PTR(float*, dv),
      XCLIP_PTR(float*, delta), bh, n, 1, d, 1.f, causal, 0, st);
}

// Blocks an SM of the fp32 forward in K7's mode at head width d (64: 256
// threads a block; 128: 512); a negative cudaError_t code on failure.
extern "C" int xclip_flash_fwd_blocks(int d) {
  return attention_blocks<kK7>(-1, d);
}

// Blocks an SM of the fp32 backward's dq (`which` 0) or dk/dv (1) kernel
// in K7's mode at head width d (as the forward's); a negative cudaError_t
// code on failure.
extern "C" int xclip_flash_bwd_blocks(int which, int d) {
  return attention_blocks<kK7>(which, d);
}
