// K6: whole-head attention on the fused qkv, in place of the Pallas kernels
// of xclip_tpu/kernels/attention_block.py: the forward `_fwd_kernel`
// (reached through `_attention_fwd`) and the backward `_bwd_kernel`
// (through `_attention_bwd`). The text tower takes this route when rotary
// embeddings turn the megablock off (xclip_tpu/nn/layers.py:174-191): the
// PreNorm, the qkv product, the rotation and the output projection stay
// outside, as in JAX, and the kernels see the rotated qkv.
//
// Semantics: scores (q . k) * scale in fp32, -inf on masked and future
// keys, a dead row uniform over the n real keys (m = 0), l = max(sum p,
// 1e-30), p / l cast to the storage dtype before p @ v.
//   * forward: out (b, n, heads*dh, T) and the fp32 log-sum-exp per row and
//     head, lse = m + log l (log n on a dead row), (b, n, heads);
//   * backward: from qkv, out, lse and do (b, n, heads*dh, T), p = exp(s -
//     lse) (1/n on a dead row), delta = sum do * out, dp = do . vᵀ, ds =
//     T(p (dp - delta) scale), 0 on a dead row; dq = ds . k, dk = dsᵀ . q,
//     dv = T(p)ᵀ . do, written into dqkv in the fused layout. Two kernels
//     (query tiles for dq and delta, key tiles for dk and dv), no atomics.
// The Pallas kernel pads n to 128 and groups two heads into one 128-lane
// block, TPU artefacts; here a block is one (64-row tile, head, batch
// element) of the true (b, n, 3*heads*dh) tensor: in bf16 dh any multiple
// of 8 up to 256, read at its true width as ⌈dh / 64⌉ 64-column halves; in
// fp32 dh 64 or 128.
//
// bf16 runs the kernels of attention_block_sm90.cuh in their K6 mode
// (register-resident mma.sync tiles at one, three and four halves, a
// TMA-fed wgmma forward and dq kernel at two; all skip causal and masked
// tiles; their notes give the design and what bounds it), which the
// attention megablock's bf16 core shares. fp32 runs the megablock's FMA core
// (attention_core.cuh). The length limit is the megablock's own, n <= 2048
// in both dtypes (the mask words of 32 key tiles).
#include "attention_core.cuh"

static bool core_args_ok(int dtype, int b, int n, int heads, int dh) {
  return b > 0 && n > 0 && heads > 0 &&
         (dtype == xclip::kBF16 ? xclip::bf16_halves(dh)
                                : xclip::f32_halves(dh));
}

// Returns a cudaError_t code (0 on success). qkv (b*n, 3*heads*dh) and out
// (b*n, heads*dh) of the storage dtype (dh: core_args_ok), mask (b, n) uint8
// (nonzero = valid key), lse (b*n, heads) fp32.
extern "C" int xclip_attention_core_fwd(int dtype, const void* qkv,
                                        const void* mask, void* out,
                                        void* lse, int b, int n, int heads,
                                        int dh, float scale, int causal,
                                        int maybe_dead, void* stream) {
  if (!core_args_ok(dtype, b, n, heads, dh) || n > attention_max_n(dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == xclip::kBF16)
    return xclip::launch_k6_fwd<false>(XCLIP_PTR(const xclip::bf16*, qkv), m,
                                       XCLIP_PTR(xclip::bf16*, out),
                                       XCLIP_PTR(float*, lse), b, n, heads,
                                       dh, scale, causal, maybe_dead, st);
  if (dtype != xclip::kF32) return (int)cudaErrorInvalidValue;
  return launch_attention<float>(XCLIP_PTR(const float*, qkv), m,
                                 XCLIP_PTR(float*, out), b, n, heads, dh,
                                 scale, causal, maybe_dead, nullptr, st,
                                 XCLIP_PTR(float*, lse));
}

// The backward: qkv, out, do (b*n, heads*dh) and lse as the forward's;
// dqkv (b*n, 3*heads*dh) of the storage dtype; delta (b*n, heads) fp32
// scratch.
extern "C" int xclip_attention_core_bwd(int dtype, const void* qkv,
                                        const void* mask, const void* out,
                                        const void* lse, const void* dout,
                                        void* dqkv, void* delta, int b, int n,
                                        int heads, int dh, float scale,
                                        int causal, int maybe_dead,
                                        void* stream) {
  if (!core_args_ok(dtype, b, n, heads, dh) ||
      n > attention_bwd_max_n(dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == xclip::kBF16)
    return xclip::launch_k6_bwd<false>(
        XCLIP_PTR(const xclip::bf16*, qkv), m,
        XCLIP_PTR(const xclip::bf16*, out), XCLIP_PTR(const float*, lse),
        XCLIP_PTR(const xclip::bf16*, dout), nullptr,
        XCLIP_PTR(xclip::bf16*, dqkv), XCLIP_PTR(float*, delta), b, n, heads,
        dh, scale, causal, maybe_dead, st);
  if (dtype != xclip::kF32) return (int)cudaErrorInvalidValue;
  return launch_attention_fma_bwd<kK6>(
      XCLIP_PTR(const float*, qkv), m, XCLIP_PTR(const float*, dout),
      XCLIP_PTR(const float*, out), XCLIP_PTR(const float*, lse),
      XCLIP_PTR(float*, dqkv), XCLIP_PTR(float*, delta), b, n, heads, dh,
      scale, causal, maybe_dead, st);
}

// Blocks an SM (with `warps` nonzero: warps an SM) of the backward's
// kernels of dtype code `dtype` at head width dh, K6's (mode 1) or the
// megablock's (mode 0): dq (`which` 0) or dk/dv (1), as their launches
// configure them (fp32 at 64: 256 threads a block, at 128: 512; bf16:
// attention_block_sm90.cuh's kernel at that width); a negative cudaError_t
// code on failure.
extern "C" int xclip_attention_bwd_blocks(int dtype, int mode, int which,
                                          int dh, int warps) {
  if (dtype == xclip::kBF16)
    return mode == kK6 ? xclip::k6_blocks<false>(which, dh, warps)
                       : xclip::k6_blocks<true>(which, dh, warps);
  if (dtype != xclip::kF32) return -(int)cudaErrorInvalidValue;
  const int blocks = mode == kK6 ? attention_blocks<kK6>(which, dh)
                                 : attention_blocks<kMega>(which, dh);
  return warps && blocks > 0 ? blocks * 8 * xclip::f32_halves(dh) : blocks;
}

// The same for the forward, K6's (lse 1) or the megablock's (lse 0).
extern "C" int xclip_attention_fwd_blocks(int dtype, int lse, int dh,
                                          int warps) {
  if (dtype == xclip::kBF16)
    return lse ? xclip::k6_blocks<false>(-1, dh, warps)
               : xclip::k6_blocks<true>(-1, dh, warps);
  if (dtype != xclip::kF32) return -(int)cudaErrorInvalidValue;
  const int blocks = lse ? attention_blocks<kK6>(-1, dh)
                         : attention_blocks<kMega>(-1, dh);
  return warps && blocks > 0 ? blocks * 8 * xclip::f32_halves(dh) : blocks;
}
