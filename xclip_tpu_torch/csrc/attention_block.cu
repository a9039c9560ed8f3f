// K6: whole-head attention on the fused qkv, in place of the Pallas kernels
// of xclip_tpu/kernels/attention_block.py: the forward `_fwd_kernel`
// (reached through `_attention_fwd`) and the backward `_bwd_kernel`
// (through `_attention_bwd`). The text tower takes this route when rotary
// embeddings turn the megablock off (xclip_tpu/nn/layers.py:174-191): the
// PreNorm, the qkv product, the rotation and the output projection stay
// outside, as in JAX, and the kernels see the rotated qkv.
//
// Both are the attention megablock's attention core (attention_core.cuh),
// whose semantics are K6's: scores (q . k) * scale in fp32, -inf on masked
// and future keys, a dead row uniform over the n real keys (m = 0), l =
// max(sum p, 1e-30), p / l cast to the storage dtype before p @ v.
//   * forward: out (b, n, heads*64, T) and the fp32 log-sum-exp per row and
//     head, lse = m + log l (log n on a dead row), (b, n, heads);
//   * backward: from qkv, out, lse and do (b, n, heads*64, T), p = exp(s -
//     lse) (1/n on a dead row), delta = sum do * out, dp = do . vᵀ, ds =
//     T(p (dp - delta) scale), 0 on a dead row; dq = ds . k, dk = dsᵀ . q,
//     dv = T(p)ᵀ . do, written into dqkv in the fused layout. Two kernels
//     (query tiles for dq and delta, key tiles for dk and dv), no atomics.
// The Pallas kernel pads n to 128 and groups two heads into one 128-lane
// block, TPU artefacts; here a block is one (32-query or 64-key tile, head,
// batch element) of the true (b, n, 3*heads*64) tensor.
//
// What bounds it on the card: at the text tower's shape (b 256, n 256, 8
// heads) the exact softmax over full score rows in shared memory and the
// re-staging of k and v per query tile; the products run on wmma, not
// wgmma. Bytes are few (qkv once, out once), so the bound is operations.
#include "attention_core.cuh"

static bool core_args_ok(int b, int n, int heads) {
  return b > 0 && n > 0 && heads > 0;
}

// Returns a cudaError_t code (0 on success). qkv (b*n, 3*heads*64) and out
// (b*n, heads*64) of the storage dtype, mask (b, n) uint8 (nonzero = valid
// key), lse (b*n, heads) fp32.
extern "C" int xclip_attention_core_fwd(int dtype, const void* qkv,
                                        const void* mask, void* out,
                                        void* lse, int b, int n, int heads,
                                        float scale, int causal,
                                        int maybe_dead, void* stream) {
  if (!core_args_ok(b, n, heads) || n > attention_max_n(dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  XCLIP_DISPATCH(dtype, launch_attention<T>(
      XCLIP_PTR(const T*, qkv), m, XCLIP_PTR(T*, out), b, n, heads, scale,
      causal, maybe_dead, nullptr, st, XCLIP_PTR(float*, lse)));
}

// The backward: qkv, out, do (b*n, heads*64) and lse as the forward's;
// dqkv (b*n, 3*heads*64) of the storage dtype; delta (b*n, heads) fp32
// scratch.
extern "C" int xclip_attention_core_bwd(int dtype, const void* qkv,
                                        const void* mask, const void* out,
                                        const void* lse, const void* dout,
                                        void* dqkv, void* delta, int b, int n,
                                        int heads, float scale, int causal,
                                        int maybe_dead, void* stream) {
  if (!core_args_ok(b, n, heads) || n > attention_bwd_max_n(dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  XCLIP_DISPATCH(dtype, (launch_attention_bwd<T, T, true>(
      XCLIP_PTR(const T*, qkv), m, XCLIP_PTR(const T*, dout),
      XCLIP_PTR(const T*, out), XCLIP_PTR(const float*, lse),
      XCLIP_PTR(T*, dqkv), XCLIP_PTR(float*, delta), b, n, heads, scale,
      causal, maybe_dead, st)));
}
