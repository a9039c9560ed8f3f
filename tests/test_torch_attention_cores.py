"""The plain versions of K6 (whole-head attention on the fused qkv,
`xclip_tpu_torch.kernels.attention_block`) and K7 (FlashAttention,
`xclip_tpu_torch.kernels.flash_attention`) against the JAX package's Pallas
kernels in interpret mode, on the same numpy-seeded inputs: the output and
the gradient of a sum of squares of it.

fp32; tolerances: outputs 1e-5 absolute (|out| < 4: summation order only),
gradients 1e-4 absolute (sums over n keys or queries of O(1) terms, in
another order). Key masks: none; a right-padded row and a left-padded row;
the same with one batch element all masked (dead rows: K6 gives uniform
weights, K7 zeros); the same with a third element's middle half masked
(whole 64-key tiles masked between valid keys at n = 257 and 200).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.kernels import attention_block as jcore
from xclip_tpu.kernels import flash_attention as jflash
from xclip_tpu_torch.kernels import attention_block as core
from xclip_tpu_torch.kernels import flash_attention as flash

from torch_port_inputs import core_args, flash_args
import torch_one_thread  # noqa: F401

OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4

jax.config.update("jax_default_matmul_precision", "highest")


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("mask_kind", ["none", "keypad", "dead", "holes"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [33, 257])
def test_attention_core_matches_pallas(n, causal, mask_kind):
    qkv, mask, _ = core_args(n=n, mask_kind=mask_kind)
    maybe_dead = mask_kind != "none"
    scale = 64 ** -0.5

    def f(x):
        return jcore.attention_core(x, jnp.asarray(mask), 2, 64, scale,
                                    causal, True, maybe_dead)

    want = f(jnp.asarray(qkv))
    want_grad = jax.grad(lambda x: jnp.sum(f(x) ** 2))(jnp.asarray(qkv))
    tq = torch.from_numpy(qkv).requires_grad_(True)
    got = core.attention_core(tq, torch.from_numpy(mask), 2, 64, scale,
                              causal, maybe_dead)
    (got ** 2).sum().backward()
    _close(got, want, OUT_ATOL)
    _close(tq.grad, want_grad, GRAD_ATOL)
    if mask_kind == "dead":   # uniform weights over the n keys, no gradient
        v = qkv[-1, :, 256:]  # reaches a dead row's scores
        _close(got[-1], np.broadcast_to(v.reshape(n, 128).mean(0), (n, 128)),
               OUT_ATOL)


def test_attention_core_lse_matches_pallas():
    """The forward's second output: lse = m + log l per row and head (log n
    on a dead row)."""
    qkv, mask, _ = core_args(n=40, mask_kind="dead")
    _, (_, _, _, lse) = jcore._attention_fwd(
        jnp.asarray(qkv), jnp.asarray(mask), 2, 64, 0.125, True, True, True)
    want = np.asarray(lse)[0, :, :40, :]             # (b, n, heads)
    _, got = core.attention_core_fwd(torch.from_numpy(qkv),
                                     torch.from_numpy(mask), 2, 64, 0.125,
                                     True)
    _close(got, want, OUT_ATOL)
    np.testing.assert_allclose(got[-1].numpy(), np.log(40), rtol=1e-6)


@pytest.mark.parametrize("heads,dim_head,ok", [(2, 64, True), (8, 64, True),
                                               (3, 64, False),
                                               (1, 128, True)])
def test_supported_matches_jax(heads, dim_head, ok):
    assert core.supported(heads, dim_head) == jcore.supported(
        heads, dim_head) == ok


@pytest.mark.parametrize("mask_kind", ["none", "keypad", "dead", "holes"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [37, 200])
def test_flash_attention_matches_pallas(n, causal, mask_kind):
    q, k, v, mask, _ = flash_args(n=n, mask_kind=mask_kind)
    jmask = None if mask_kind == "none" else jnp.asarray(mask)
    tmask = None if mask_kind == "none" else torch.from_numpy(mask)

    def f(q, k, v):
        return jflash.flash_attention(q, k, v, mask=jmask, causal=causal,
                                      interpret=True)

    args = [jnp.asarray(t) for t in (q, k, v)]
    want = f(*args)
    want_grads = jax.grad(lambda *a: jnp.sum(f(*a) ** 2),
                          argnums=(0, 1, 2))(*args)
    tensors = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    got = flash.flash_attention(*tensors, mask=tmask, causal=causal)
    (got ** 2).sum().backward()
    assert got.shape == q.shape
    _close(got, want, OUT_ATOL)
    for t, w in zip(tensors, want_grads):
        _close(t.grad, w, GRAD_ATOL)
    if mask_kind == "dead":   # a row with no valid key gives 0
        assert not got[-1].detach().abs().any()


def test_flash_lse_of_a_dead_row():
    """lse = m_safe + log l: log 1e-30 on a row with no valid key, as the
    Pallas forward's."""
    q, k, v, mask, _ = flash_args(b=2, h=1, n=64, mask_kind="dead")
    key = mask.reshape(2, 1, 64).astype(np.int32)
    _, want = jflash._flash_forward(
        *(jnp.asarray(t.reshape(2, 64, 64)) for t in (q, k, v)),
        jnp.asarray(key), False, 64, 64, True)
    _, got = flash.flash_attention_fwd(
        *(torch.from_numpy(t.reshape(2, 64, 64)) for t in (q, k, v)),
        torch.from_numpy(mask), False)
    _close(got, np.asarray(want)[..., 0], OUT_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.log(np.float32(1e-30)),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_masked_key_tiles_change_nothing(dtype):
    """The bf16 kernels skip every 64-key tile with no valid key (forward,
    dq) and write zero dk, dv for it (dk/dv): exact, because over such a
    tile the plain recurrence leaves m, l and acc bit-equal. Keys 64..127
    masked in every bh row (n = 256, non-causal): the plain forward with
    the kernels' 64-key block gives bit for bit the out and lse of those
    keys deleted, and the plain backward gives their dk, dv rows of 0."""
    q, k, v, mask, do = flash_args(b=2, h=2, n=256, mask_kind="keypad")
    q, k, v, do = (torch.from_numpy(t.reshape(4, 256, 64)).to(dtype)
                   for t in (q, k, v, do))
    key = torch.from_numpy(mask).repeat_interleave(2, 0)
    key[:, 64:128] = False
    out, lse = flash.flash_attention_fwd_plain(q, k, v, key, block_k=64)
    kept = torch.cat([torch.arange(64), torch.arange(128, 256)])
    # every query row against the kept keys (rows 64..127 in a second call)
    for rows in (kept, torch.cat([torch.arange(64, 128), torch.arange(128)])):
        want_out, want_lse = flash.flash_attention_fwd_plain(
            q[:, rows], k[:, kept], v[:, kept], key[:, kept], block_k=64)
        assert torch.equal(out[:, rows], want_out)
        assert torch.equal(lse[:, rows], want_lse)
    _, dk, dv = flash.flash_attention_bwd_plain(q, k, v, key, out, lse, do)
    assert dk[:, kept].any() and dv[:, kept].any()
    assert not dk[:, 64:128].any() and not dv[:, 64:128].any()


@pytest.mark.parametrize("block", [64, 128])
def test_flash_plain_forward_blocks(block):
    """The plain forward's online softmax over key blocks of `block`
    (the kernels' 64 or the Pallas default 128) against the Pallas forward
    at the same block, and the block changes the result only by fp32
    rounding."""
    q, k, v, mask, _ = flash_args(b=2, h=1, n=256, mask_kind="keypad")
    key = mask.reshape(2, 1, 256).astype(np.int32)
    flat = [t.reshape(2, 256, 64) for t in (q, k, v)]
    want, _ = jflash._flash_forward(*(jnp.asarray(t) for t in flat),
                                    jnp.asarray(key), True, block, block,
                                    True)
    got, _ = flash.flash_attention_fwd_plain(
        *(torch.from_numpy(t) for t in flat), torch.from_numpy(mask), True,
        block)
    _close(got, want, OUT_ATOL)


@pytest.mark.parametrize("n,n_pad", [(32, 64), (37, 64), (64, 64),
                                     (200, 256), (256, 256)])
def test_flash_pads_to_the_kernel_tile(n, n_pad):
    """`pad_flat` hands the kernels (b·h, n_pad, d) tensors, n padded to
    `KERNEL_BLOCK` (not the Pallas 128 block) with the padded keys masked
    and the key mask repeated per head; `flash_attention` slices the
    padded rows off again."""
    q, k, v, mask, _ = flash_args(b=2, h=3, n=n, mask_kind="keypad")
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    (fq, fk, fv), key_valid = flash.pad_flat((tq, tk, tv),
                                             torch.from_numpy(mask))
    assert fq.shape == (6, n_pad, 64) and key_valid.shape == (6, n_pad)
    assert not key_valid[:, n:].any() and not fq[:, n:].any()
    torch.testing.assert_close(key_valid[:, :n],
                               torch.from_numpy(mask).repeat_interleave(3, 0))
    torch.testing.assert_close(fk.reshape(2, 3, n_pad, 64)[:, :, :n], tk)
    out = flash.flash_attention(tq, tk, tv, mask=torch.from_numpy(mask))
    want, _ = flash.flash_attention_fwd_plain(fq, fk, fv, key_valid)
    torch.testing.assert_close(out, want.reshape(2, 3, n_pad, 64)[:, :, :n],
                               rtol=0, atol=0)
