"""The port's training kernels (K1, K2) against the JAX package's Pallas
kernels, on the CPU.

Each wrapper runs its kernel's plain version here, so these hold the plain
forwards and backwards (the kernels' cast order written in PyTorch) to
`xclip_tpu.kernels.fused_ff_block.ff_block(..., store_h='geglu')` and
`xclip_tpu.kernels.attention_megablock.attention_block(...,
store_qkv=True)` in Pallas interpret mode: the stored residuals and
statistics of the forward, and every gradient through the autograd
Functions against `jax.grad`. Inputs come from a numpy seed.

Tolerances: fp32 outputs and statistics 1e-4 absolute (summation order
only); fp32 gradients rtol 1e-3 with atol 1e-5 times the leaf's largest
magnitude (a dW is a sum over every row); bf16 two storage ulps of the
compared tensor's largest magnitude, since both sides round at the same
places and only summation order can flip a rounding.

`test_torch_cuda.py` holds the CUDA kernels to the plain versions on a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.kernels import attention_megablock as jmega
from xclip_tpu.kernels import fused_ff_block as jff
from xclip_tpu_torch.kernels import attention_megablock as mega
from xclip_tpu_torch.kernels import fused_ff_block as ffb

from torch_port_inputs import ff_args, mega_args, to_np, to_torch
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")


def _ulps2(want):
    """Two bf16 ulps at the largest magnitude of `want`."""
    top = float(np.abs(want).max())
    return 2 * 2.0 ** (np.floor(np.log2(max(top, 2.0 ** -20))) - 7)


def _close(got, want, dtype, what=""):
    got, want = to_np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = 1e-4 if dtype == "float32" else _ulps2(want)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


def _close_grad(got, want, dtype, what=""):
    got, want = to_np(got), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * scale,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=_ulps2(want),
                                   err_msg=what)


def _cot(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------------ K1

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ff_block_fwd_stored_matches_pallas(dtype):
    rows = 70
    args = ff_args(R=rows, D=64, I=128)
    out, res = jff._ff_block_fwd(*(jnp.asarray(a, dtype) for a in args),
                                 256, 512, True, "geglu")
    prod, gelu_b, agdb, stats = res[5]
    stats = np.asarray(stats)
    stats = stats if stats.shape[0] == 4 else stats.T   # Pallas layouts
    got_out, got = ffb.ff_block_fwd_stored(*to_torch(args,
                                                     getattr(torch, dtype)))
    _close(got_out, out, dtype, "out")
    for name, g, w in zip(("prod", "gelu_b", "agdb"), got[:3],
                          (prod, gelu_b, agdb)):
        _close(g, np.asarray(w, np.float32)[:rows], dtype, name)
    # fp32 statistics on both sides, from the same fp32 values
    np.testing.assert_allclose(got[3].numpy(), stats[:, :rows], atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype,rows,dim,inner", [
    ("float32", 70, 64, 128), ("float32", 33, 128, 256),
    ("bfloat16", 70, 64, 128)])
def test_ff_block_grads_match_pallas(dtype, rows, dim, inner):
    args = ff_args(R=rows, D=dim, I=inner)
    ja = [jnp.asarray(a, dtype) for a in args]
    cot = _cot((rows, dim))

    def f(*a):
        out = jff.ff_block(*a, 256, 512, True, "geglu")
        return jnp.sum(out.astype(jnp.float32) * cot)

    want = jax.grad(f, argnums=range(5))(*ja)
    tt = [t.requires_grad_(True) for t in to_torch(args,
                                                    getattr(torch, dtype))]
    out = ffb.ff_block_train(*tt)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    for name, t, w in zip(("x", "g_pre", "w_in", "g_inner", "w_out"), tt,
                          want):
        assert t.grad.dtype == t.dtype
        _close_grad(t.grad, w, dtype, name)


def test_ff_block_bwd_plain_matches_autograd():
    """The plain backward against autograd through the plain forward."""
    tt = [t.requires_grad_(True) for t in to_torch(ff_args(R=37),
                                                    torch.float32)]
    out, stored = ffb.ff_block_fwd_stored_plain(*tt)
    do = torch.from_numpy(_cot(out.shape))
    want = torch.autograd.grad(out, tt, do)
    with torch.no_grad():
        got = ffb.ff_block_bwd_plain(*tt, do, stored)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ K2

def _mega_jax(args, dtype):
    return ([jnp.asarray(a, dtype) for a in args[:5]]
            + [jnp.asarray(args[5])])


@pytest.mark.parametrize("dtype,causal,mask_kind", [
    ("float32", False, "keypad"), ("float32", True, "dead"),
    ("bfloat16", False, "dead")])
def test_attention_block_fwd_stored_matches_pallas(dtype, causal, mask_kind):
    b, n, heads = 2, 33, 2
    args = mega_args(n=n, dim=128, heads=heads, mask_kind=mask_kind)
    static = (heads, 64, 0.125, causal)
    out, (_, _, (qkv, attnout, proj, stats)) = jmega._mega_fwd(
        *_mega_jax(args, dtype), *static, True, True, True)
    got_out, (g_qkv, g_attn, g_proj, g_sm, g_ln) = \
        mega.attention_block_fwd_stored(
            *to_torch(args, getattr(torch, dtype)), *static, True)
    _close(got_out, out, dtype, "out")
    for name, g, w in (("qkv", g_qkv, qkv), ("attnout", g_attn, attnout),
                       ("proj", g_proj, proj)):
        _close(g, np.asarray(w, np.float32).reshape(b * n, -1), dtype, name)
    stats = np.asarray(stats)                 # (b, 2·heads + 4, n)
    sm = stats[:, :2 * heads].transpose(0, 2, 1).reshape(b * n, 2 * heads)
    np.testing.assert_allclose(g_sm.numpy(), sm, atol=1e-4, rtol=1e-4)
    ln = stats[:, 2 * heads:].transpose(1, 0, 2).reshape(4, b * n)
    np.testing.assert_allclose(g_ln.numpy(), ln, atol=1e-4, rtol=1e-5)


K2_GRAD_CASES = [  # (dtype, n, causal, mask_kind)
    ("float32", 33, False, "none"),
    ("float32", 33, False, "keypad"),
    ("float32", 33, True, "keypad"),
    ("float32", 33, False, "dead"),
    ("float32", 70, True, "dead"),
    ("bfloat16", 33, False, "keypad"),
]


@pytest.mark.parametrize("dtype,n,causal,mask_kind", K2_GRAD_CASES)
def test_attention_block_grads_match_pallas(dtype, n, causal, mask_kind):
    heads = 2
    args = mega_args(n=n, dim=128, heads=heads, mask_kind=mask_kind)
    maybe_dead = mask_kind != "none"
    static = (heads, 64, 64 ** -0.5, causal)
    ja = _mega_jax(args, dtype)
    cot = _cot((2, n, 128))

    def f(*a):
        out = jmega.attention_block(*a, ja[5], *static, True, maybe_dead,
                                    True)
        return jnp.sum(out.astype(jnp.float32) * cot)

    want = jax.grad(f, argnums=range(5))(*ja[:5])
    ta = to_torch(args, getattr(torch, dtype))
    tt = [t.requires_grad_(True) for t in ta[:5]]
    out = mega.attention_block_train(*tt, ta[5], *static, maybe_dead)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    for name, t, w in zip(("x", "g_pre", "w_qkv", "w_out", "g_out"), tt,
                          want):
        _close_grad(t.grad, w, dtype, name)


def test_attention_block_dw_qkv_is_xn_dqkv():
    """dW_qkv is xnᵀ · dqkv with xn = LN_pre(x) from the stored stats."""
    args = to_torch(mega_args(n=33, dim=128, heads=2), torch.float32)
    out, stored = mega.attention_block_fwd_stored(*args, 2, 64, 0.125)
    do = torch.from_numpy(_cot(out.shape))
    _, _, dw_qkv, _, _, dqkv = mega.attention_block_bwd(
        *args, do, stored, 2, 64, 0.125)
    x = args[0].reshape(-1, 128)
    xn = torch.nn.functional.layer_norm(x, (128,), eps=1e-5) * args[1]
    torch.testing.assert_close(dw_qkv, xn.T @ dqkv, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal,mask_kind", [(False, "keypad"),
                                              (True, "dead")])
def test_attention_block_bwd_plain_matches_autograd(causal, mask_kind):
    """The plain backward against autograd through the plain forward; a
    dead row passes no gradient to its scores."""
    ta = to_torch(mega_args(n=21, dim=64, heads=1, mask_kind=mask_kind),
                  torch.float32)
    tt = [t.requires_grad_(True) for t in ta[:5]]
    static = (1, 64, 0.125, causal, True)
    out, stored = mega.attention_block_fwd_stored_plain(*tt, ta[5], *static)
    do = torch.from_numpy(_cot(out.shape))
    want = torch.autograd.grad(out, tt, do)
    with torch.no_grad():
        got = mega.attention_block_bwd_plain(*tt, ta[5], do, stored,
                                             *static)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_training_wrappers_on_cpu_are_plain_and_uncounted():
    args = to_torch(ff_args(R=9), torch.float32)
    before = (ffb.ff_block_fwd_stored.launches, ffb.ff_block_bwd_p1.launches,
              ffb.ff_block_bwd_p2.launches)
    out, stored = ffb.ff_block_fwd_stored(*args)
    want_out, want_stored = ffb.ff_block_fwd_stored_plain(*args)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    do = torch.ones_like(out)
    dx, _, _, _, ops = ffb.ff_block_bwd_p1(*args, do, stored)
    ffb.ff_block_bwd_p2(*ops, do)
    torch.testing.assert_close(
        dx, ffb.ff_block_bwd_p1_plain(*args, do, want_stored)[0], rtol=0,
        atol=0)
    assert (ffb.ff_block_fwd_stored.launches, ffb.ff_block_bwd_p1.launches,
            ffb.ff_block_bwd_p2.launches) == before
    margs = to_torch(mega_args(n=9, dim=64, heads=1), torch.float32)
    before = (mega.attention_block_fwd_stored.launches,
              mega.attention_block_bwd.launches)
    out, stored = mega.attention_block_fwd_stored(*margs, 1, 64, 0.125)
    mega.attention_block_bwd(*margs, torch.ones_like(out), stored, 1, 64,
                             0.125)
    assert (mega.attention_block_fwd_stored.launches,
            mega.attention_block_bwd.launches) == before


def test_training_wrappers_refuse_mixed_devices():
    args = to_torch(ff_args(R=4), torch.float32)
    args[2] = args[2].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        ffb.ff_block_fwd_stored(*args)
