"""K1-h, the stored-h FF block that `XCLIP_FF_STORE=h` selects for
`ff_impl='block_stored'` in training, against the JAX package on the CPU.

The port's wrappers run their plain versions here, so these hold the plain
forward (`ff_block_fwd_stored_h`), pass 1 (`ff_block_bwd_p1_stored_h`) and
pass 2 (K1's `ff_block_bwd_p2`) to `jax.vjp` of
`xclip_tpu.kernels.fused_ff_block.ff_block(..., store_h=True)` in Pallas
interpret mode, then the stack and one AdamW step of the tiny CLIP with the
variable set to `transformer_apply` and JAX's train step under it.

Tolerances: fp32 outputs and statistics 1e-4 absolute; fp32 gradients rtol
1e-3 with atol 1e-5 times the leaf's largest magnitude; bf16 two storage
ulps of each tensor's largest magnitude (both sides round at the same
places); loss 1e-5; parameters after an AdamW step 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.kernels import fused_ff_block as jff
from xclip_tpu.nn import layers as jlayers
from xclip_tpu.train import trainer as jtrainer
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree
from xclip_tpu_torch.kernels import fused_ff_block as ffb
from xclip_tpu_torch.nn import layers as tlayers
from xclip_tpu_torch.train import default_optimizer, make_train_step

from test_torch_train import _inputs, _pair, _tree_close, jax_keep_idx
from test_torch_train_kernels import _close, _close_grad, _cot
from torch_port_inputs import ff_args, to_torch
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")


def _jax_vjp(args, cot, dtype, store_h=True):
    ja = [jnp.asarray(a, dtype) for a in args]
    out, vjp = jax.vjp(lambda *a: jff.ff_block(*a, 256, 512, True, store_h),
                       *ja)
    return out, vjp(jnp.asarray(cot, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1h_forward_matches_pallas(dtype):
    rows = 70
    args = ff_args(R=rows, D=64, I=128)
    out, res = jff._ff_block_fwd(*(jnp.asarray(a, dtype) for a in args),
                                 256, 512, True, True)
    h, stats = res[5]
    stats = np.asarray(stats)
    stats = stats if stats.shape[0] == 4 else stats.T   # Pallas layouts
    got_out, (got_h, got_stats) = ffb.ff_block_fwd_stored_h(
        *to_torch(args, getattr(torch, dtype)))
    assert got_h.shape == (rows, 256) and got_h.dtype == getattr(torch, dtype)
    _close(got_out, out, dtype, "out")
    _close(got_h, np.asarray(h, np.float32)[:rows], dtype, "h")
    np.testing.assert_allclose(got_stats.numpy(), stats[:, :rows], atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype,rows,dim,inner", [
    ("float32", 70, 64, 128), ("float32", 33, 128, 256),
    ("bfloat16", 70, 64, 128)])
def test_k1h_passes_match_jax_vjp(dtype, rows, dim, inner):
    """Forward, pass 1 and pass 2 one by one against the five cotangents
    of `jax.vjp` of the stored-h block."""
    args = ff_args(R=rows, D=dim, I=inner)
    cot = _cot((rows, dim))
    out, want = _jax_vjp(args, cot, dtype)
    ta = to_torch(args, getattr(torch, dtype))
    got_out, stored = ffb.ff_block_fwd_stored_h(*ta)
    _close(got_out, out, dtype, "out")
    do = torch.from_numpy(cot).to(ta[0].dtype)
    dx, dprod, dg_pre, dg_inner, ops = ffb.ff_block_bwd_p1_stored_h(
        *ta, do, stored)
    assert dprod.shape == (rows, inner)
    dw_in, dw_out = ffb.ff_block_bwd_p2(*ops, do)
    for name, g, w in zip(("dx", "dg_pre", "dw_in", "dg_inner", "dw_out"),
                          (dx, dg_pre, dw_in, dg_inner, dw_out), want):
        assert g.dtype == ta[0].dtype, name
        _close_grad(g, w, dtype, name)


def test_k1h_autograd_function_matches_jax_grad():
    args = ff_args(R=45, D=64, I=128, seed=3)
    cot = _cot((45, 64), seed=4)
    _, want = _jax_vjp(args, cot, "float32")
    tt = [t.requires_grad_(True) for t in to_torch(args, torch.float32)]
    ffb.ff_block_train_stored_h(*tt).backward(torch.from_numpy(cot))
    for name, t, w in zip(("x", "g_pre", "w_in", "g_inner", "w_out"), tt,
                          want):
        _close_grad(t.grad, w, "float32", name)


def test_k1h_bf16_reproduces_the_reference_quirk():
    """bf16: the backward rebuilds prod from the rounded h against
    statistics of the fp32 h. The port's stored-h dx equals the JAX
    stored-h dx within two ulps, and differs from the port's
    GEGLU-triple (K1) dx on the same inputs."""
    args = ff_args(R=96, D=64, I=128, seed=5)
    cot = _cot((96, 64), seed=6)
    _, want = _jax_vjp(args, cot, "bfloat16")
    ta = to_torch(args, torch.bfloat16)
    do = torch.from_numpy(cot).to(torch.bfloat16)
    _, stored_h = ffb.ff_block_fwd_stored_h(*ta)
    dx_h = ffb.ff_block_bwd_p1_stored_h(*ta, do, stored_h)[0]
    _close(dx_h, want[0], "bfloat16", "dx")
    _, stored_geglu = ffb.ff_block_fwd_stored(*ta)
    dx_geglu = ffb.ff_block_bwd_p1(*ta, do, stored_geglu)[0]
    assert (dx_h.float() - dx_geglu.float()).abs().max().item() > 0


def test_k1h_plain_bwd_matches_autograd():
    """fp32: h is stored unrounded, so the plain backward is the exact
    gradient of the plain forward."""
    tt = [t.requires_grad_(True) for t in to_torch(ff_args(R=37),
                                                    torch.float32)]
    out, stored = ffb.ff_block_fwd_stored_h_plain(*tt)
    do = torch.from_numpy(_cot(out.shape))
    want = torch.autograd.grad(out, tt, do)
    with torch.no_grad():
        dx, _, dg_pre, dg_inner, ops = ffb.ff_block_bwd_p1_stored_h_plain(
            *tt, do, stored)
        dw_in, dw_out = ffb.ff_block_bwd_p2_plain(*ops, do)
    for g, w in zip((dx, dg_pre, dw_in, dg_inner, dw_out), want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_k1h_wrappers_on_cpu_are_plain_and_uncounted():
    args = to_torch(ff_args(R=9), torch.float32)
    before = (ffb.ff_block_fwd_stored_h.launches,
              ffb.ff_block_bwd_p1_stored_h.launches)
    out, stored = ffb.ff_block_fwd_stored_h(*args)
    want_out, _ = ffb.ff_block_fwd_stored_h_plain(*args)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    ffb.ff_block_bwd_p1_stored_h(*args, torch.ones_like(out), stored)
    assert (ffb.ff_block_fwd_stored_h.launches,
            ffb.ff_block_bwd_p1_stored_h.launches) == before
    args[2] = args[2].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        ffb.ff_block_fwd_stored_h(*args)


# ------------------------------------------------------ the stack and CLIP

def test_transformer_trains_stored_h_like_jax(monkeypatch):
    """XCLIP_FF_STORE=h set: the stack on 'block_stored' takes K1-h (and
    only K1-h) in training, its output and gradients against
    transformer_apply under the same variable."""
    monkeypatch.setenv("XCLIP_FF_STORE", "h")
    tree = numpy_params(dict(dim_text=128, text_heads=2, text_enc_depth=2,
                             text_seq_len=8), seed=7)["text"]["transformer"]
    npr = np.random.RandomState(8)
    x = npr.randn(2, 19, 128).astype(np.float32)
    mask = np.ones((2, 19), dtype=bool)
    mask[1, 7:] = False
    cot = npr.randn(2, 19, 128).astype(np.float32)

    def f(p, xx):
        return jlayers.transformer_apply(
            p, xx, heads=2, dim_head=64, mask=jnp.asarray(mask),
            attn_impl="fused", ff_impl="block_stored", training=True)

    want, vjp = jax.vjp(f, jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(cot))
    calls = []
    for name in ("ff_block_train", "ff_block_train_stored_h"):
        fn = getattr(tlayers, name)
        monkeypatch.setattr(tlayers, name, lambda *a, _n=name, _f=fn: (
            calls.append(_n), _f(*a))[1])
    stack = tlayers.Transformer(128, depth=2, dim_head=64, heads=2)
    load_jax_params(stack, tree)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = stack(tx, torch.from_numpy(mask), attn_impl="fused",
                ff_impl="block_stored", training=True)
    assert calls == ["ff_block_train_stored_h"] * 2
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    out.backward(torch.from_numpy(cot))
    want_x = np.asarray(want_x)
    np.testing.assert_allclose(tx.grad.numpy(), want_x, rtol=1e-3,
                               atol=1e-5 * max(1.0, np.abs(want_x).max()))
    _tree_close(to_jax_tree(stack, grads=True), want_p, rtol=1e-3,
                atol_scale=1e-5)
    monkeypatch.delenv("XCLIP_FF_STORE")
    calls.clear()
    stack(tx, ff_impl="block_stored", training=True)
    assert calls == ["ff_block_train"] * 2     # read per call, as JAX does


def test_tiny_clip_adamw_step_stored_h_matches_jax(monkeypatch):
    """One make_train_step AdamW step of the tiny CLIP on the kernel routes
    with XCLIP_FF_STORE=h: loss, grad norm and every parameter after it
    against JAX's train step under the same variable."""
    monkeypatch.setenv("XCLIP_FF_STORE", "h")
    jclip, params, tclip = _pair(seed=6)
    text, image = _inputs(seed=6)
    sched = dict(learning_rate=1e-4, warmup_steps=2, total_steps=5)
    jopt = jtrainer.default_optimizer(**sched)
    state = jtrainer.TrainState(params=params, opt_state=jopt.init(params),
                                step=jnp.zeros((), jnp.int32))
    jstep = jtrainer.make_train_step(jclip.model, jopt, donate=False)
    rng = jax.random.PRNGKey(12)
    state, want = jstep(state, jnp.asarray(text), jnp.asarray(image), rng)
    before = ffb.ff_block_bwd_p1_stored_h.launches
    step = make_train_step(tclip, default_optimizer(tclip.parameters(),
                                                    **sched))
    got = step(torch.from_numpy(text), torch.from_numpy(image),
               keep_idx=jax_keep_idx(rng, 4, 9, 0.5))
    assert ffb.ff_block_bwd_p1_stored_h.launches == before   # CPU: plain
    for k in ("loss", "cl_loss", "temperature", "grad_norm"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    _tree_close(to_jax_tree(tclip), state.params, atol=2e-6)
