"""K8 (`ff_impl='fused'`: the GEGLU + inner-LayerNorm kernel) against the
JAX package on the CPU.

The port's wrappers run their plain versions here, so these hold the plain
forward and backward (the kernels' cast order in PyTorch) to
`xclip_tpu.kernels.fused_ff.geglu_layernorm` in Pallas interpret mode,
then `FeedForward(ff_impl='fused')`, the stack and the tiny CLIP on that
route to `feed_forward_apply`, `transformer_apply` and `xclip_tpu.CLIP`.

Tolerances: the kernel in fp32 rtol 2e-5 / atol 1e-5 on outputs and rtol
1e-4 / atol 1e-5 on gradients (as the JAX package's own test of it against
its XLA path); the Pallas `_erf` is a polynomial within 1.5e-7 of erf,
which the port computes exactly, so the two differ by ~1e-7. bf16: two
storage ulps of each tensor's largest magnitude (both sides round at the
same places; summation order or that 1e-7 can flip a rounding). Layers,
stack and CLIP in fp32: outputs 1e-4 absolute, loss 1e-5, gradients rtol
1e-3 with atol 1e-5 times the leaf's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.kernels import fused_ff as jff8
from xclip_tpu.nn import layers as jlayers
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree
from xclip_tpu_torch.kernels import fused_ff as k8
from xclip_tpu_torch.nn import layers as tlayers

from test_torch_train import _inputs, _pair, _tree_close, jax_keep_idx
from test_torch_train_kernels import _ulps2
from torch_port_inputs import to_np
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

DIM = 128
TREE = numpy_params(dict(dim_text=DIM, text_heads=2, text_enc_depth=2,
                         text_seq_len=8), seed=6)["text"]["transformer"]


def _h_g_do(inner, seed=0, lead=(7, 13)):
    npr = np.random.RandomState(seed)
    return (npr.randn(*lead, 2 * inner).astype(np.float32),
            npr.randn(inner).astype(np.float32),
            npr.randn(*lead, inner).astype(np.float32))


def _jax_k8(h, g, do, dtype):
    jh, jg = jnp.asarray(h, dtype), jnp.asarray(g, dtype)
    out, vjp = jax.vjp(lambda a, b: jff8.geglu_layernorm(a, b, None, 8, True),
                       jh, jg)
    dh, dg = vjp(jnp.asarray(do, dtype))
    return [np.asarray(t, np.float32) for t in (out, dh, dg)]


@pytest.mark.parametrize("inner", [32, 256])
def test_k8_plain_matches_pallas_fp32(inner):
    h, g, do = _h_g_do(inner)
    want_out, want_dh, want_dg = _jax_k8(h, g, do, jnp.float32)
    th, tg, tdo = map(torch.from_numpy, (h, g, do))
    out = k8.geglu_layernorm_plain(th, tg)
    assert out.shape == (7, 13, inner) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want_out, rtol=2e-5, atol=1e-5)
    dh, dg = k8.geglu_layernorm_bwd_plain(th, tg, tdo)
    np.testing.assert_allclose(dh.numpy(), want_dh, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dg.numpy(), want_dg, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("inner", [32, 256])
def test_k8_plain_matches_pallas_bf16(inner):
    h, g, do = _h_g_do(inner, seed=1)
    want = _jax_k8(h, g, do, jnp.bfloat16)
    bf = torch.bfloat16
    th, tg = torch.from_numpy(h).to(bf), torch.from_numpy(g).to(bf)
    out = k8.geglu_layernorm_plain(th, tg)
    # the cotangent is given in fp32: the backward casts it to bf16 first
    dh, dg = k8.geglu_layernorm_bwd_plain(th, tg, torch.from_numpy(do))
    for name, got, w in zip(("out", "dh", "dg"), (out, dh, dg), want):
        assert got.dtype == bf, name
        np.testing.assert_allclose(to_np(got), w, rtol=0, atol=_ulps2(w),
                                   err_msg=name)


def test_k8_function_is_its_plain_versions_on_cpu():
    """The autograd Function runs the plain versions on CPU tensors, counts
    no launch, and its backward is the plain backward."""
    h, g, do = map(torch.from_numpy, _h_g_do(64, seed=2, lead=(5,)))
    before = (k8.geglu_layernorm_fwd.launches, k8.geglu_layernorm_bwd.launches)
    th, tg = h.clone().requires_grad_(True), g.clone().requires_grad_(True)
    out = k8.geglu_layernorm(th, tg)
    out.backward(do)
    torch.testing.assert_close(out.detach(), k8.geglu_layernorm_plain(h, g),
                               rtol=0, atol=0)
    want_dh, want_dg = k8.geglu_layernorm_bwd_plain(h, g, do)
    torch.testing.assert_close(th.grad, want_dh, rtol=0, atol=0)
    torch.testing.assert_close(tg.grad, want_dg, rtol=0, atol=0)
    assert (k8.geglu_layernorm_fwd.launches,
            k8.geglu_layernorm_bwd.launches) == before


def test_k8_plain_bwd_matches_autograd():
    """The plain backward against autograd through the plain forward."""
    h, g, do = map(torch.from_numpy, _h_g_do(64, seed=3, lead=(4, 6)))
    th, tg = h.requires_grad_(True), g.requires_grad_(True)
    want = torch.autograd.grad(k8.geglu_layernorm_plain(th, tg), (th, tg), do)
    with torch.no_grad():
        got = k8.geglu_layernorm_bwd_plain(th, tg, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_k8_wrappers_refuse_bad_arguments():
    h, g, _ = map(torch.from_numpy, _h_g_do(32, lead=(3,)))
    with pytest.raises(ValueError, match="several devices"):
        k8.geglu_layernorm_fwd(h, g.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        k8.geglu_layernorm_bwd(h, g, torch.zeros(3, 32, device="meta"))


# ------------------------------------------------ the layer, stack and CLIP

def _ff_params(layer=0):
    return jax.tree.map(lambda a: a[layer], TREE["layers"])["ff"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feed_forward_fused_matches(dtype):
    """FeedForward(ff_impl='fused') against feed_forward_apply on the same
    route: forward, and in fp32 the gradients of x and every weight."""
    p = _ff_params()
    x = np.random.RandomState(4).randn(2, 9, DIM).astype(np.float32)
    cot = np.random.RandomState(5).randn(2, 9, DIM).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)

    def f(pp, xx):
        return jlayers.feed_forward_apply(pp, xx, ff_impl="fused")

    want, vjp = jax.vjp(f, jp, jnp.asarray(x, jdt))
    ff = tlayers.FeedForward(DIM, dtype=getattr(torch, dtype))
    load_jax_params(ff, p)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    got = ff(tx, ff_impl="fused")
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        # the products and the PreNorm add roundings: a few ulps of |out|
        np.testing.assert_allclose(to_np(got.detach()), want, rtol=0,
                                   atol=4 * _ulps2(want))
        return
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)
    want_p, want_x = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    want_x = np.asarray(want_x)
    np.testing.assert_allclose(tx.grad.numpy(), want_x, rtol=1e-3,
                               atol=1e-5 * max(1.0, np.abs(want_x).max()))
    _tree_close(to_jax_tree(ff, grads=True), want_p, rtol=1e-3,
                atol_scale=1e-5)


@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
def test_transformer_trains_on_the_fused_ff_route(attn_impl):
    """The stack on ff_impl='fused' (beside the plain attention or the
    megablock) against transformer_apply: output and every gradient."""
    npr = np.random.RandomState(6)
    x = npr.randn(2, 17, DIM).astype(np.float32)
    mask = np.ones((2, 17), dtype=bool)
    mask[0, 11:] = False
    cot = npr.randn(2, 17, DIM).astype(np.float32)

    def f(p, xx):
        return jlayers.transformer_apply(
            p, xx, heads=2, dim_head=64, mask=jnp.asarray(mask),
            attn_impl=attn_impl, ff_impl="fused", training=True)

    want, vjp = jax.vjp(f, jax.tree.map(jnp.asarray, TREE), jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(cot))
    stack = tlayers.Transformer(DIM, depth=2, dim_head=64, heads=2)
    load_jax_params(stack, TREE)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = stack(tx, torch.from_numpy(mask), attn_impl=attn_impl,
                ff_impl="fused", training=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    out.backward(torch.from_numpy(cot))
    want_x = np.asarray(want_x)
    np.testing.assert_allclose(tx.grad.numpy(), want_x, rtol=1e-3,
                               atol=1e-5 * max(1.0, np.abs(want_x).max()))
    _tree_close(to_jax_tree(stack, grads=True), want_p, rtol=1e-3,
                atol_scale=1e-5)


def test_fused_ff_stack_runs_k8_in_both_directions(monkeypatch):
    """Inference and training on 'fused' both go through the autograd
    Function's wrappers, once per layer and direction."""
    calls = []
    for name in ("geglu_layernorm_fwd", "geglu_layernorm_bwd"):
        fn = getattr(k8, name)
        monkeypatch.setattr(k8, name, lambda *a, _n=name, _f=fn: (
            calls.append(_n), _f(*a))[1])
    stack = tlayers.Transformer(64, depth=3, dim_head=64, heads=1)
    x = torch.randn(2, 5, 64, requires_grad=True)
    with torch.no_grad():
        stack(x, ff_impl="fused")
    assert calls == ["geglu_layernorm_fwd"] * 3
    calls.clear()
    stack(x, ff_impl="fused", training=True).sum().backward()
    assert sorted(calls) == (["geglu_layernorm_bwd"] * 3
                             + ["geglu_layernorm_fwd"] * 3)


CLIP_ROUTES = {
    "plain-attention": dict(attn_impl="xla", visual_attn_impl="xla",
                            ff_impl="fused"),
    "megablock": dict(attn_impl="fused", visual_attn_impl="xla",
                      ff_impl="fused"),
}


@pytest.mark.parametrize("route", list(CLIP_ROUTES))
def test_tiny_clip_on_the_fused_ff_route_matches_jax(route):
    """The tiny CLIP with ff_impl='fused' in both towers: scores and
    latents at inference, then the loss and gradient tree of a training
    forward with patch dropout, against the JAX package."""
    jclip, params, tclip = _pair(seed=4, **CLIP_ROUTES[route])
    text, image = _inputs(seed=4)
    jt, ji = jnp.asarray(text), jnp.asarray(image)
    tt, ti = torch.from_numpy(text), torch.from_numpy(image)
    np.testing.assert_allclose(tclip(tt, ti).numpy(),
                               np.asarray(jclip(jt, ji, params=params)),
                               rtol=0, atol=1e-4)
    for got, want in zip(tclip(tt, ti, return_latents=True),
                         jclip(jt, ji, return_latents=True, params=params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)
    rng = jax.random.PRNGKey(8)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jclip.model.apply(p, jt, ji, return_loss=True, rng=rng,
                                    training=True))(params)
    loss = tclip(tt, ti, return_loss=True, keep_idx=jax_keep_idx(rng, 4, 9,
                                                                 0.5))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    _tree_close(to_jax_tree(tclip, grads=True), want_grads, rtol=1e-3,
                atol_scale=1e-5)


def test_jax_params_load_into_a_fused_ff_clip():
    """K8 uses the FF layer's own parameters: a JAX tree of a
    ff_impl='fused' CLIP loads leaf for leaf and comes back unchanged."""
    _, params, tclip = _pair(seed=5, ff_impl="fused")
    back = to_jax_tree(tclip)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    _tree_close(back, params, atol=0)
