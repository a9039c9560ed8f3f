"""Dropout in training against the JAX package on the CPU: the stack and
custom encoders with `attn_dropout` / `ff_dropout`, given the keep masks
JAX's own `RngStream` draws (JAX's and torch's random bits never agree, so
the masks are injected), give JAX's loss and gradients; the kernel routes
fall back where JAX's gates do, with JAX's warnings, once per cause; the
port's own draws are Bernoulli(1 − rate), and a recomputing backward
(remat) draws the same masks.

Tolerances as `test_torch_train.py`: loss 1e-5 absolute; gradients per
leaf rtol 1e-3 with atol 1e-5 times the leaf's largest magnitude (the
stack's input gradient likewise); remat against no remat bit for bit.
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xclip_tpu
from xclip_tpu.nn import layers as jlayers
from xclip_tpu.nn.text import TextTransformer as JText
from xclip_tpu.nn.vision import VisionTransformer as JVision
import xclip_tpu_torch
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree
from xclip_tpu_torch.nn import layers as tlayers
from xclip_tpu_torch.nn.core import RngStream
from xclip_tpu_torch.nn.text import TextTransformer
from xclip_tpu_torch.nn.vision import VisionTransformer

from test_torch_train import TINY, _inputs, _tree_close, jax_keep_idx

jax.config.update("jax_default_matmul_precision", "highest")

# the stack of the transformer-level cases: 2 layers of 2 heads of 32
STACK = dict(dim=64, depth=2, heads=2, dim_head=32, n=9, b=2)


def jax_dropout_keep(rng, depth, sites):
    """The keep masks `transformer_apply(..., rng=rng, training=True)`
    draws: layer i's stream is `RngStream(split(rng, depth)[i])`, its k-th
    site `fold_in(key, k)`; `sites` the (shape, rate) of a layer's sites in
    order (attention, then FF)."""
    return [[torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(key, k), 1.0 - rate, shape)))
        for k, (shape, rate) in enumerate(sites)]
        for key in jax.random.split(rng, depth)]


def _sites(b, n, heads, inner, attn_dropout=0.0, ff_dropout=0.0, **_):
    return ([((b, heads, n, n), attn_dropout)] if attn_dropout else []) + (
        [((b, n, inner), ff_dropout)] if ff_dropout else [])


def check_stack_matches_jax(seed=0, **flags):
    """`transformer_apply` against `Transformer.forward` in training with
    `flags` (routes, dropout rates, remat), fp32: sum(out · cot), an O(1)
    loss (the cotangent's entries have variance 1 / its size), and the
    gradients of the input and of every leaf; the port given the keep
    masks JAX draws."""
    c = STACK
    tree = numpy_params(dict(dim_text=c["dim"], text_heads=c["heads"],
                             text_dim_head=c["dim_head"],
                             text_enc_depth=c["depth"], text_seq_len=8),
                        seed)["text"]["transformer"]
    npr = np.random.RandomState(seed)
    x = npr.randn(c["b"], c["n"], c["dim"]).astype(np.float32)
    mask = np.ones((c["b"], c["n"]), dtype=bool)
    mask[1, 6:] = False
    # unit variance for the sum: a loss of O(1), as the CLIP loss is
    cot = (npr.randn(*x.shape) / math.sqrt(x.size)).astype(np.float32)
    rng = jax.random.PRNGKey(seed + 11)

    def f(p, xx):
        out = jlayers.transformer_apply(
            p, xx, heads=c["heads"], dim_head=c["dim_head"],
            mask=jnp.asarray(mask), rng=rng, training=True, **flags)
        return jnp.sum(out * cot)

    want, (want_p, want_x) = jax.value_and_grad(f, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    stack = tlayers.Transformer(c["dim"], depth=c["depth"],
                                dim_head=c["dim_head"], heads=c["heads"])
    load_jax_params(stack, tree)
    keep = jax_dropout_keep(rng, c["depth"], _sites(
        c["b"], c["n"], c["heads"], 4 * c["dim"], **flags))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = stack(tx, torch.from_numpy(mask), training=True, dropout_keep=keep,
                **flags)
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-5)
    want_x = np.asarray(want_x)
    np.testing.assert_allclose(tx.grad.numpy(), want_x, rtol=1e-3,
                               atol=1e-5 * max(1.0, np.abs(want_x).max()))
    _tree_close(to_jax_tree(stack, grads=True), want_p, rtol=1e-3,
                atol_scale=1e-5)


@pytest.mark.parametrize("flags", [
    dict(attn_dropout=0.1, ff_dropout=0.1),
    dict(attn_impl="fused", ff_impl="block_stored", attn_dropout=0.1,
         ff_dropout=0.1),
    dict(attn_impl="fused", ff_impl="block_stored", ff_dropout=0.2),
    dict(attn_impl="fused_recompute", ff_impl="fused", attn_dropout=0.2,
         checkpoint_during_training=True, remat_policy="wide"),
], ids=["xla", "kernels", "megablock-ff-dropout", "lean-k8-wide"])
def test_stack_dropout_matches_jax(flags):
    """Attention dropout takes the megablock off; FF dropout alone keeps
    it and takes the FF block off."""
    check_stack_matches_jax(seed=1, **flags)


def _custom_encoders(rate, routes, **remat):
    """Both towers of TINY with attention and FF dropout at `rate`, in the
    JAX package and in the port."""
    ff_impl = routes.get("ff_impl", "xla")
    text = dict(dim=64, num_tokens=100, max_seq_len=16, depth=2, heads=2,
                attn_dropout=rate, ff_dropout=rate, ff_impl=ff_impl, **remat)
    vision = dict(dim=64, image_size=48, patch_size=16, patch_dropout=0.5,
                  depth=2, heads=2, attn_dropout=rate, ff_dropout=rate,
                  ff_impl=ff_impl, **remat)
    return ((JText(**text), JVision(**vision)),
            (TextTransformer(**text), VisionTransformer(**vision)))


def _dropout_pair(routes, rate=0.1, **remat):
    (jt, jv), (tt, tv) = _custom_encoders(rate, routes, **remat)
    clip_flags = {k: v for k, v in routes.items() if k != "ff_impl"}
    tree = numpy_params({**TINY, **routes}, 3)
    jclip = xclip_tpu.CLIP(**TINY, **clip_flags, text_encoder=jt,
                           image_encoder=jv)
    tclip = xclip_tpu_torch.CLIP(**TINY, **clip_flags, text_encoder=tt,
                                 image_encoder=tv, device="cpu")
    load_jax_params(tclip, tree)
    return jclip, jax.tree.map(jnp.asarray, tree), tclip


def jax_clip_dropout_keep(rng, b, rate, inner=256, heads=2):
    """The keep masks of `CLIPModel.apply(..., rng=rng, training=True)`
    with TINY's custom encoders: the text tower takes the model stream's
    first key, the vision tower's stack the second half of the split of its
    second (the first draws the patches)."""
    text_rng = jax.random.fold_in(rng, 0)
    _, vision_rng = jax.random.split(jax.random.fold_in(rng, 1))
    return {"text": jax_dropout_keep(text_rng, 2, _sites(
                b, 17, heads, inner, rate, rate)),
            "visual": jax_dropout_keep(vision_rng, 2, _sites(
                b, 4, heads, inner, rate, rate))}


@pytest.mark.parametrize("routes", [
    {}, dict(attn_impl="fused", ff_impl="block_stored", loss_impl="fused")],
    ids=["xla", "kernel-flags"])
def test_custom_encoders_with_dropout_match_jax(routes):
    jclip, params, tclip = _dropout_pair(routes)
    text, image = _inputs(b=2, seed=4)
    rng = jax.random.PRNGKey(21)

    def loss_fn(p):
        return jclip.model.apply(p, jnp.asarray(text), jnp.asarray(image),
                                 return_loss=True, rng=rng, training=True)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = tclip(torch.from_numpy(text), torch.from_numpy(image),
                 return_loss=True, keep_idx=jax_keep_idx(rng, 2, 9, 0.5),
                 dropout_keep=jax_clip_dropout_keep(rng, 2, 0.1))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    _tree_close(to_jax_tree(tclip, grads=True), want_grads, rtol=1e-3,
                atol_scale=1e-5)


def _warnings_of(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in caught if "falling back" in str(w.message)]


@pytest.mark.parametrize("flags", [
    dict(attn_impl="fused", ff_impl="block_stored"),
    dict(attn_impl="fused_qkv", ff_impl="block"),
    dict(attn_impl="flash", ff_impl="fused"),
], ids=["stored", "lean", "flash-k8"])
def test_fallback_warnings_match_jax(monkeypatch, flags):
    """Each kernel route that attention or FF dropout turns off warns in
    JAX's words, once per cause: the same messages as `transformer_apply`
    gives, none on a second call."""
    c = STACK
    tree = numpy_params(dict(dim_text=c["dim"], text_heads=c["heads"],
                             text_dim_head=c["dim_head"],
                             text_enc_depth=1, text_seq_len=8),
                        0)["text"]["transformer"]
    x = np.random.RandomState(0).randn(1, c["n"], c["dim"]).astype(
        np.float32)
    rates = dict(attn_dropout=0.1, ff_dropout=0.1)
    monkeypatch.setattr(jlayers, "_warned_fallbacks", set())
    monkeypatch.setattr(tlayers, "_warned_fallbacks", set())
    want = _warnings_of(lambda: jlayers.transformer_apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), heads=c["heads"],
        dim_head=c["dim_head"], rng=jax.random.PRNGKey(0), training=True,
        **rates, **flags))
    stack = tlayers.Transformer(c["dim"], depth=1, dim_head=c["dim_head"],
                                heads=c["heads"])

    def run():
        stack(torch.from_numpy(x), training=True, **rates, **flags)

    assert sorted(_warnings_of(run)) == sorted(want) and len(want) == 2
    assert _warnings_of(run) == []


def test_draws_keep_one_minus_rate():
    """The port's draws: a site's mask keeps 1 − rate of its elements
    (within 4σ of the binomial count), the same (seed, site) gives the
    same mask, another site or seed another; `dropout` scales the kept
    elements by 1 / (1 − rate) and zeroes the others, in x's dtype."""
    shape, rate = (64, 1000), 0.1
    a = RngStream(seed=5)
    m0, m1 = a.keep(shape, rate, "cpu"), a.keep(shape, rate, "cpu")
    n = m0.numel()
    for m in (m0, m1):
        assert abs(m.sum().item() - n * (1 - rate)) <= 4 * math.sqrt(
            n * rate * (1 - rate))
    assert not torch.equal(m0, m1)
    assert torch.equal(RngStream(seed=5).keep(shape, rate, "cpu"), m0)
    assert not torch.equal(RngStream(seed=6).keep(shape, rate, "cpu"), m0)
    x = torch.randn(shape, dtype=torch.bfloat16)
    from xclip_tpu_torch.nn.core import dropout
    out = dropout(x, rate, RngStream(seed=5))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, torch.where(m0, x / (1 - rate), 0.0).to(x.dtype))


@pytest.mark.parametrize("policy", [None, "dots", "wide"])
def test_remat_with_dropout_equals_dropout_alone(policy):
    """The port's own draws under remat: the same generator seed gives the
    same loss and gradients bit for bit, with and without remat; a
    recompute draws the masks its forward drew."""
    routes = dict(attn_impl="fused", ff_impl="block_stored", loss_impl="fused")
    _, (tt, tv) = _custom_encoders(0.1, routes)
    flags = {k: v for k, v in routes.items() if k != "ff_impl"}
    plain = xclip_tpu_torch.CLIP(**TINY, **flags, text_encoder=tt,
                                 image_encoder=tv, device="cpu")
    _, (rt, rv) = _custom_encoders(
        0.1, routes, checkpoint_during_training=True, remat_policy=policy)
    remat = xclip_tpu_torch.CLIP(**TINY, **flags, text_encoder=rt,
                                 image_encoder=rv, device="cpu")
    remat.load_state_dict(plain.state_dict())
    text, image = map(torch.from_numpy, _inputs(b=2, seed=4))
    results = []
    for clip in (plain, remat):
        loss = clip(text, image, return_loss=True,
                    generator=torch.Generator().manual_seed(7))
        loss.backward()
        results.append((loss, {n: p.grad for n, p in clip.named_parameters()
                               if p.grad is not None}))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
