"""Remat (`checkpoint_during_training` with `remat_policy` None, 'dots' and
'wide') against the JAX package on the CPU, on the plain ('xla'), stored
(K2, K1) and memory-lean (K3, K-FF-s, K5) routes: the tiny CLIP's loss and
gradient tree against JAX's remat step (fp32; loss 1e-5 absolute,
gradients per leaf rtol 1e-3 with atol 1e-5 times the leaf's largest
magnitude), and bit for bit the port's own step without remat, since a
recompute runs the same operations on the same values. Under None and
'dots' each layer's kernel forwards run twice (forward and recompute),
under 'wide' once; 'dots' keeps exactly the 2-D products of the plain
route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xclip_tpu
import xclip_tpu_torch
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree
from xclip_tpu_torch.nn import layers as tlayers

from test_torch_train import TINY, _inputs, _tree_close, jax_keep_idx
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

ROUTES = {"xla": {},
          "stored": dict(attn_impl="fused", visual_attn_impl="xla",
                         ff_impl="block_stored"),
          "lean": dict(attn_impl="fused_recompute", ff_impl="block",
                       loss_impl="fused")}
POLICIES = [None, "dots", "wide"]
CASES = [pytest.param(r, p, id=f"{r}-{p}") for r in ROUTES for p in POLICIES]


def _config(route, policy, depth=1):
    return {**TINY, **ROUTES[route], "text_enc_depth": depth,
            "visual_enc_depth": depth, "checkpoint_during_training": True,
            "remat_policy": policy}


def _loss_and_grads(clip, text, image, keep):
    clip.zero_grad(set_to_none=True)
    loss = clip(text, image, return_loss=True, keep_idx=keep)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in clip.named_parameters()
                           if p.grad is not None}


@pytest.mark.parametrize("route,policy", CASES)
def test_remat_matches_jax(route, policy):
    config = _config(route, policy)
    tree = numpy_params(config, 6)
    jclip = xclip_tpu.CLIP(**config)
    tclip = xclip_tpu_torch.CLIP(**config, device="cpu")
    load_jax_params(tclip, tree)
    text, image = _inputs(b=2, seed=6)
    rng = jax.random.PRNGKey(13)

    def loss_fn(p):
        return jclip.model.apply(p, jnp.asarray(text), jnp.asarray(image),
                                 return_loss=True, rng=rng, training=True)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, tree))
    loss, _ = _loss_and_grads(tclip, torch.from_numpy(text),
                              torch.from_numpy(image),
                              jax_keep_idx(rng, 2, 9, 0.5))
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    _tree_close(to_jax_tree(tclip, grads=True), want_grads, rtol=1e-3,
                atol_scale=1e-5)


@pytest.mark.parametrize("route,policy", CASES)
def test_remat_is_bit_equal_to_no_remat(route, policy):
    config = _config(route, policy, depth=2)
    remat = xclip_tpu_torch.CLIP(**config, device="cpu")
    plain = xclip_tpu_torch.CLIP(
        **{**config, "checkpoint_during_training": False}, device="cpu")
    plain.load_state_dict(remat.state_dict())
    text, image = map(torch.from_numpy, _inputs(b=4, seed=7))
    keep = torch.from_numpy(
        np.random.RandomState(7).rand(4, 9).argsort(1)[:, :4])
    l0, g0 = _loss_and_grads(plain, text, image, keep)
    l1, g1 = _loss_and_grads(remat, text, image, keep)
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("policy,calls", [(None, 2), ("dots", 2),
                                          ("wide", 1)])
def test_kernel_forwards_run_again_in_the_backward(monkeypatch, policy,
                                                   calls):
    """Stored route, 2 + 2 layers (vision attention plain): K2's and K1's
    wrappers are called `calls` times a layer over a forward and backward
    (on the card each call launches the kernels: the launch counts double
    under None and 'dots')."""
    seen = {"attention_block_train": 0, "ff_block_train": 0}

    def spy(name):
        fn = getattr(tlayers, name)

        def counted(*a, **k):
            seen[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(tlayers, name, counted)

    for name in seen:
        spy(name)
    clip = xclip_tpu_torch.CLIP(**_config("stored", policy, depth=2),
                                device="cpu")
    text, image = map(torch.from_numpy, _inputs(b=2, seed=8))
    clip(text, image, return_loss=True).backward()
    # K2 in the text tower's 2 layers, K1 in both towers' 4
    assert seen == {"attention_block_train": 2 * calls,
                    "ff_block_train": 4 * calls}


def test_dots_keeps_the_batch_free_products(monkeypatch):
    """'dots' on the plain route: the policy keeps the outputs of the five
    2-D products of each layer (qkv, out; the two halves of w_in, w_out)
    and of nothing else; the batched attention products are recomputed."""
    kept = []

    def counting(ctx, op, *args, **kwargs):
        policy = save_products(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            kept.append((op, policy))
        return policy

    save_products = tlayers.save_products
    monkeypatch.setattr(tlayers, "save_products", counting)
    clip = xclip_tpu_torch.CLIP(**_config("xla", "dots", depth=2),
                                device="cpu")
    text, image = map(torch.from_numpy, _inputs(b=2, seed=9))
    clip(text, image, return_loss=True).backward()
    saved = [op for op, p in kept
             if p == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE]
    assert saved == [torch.ops.aten.mm.default] * (5 * 4)
    assert torch.ops.aten.bmm.default in {op for op, _ in kept}
