"""The port's memory-lean training slice against the JAX package on the
CPU: a tiny CLIP on `attn_impl='fused_recompute'` (both towers), `ff_impl=
'block'` and `loss_impl='fused'` — K3, K-FF-s with the recompute backward,
and K5 — with FLIP patch dropout on. Its loss and full gradient tree
against `jax.value_and_grad`, three AdamW steps of `make_train_step`
against JAX's, and the routing of these flags.

Weights come from `convert.numpy_params` on both sides, and the port is
given the patch indices JAX draws (`test_torch_train.jax_keep_idx`). JAX's
Pallas kernels run in interpret mode. Tolerances as in
`test_torch_train.py`: loss 1e-5 absolute; gradients per leaf rtol 1e-3
with atol 1e-5 times the leaf's largest magnitude; parameters after the
AdamW steps 2e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xclip_tpu
from xclip_tpu.train import trainer as jtrainer
import xclip_tpu_torch
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree
from xclip_tpu_torch.kernels import attention_megablock as mega
from xclip_tpu_torch.kernels import fused_ff_block as ffb
from xclip_tpu_torch.kernels import fused_infonce as lse5
from xclip_tpu_torch.nn import layers as tlayers
from xclip_tpu_torch.train import default_optimizer, make_train_step

from test_torch_train import TINY, _inputs, _tree_close, jax_keep_idx
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

LEAN = dict(attn_impl="fused_recompute", ff_impl="block", loss_impl="fused")


def _pair(seed=0, **flags):
    config = {**TINY, **flags}
    tree = numpy_params(config, seed)
    jclip = xclip_tpu.CLIP(**config)
    tclip = xclip_tpu_torch.CLIP(**config, device="cpu")
    load_jax_params(tclip, tree)
    return jclip, jax.tree.map(jnp.asarray, tree), tclip


def _loss_and_grads(flags, seed=0, b=4):
    jclip, params, tclip = _pair(seed=seed, **flags)
    text, image = _inputs(b=b, seed=seed)
    rng = jax.random.PRNGKey(5)

    def loss_fn(p):
        return jclip.model.apply(p, jnp.asarray(text), jnp.asarray(image),
                                 return_loss=True, rng=rng, training=True)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    keep = jax_keep_idx(rng, b, 9, 0.5)
    loss = tclip(torch.from_numpy(text), torch.from_numpy(image),
                 return_loss=True, keep_idx=keep)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    _tree_close(to_jax_tree(tclip, grads=True), want_grads, rtol=1e-3,
                atol_scale=1e-5)


@pytest.mark.parametrize("flags", [
    {}, dict(decoupled_contrastive_learning=True,
             extra_latent_projection=True)], ids=["plain", "dcl-extra"])
def test_lean_loss_and_grads_match_jax(flags):
    _loss_and_grads({**LEAN, **flags})


def test_lean_train_steps_match_jax():
    """Three steps of make_train_step against JAX's on the memory-lean
    routes, warmup-cosine schedule on: losses, pre-clip grad norms and
    every parameter after each step."""
    jclip, params, tclip = _pair(seed=1, **LEAN)
    text, image = _inputs(seed=1)
    sched = dict(learning_rate=1e-4, warmup_steps=2, total_steps=5)
    jopt = jtrainer.default_optimizer(**sched)
    state = jtrainer.TrainState(params=params, opt_state=jopt.init(params),
                                step=jnp.zeros((), jnp.int32))
    jstep = jtrainer.make_train_step(jclip.model, jopt, donate=False)
    step = make_train_step(tclip, default_optimizer(tclip.parameters(),
                                                    **sched))
    for i in range(3):
        rng = jax.random.PRNGKey(100 + i)
        state, want = jstep(state, jnp.asarray(text), jnp.asarray(image), rng)
        got = step(torch.from_numpy(text), torch.from_numpy(image),
                   keep_idx=jax_keep_idx(rng, 4, 9, 0.5))
        for k in ("loss", "cl_loss", "temperature", "grad_norm"):
            np.testing.assert_allclose(got[k].item(), float(want[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        _tree_close(to_jax_tree(tclip), state.params, atol=2e-6)


def test_lean_routes_run_their_kernels(monkeypatch):
    """A lean training forward and backward go through K3, K-FF-s with the
    recompute backward, and K5 (their plain versions here), and through
    nothing of K1 / K2."""
    calls = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    for name in ("attention_block_train", "attention_block_train_recompute",
                 "ff_block_train", "ff_block_train_recompute"):
        spy(tlayers, name)
    for module, name in ((mega, "attention_block_bwd_recompute"),
                         (ffb, "ff_block_bwd_recompute"),
                         (lse5, "streaming_lse_fwd"),
                         (lse5, "streaming_lse_bwd")):
        spy(module, name)
    clip = xclip_tpu_torch.CLIP(**TINY, **LEAN, device="cpu")
    text, image = map(torch.from_numpy, _inputs(b=2))
    clip(text, image, return_loss=True).backward()
    assert sorted(set(calls)) == sorted(
        ["attention_block_train_recompute", "ff_block_train_recompute",
         "attention_block_bwd_recompute", "ff_block_bwd_recompute",
         "streaming_lse_fwd", "streaming_lse_bwd"])
    # two towers of two layers; one K5 call per direction
    assert calls.count("attention_block_bwd_recompute") == 4
    assert calls.count("ff_block_bwd_recompute") == 4
    assert calls.count("streaming_lse_fwd") == 2
    assert calls.count("streaming_lse_bwd") == 2
