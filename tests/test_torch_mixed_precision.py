"""fp32 parameters with bf16 compute (`param_dtype` fp32, `compute_dtype=
'bfloat16'`) against the JAX package on the CPU, with and without SimSiam:
the training loss and every gradient of the tiny CLIP, the port on its
kernel routes (their plain versions here), JAX on its plain routes.

JAX rounds every float parameter to bf16 on entry, BatchNorm statistics
included (`CLIPModel._cast_params`); the SimSiam views are fp32 (the
augmentation promotes them), so they meet the rounded weights in fp32 and
the gradients come back through the rounding. The port must do the same.

Tolerances are the bf16 step's of `tests/test_torch_train.py`: the loss and
every gradient leaf within twice what JAX's own bf16 forward differs from
its fp32 forward on the rounded weights (per leaf, by the largest
magnitude) plus two bf16 ulps of the leaf's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xclip_tpu
import xclip_tpu_torch
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree

from test_torch_objectives import (KERNEL_ROUTES, PLAIN_ROUTES, TINY,
                                   _ssl_pair, inputs, leaves)
from torch_objectives_draws import jax_draws
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")


def _ulps(x, count=2):
    """`count` bf16 ulps at |x|."""
    return count * 2.0 ** (np.floor(np.log2(max(abs(float(x)),
                                                 2.0 ** -126))) - 7)


@pytest.mark.parametrize("ssl", [None, "simsiam"])
def test_fp32_params_bf16_compute_match_jax(ssl):
    jssl_, tssl_ = _ssl_pair(ssl) if ssl else (None, None)
    tree = numpy_params({**TINY, "visual_ssl": jssl_}, 3)
    jclip = xclip_tpu.CLIP(**TINY, **PLAIN_ROUTES, visual_ssl=jssl_,
                           compute_dtype="bfloat16")
    jclip32 = xclip_tpu.CLIP(**TINY, **PLAIN_ROUTES, visual_ssl=jssl_)
    params = jax.tree.map(jnp.asarray, tree)
    tclip = xclip_tpu_torch.CLIP(**TINY, **KERNEL_ROUTES, visual_ssl=tssl_,
                                 compute_dtype="bfloat16", device="cpu")
    load_jax_params(tclip, tree)
    assert tclip.model.temperature.dtype == torch.float32
    text, image, _, _ = inputs(4, 3)
    rng = jax.random.PRNGKey(9)

    def loss_fn(clip, p):
        return clip.model.apply(p, jnp.asarray(text), jnp.asarray(image),
                                return_loss=True, rng=rng, training=True)

    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(jclip, p)))(params)
    # the scale of bf16 rounding: JAX's fp32 forward on the rounded weights
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(
        jclip32, jax.tree.map(
            lambda x: x.astype(jnp.bfloat16).astype(jnp.float32), p))))(
        params)
    loss = tclip(torch.from_numpy(text), torch.from_numpy(image),
                 return_loss=True, **jax_draws(rng, b=4, ssl=ssl))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= (
        2 * abs(float(want_loss) - float(ref_loss)) + _ulps(want_loss))
    got, want, ref = (leaves(t) for t in (
        to_jax_tree(tclip, grads=True), want_grads, ref_grads))
    assert got.keys() == want.keys()
    for k, w in want.items():
        top = np.abs(ref[k]).max()
        tol = 2 * np.abs(w - ref[k]).max() + _ulps(top)
        assert np.abs(got[k] - w).max() <= tol, k
