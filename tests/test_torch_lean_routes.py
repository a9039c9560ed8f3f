"""Every training combination of the port's kernel routes against the JAX
package on the CPU: `attn_impl` in ('fused', 'fused_qkv',
'fused_recompute') × `ff_impl` in ('block', 'block_stored') × `loss_impl`
in ('xla', 'fused'), one cheap case each (the tiny CLIP at batch 2, patch
dropout on, one layer a tower): the loss and full gradient tree against
`jax.value_and_grad`, at the tolerances of `test_torch_train.py` (loss
1e-5; gradients rtol 1e-3 with atol 1e-5 times the leaf's largest
magnitude). The same for `ff_impl='fused'` (K8) beside the rotary tower on
K6, beside 'flash' (K7) and alone, and for the stored-h FF block
(`XCLIP_FF_STORE=h`) beside the recompute route, and of the lean routes
under remat and FF dropout.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu_torch.convert import to_jax_tree
from xclip_tpu_torch.nn import layers as tlayers

from test_torch_lean_train import _inputs, _pair, _tree_close
from test_torch_train import jax_keep_idx
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

COMBOS = list(itertools.product(("fused", "fused_qkv", "fused_recompute"),
                                ("block", "block_stored"), ("xla", "fused")))


def _check_training_matches_jax(**flags):
    jclip, params, tclip = _pair(seed=2, text_enc_depth=1,
                                 visual_enc_depth=1, **flags)
    text, image = _inputs(b=2, seed=2)
    rng = jax.random.PRNGKey(9)

    def loss_fn(p):
        return jclip.model.apply(p, jnp.asarray(text), jnp.asarray(image),
                                 return_loss=True, rng=rng, training=True)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = tclip(torch.from_numpy(text), torch.from_numpy(image),
                 return_loss=True, keep_idx=jax_keep_idx(rng, 2, 9, 0.5))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    _tree_close(to_jax_tree(tclip, grads=True), want_grads, rtol=1e-3,
                atol_scale=1e-5)


@pytest.mark.parametrize("attn_impl,ff_impl,loss_impl", COMBOS)
def test_training_route_matches_jax(attn_impl, ff_impl, loss_impl):
    _check_training_matches_jax(attn_impl=attn_impl, ff_impl=ff_impl,
                                loss_impl=loss_impl)


@pytest.mark.parametrize("flags", [
    # K8 beside the rotary tower on K6, beside K7 in both towers, alone
    dict(text_rotary_pos_emb=True, attn_impl="fused", ff_impl="fused"),
    dict(attn_impl="flash", ff_impl="fused"),
    dict(ff_impl="fused", loss_impl="fused"),
], ids=["flags0-K8", "flags1-K8", "flags2-K8"])
def test_unported_routes_raise_at_construction(flags):
    """The routes that raised at construction while K8 was unported now
    build, and train as the JAX package does."""
    _check_training_matches_jax(**flags)


@pytest.mark.parametrize("kwargs", [
    pytest.param(dict(attn_impl="fused_recompute",
                      checkpoint_during_training=True),
                 id="kwargs0-Queue 1, remat"),
    pytest.param(dict(attn_impl="fused_qkv", ff_dropout=0.1),
                 id="kwargs1-Queue 1, dropout in training"),
])
def test_lean_routes_keep_remat_and_dropout_raising(kwargs):
    """The lean routes under remat and FF dropout, which raised before,
    train as JAX's `transformer_apply` does
    (`test_torch_dropout.check_stack_matches_jax`)."""
    from test_torch_dropout import check_stack_matches_jax
    check_stack_matches_jax(ff_impl="block", **kwargs)


def test_stored_h_still_raises_beside_the_recompute_route(monkeypatch):
    """XCLIP_FF_STORE=h qualifies 'block_stored' only (K1-h, which no
    longer raises); 'block' keeps the recompute route. Both train as JAX
    does under the variable."""
    monkeypatch.setenv("XCLIP_FF_STORE", "h")
    for ff_impl in ("block_stored", "block"):
        _check_training_matches_jax(attn_impl="fused_recompute",
                                    ff_impl=ff_impl, loss_impl="fused")
