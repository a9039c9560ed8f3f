"""The port's data-parallel objectives across four gloo ranks on the CPU
against the JAX package's distributed loss: K5's loss (`loss_impl=
'fused'`, its plain version here, at each rank's row offset), FILIP in
column blocks that divide the gathered batch, DCL's gradients, multiview,
the MLM and SimSiam losses averaged over the ranks with JAX's draws
injected, pad-and-mask across shards, and JAX's assertion under the
group. The harness and the tolerances are `tests/test_torch_distributed.py`'s:
the loss 1e-5 absolute on every rank; the ranks' gradients summed, per leaf
rtol 1e-3 with atol 1e-5 times max(1, the leaf's largest magnitude).

JAX's references: for the contrastive objectives its `shard_map` loss and
its single-device global gradients (the two agree there); for the MLM and
SimSiam its `shard_map` loss (and, for the MLM, the gradients of that
loss), as each rank takes those terms on its own shard
(`model.py:400-407`), every device drawing from the same key.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from xclip_tpu.objectives import contrastive as jcon
from xclip_tpu.objectives import ssl as jssl
from xclip_tpu_torch.objectives import ssl as tssl

from test_torch_distributed import (WORLD, check_grads, check_losses,
                                    global_batch, global_value_and_grad,
                                    jax_clip, loss_case, mesh4,
                                    rank_results, shard_map_loss)
from torch_dist_worker import flat_tree, spawn
from torch_objectives_draws import jax_mlm_draws, jax_ssl_draws
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

KEY = jax.random.PRNGKey(0)
SSL_KW = dict(image_size=16, hidden_layer=-1, projection_size=16,
              projection_hidden_size=32)
GATHERS = ("sharded", "replicated")


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy() if hasattr(tree, "numpy") else tree


def _batch(seed, **kw):
    text, image = global_batch(seed=seed, **kw)
    return dict(text=text, image=image)


def _cases():
    cases = []
    for g in GATHERS:
        gk = dict(gather_impl=g)
        cases.append(loss_case(
            f"fused-{g}", dict(loss_impl="fused",
                               decoupled_contrastive_learning=True,
                               extra_latent_projection=True), 10,
            _batch(10), kwargs=gk))
        cases.append(loss_case(
            f"filip_block-{g}", dict(use_all_token_embeds=True,
                                     extra_latent_projection=True,
                                     filip_block=4), 11, _batch(11),
            kwargs=gk))
        text, image = global_batch(seed=5, pads=False)
        cases.append(loss_case(
            f"multiview-{g}", dict(multiview_loss_weight=0.1), 12,
            dict(text=text, image=image,
                 aug_text=global_batch(seed=6, pads=False)[0],
                 aug_image=global_batch(seed=7, pads=False)[1]),
            kwargs=gk))
        # pad-and-mask: rows 12..15 invalid, the last rank all padding
        text, image = global_batch(b=16, seed=3, pads=False)
        cases.append(loss_case(
            f"pad_and_mask-{g}", dict(), 13,
            dict(text=text, image=image, valid=np.arange(16) < 12),
            kwargs=gk))
    cases.append(loss_case("dcl_grads", dict(
        decoupled_contrastive_learning=True), 14,
        _batch(4, pads=False)))
    # the MLM and SimSiam: every device draws from KEY at its local shape
    cases.append(loss_case(
        "mlm", dict(use_mlm=True, mlm_mask_prob=0.5), 15, _batch(8),
        draws=dict(mlm_draws=_numpy(jax_mlm_draws(
            jax.random.fold_in(KEY, 0), (8 // WORLD, 8), 50)))))
    cases.append(loss_case(
        "simsiam", dict(), 16, _batch(9), ssl=("simsiam", SSL_KW),
        tree_ssl=tssl.SimSiam(**SSL_KW),
        draws=dict(ssl_draws=_numpy(jax_ssl_draws(
            jax.random.fold_in(KEY, 0), "simsiam", 8 // WORLD, 4, 0.0)))))
    text, image = global_batch(b=16, seed=3, pads=False)
    cases.append({**loss_case("fused_row_valid", dict(loss_impl="fused"),
                              17, dict(text=text, image=image,
                                       valid=np.arange(16) < 12)),
                  "kind": "raises"})
    return {c["name"]: c for c in cases}


CASES = _cases()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(list(CASES.values()), WORLD,
                 str(tmp_path_factory.mktemp("gloo")))


@functools.lru_cache(maxsize=None)
def _global(name):
    case = CASES[f"{name}-sharded"]
    jclip, params = jax_clip(case)
    return global_value_and_grad(jclip, params, case["batch"])


def _contrastive(ranks, name, gather_impl):
    case = CASES[f"{name}-{gather_impl}"]
    results = rank_results(ranks, case["name"])
    jclip, params = jax_clip(case)
    want = shard_map_loss(jclip, params, case["batch"],
                          gather_impl=gather_impl)
    check_losses(results, want)
    global_loss, global_grads = _global(name)
    np.testing.assert_allclose(want, global_loss, rtol=0, atol=1e-5)
    check_grads(results, global_grads)


@pytest.mark.parametrize("gather_impl", GATHERS)
def test_fused_loss_at_row_offsets(ranks, gather_impl):
    """K5 (its plain version) with DCL and the extra heads: under
    'sharded' each rank's rows at row offset 2·rank against the 8 gathered
    columns."""
    _contrastive(ranks, "fused", gather_impl)


@pytest.mark.parametrize("gather_impl", GATHERS)
def test_filip_blocks_divide_the_gathered_batch(ranks, gather_impl):
    """filip_block 4 divides the gathered 8, not the local 2."""
    _contrastive(ranks, "filip_block", gather_impl)


@pytest.mark.parametrize("gather_impl", GATHERS)
def test_multiview_loss(ranks, gather_impl):
    _contrastive(ranks, "multiview", gather_impl)


def test_dcl_grads_match_global(ranks):
    """`test_sharded_loss_grads_match_global`: DCL, the row-sharded loss."""
    case = CASES["dcl_grads"]
    results = rank_results(ranks, "dcl_grads")
    jclip, params = jax_clip(case)
    loss, grads = global_value_and_grad(jclip, params, case["batch"])
    check_losses(results, loss)
    check_grads(results, grads)


@pytest.mark.parametrize("gather_impl", GATHERS)
def test_pad_and_mask_matches_truncated(ranks, gather_impl):
    """Padded rows on the last rank leave the loss and every gradient:
    the truncated batch's, single-device."""
    case = CASES[f"pad_and_mask-{gather_impl}"]
    results = rank_results(ranks, case["name"])
    jclip, params = jax_clip(case)
    b = case["batch"]
    loss, grads = global_value_and_grad(
        jclip, params, dict(text=b["text"][:12], image=b["image"][:12]))
    check_losses(results, loss)
    check_grads(results, grads)


def _shard_map_value_and_grad(jclip, params, batch, **kw):
    fn = shard_map(
        lambda p, t, i: jclip.model.apply(p, t, i, return_loss=True,
                                          axis_name="data", rng=KEY, **kw),
        mesh=mesh4(), in_specs=(P(), P("data"), P("data")), out_specs=P(),
        check_vma=False)
    loss, grads = jax.jit(jax.value_and_grad(fn))(
        params, jnp.asarray(batch["text"]), jnp.asarray(batch["image"]))
    return float(loss), flat_tree(grads)


def test_mlm_loss_is_averaged_over_ranks(ranks):
    """The MLM on each rank's shard with JAX's draws, pmean'd."""
    case = CASES["mlm"]
    results = rank_results(ranks, "mlm")
    jclip, params = jax_clip(case)
    loss, grads = _shard_map_value_and_grad(jclip, params, case["batch"])
    check_losses(results, loss)
    assert all(float(r["metric:text_ssl_loss"]) > 0 for r in results)
    check_grads(results, grads)


def test_simsiam_loss_is_averaged_over_ranks(ranks):
    """SimSiam on each rank's shard (its BatchNorm over the shard) with
    JAX's draws, pmean'd (the pmean's backward is the MLM test's)."""
    case = CASES["simsiam"]
    results = rank_results(ranks, "simsiam")
    jclip, params = jax_clip(case, visual_ssl=jssl.SimSiam(**SSL_KW))
    fn = shard_map(
        lambda p, t, i: jclip.model.apply(p, t, i, return_loss=True,
                                          axis_name="data", rng=KEY),
        mesh=mesh4(), in_specs=(P(), P("data"), P("data")), out_specs=P(),
        check_vma=False)
    loss = float(jax.jit(fn)(params, jnp.asarray(case["batch"]["text"]),
                             jnp.asarray(case["batch"]["image"])))
    check_losses(results, loss)
    assert all(float(r["metric:image_ssl_loss"]) > 0 for r in results)


def test_row_valid_under_fused_raises_jax_words(ranks):
    results = rank_results(ranks, "fused_row_valid")
    lat = jnp.ones((1, 4, 8)) / jnp.sqrt(8.0)
    with pytest.raises(AssertionError) as want:
        jcon.clip_contrastive_loss(lat, lat, 1.0, loss_impl="fused",
                                   row_valid=jnp.ones(4, bool))
    for res in results:
        assert str(res["type"]) == "AssertionError"
        assert str(res["message"]) == str(want.value)
