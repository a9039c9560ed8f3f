"""The port's data-parallel train step (`make_train_step(...,
axis_name=group)` on each rank's `shard_batch` rows) across four gloo
ranks on the CPU, against the JAX package's GSPMD step: `make_train_step`
over `shard_state` and `shard_batch` on a (4, 1) mesh of the 8 fake CPU
devices. One AdamW step: every rank's metrics (the loss, the contrastive
terms, the temperature) and `grad_norm`, the global ones, and every
parameter after the step. Then `grad_accum=2` under the group, with JAX's
warning: a microbatch is each rank's share of it, so JAX's step is given
the global batch in that order (microbatch i = the ranks' i-th
microbatches, rank by rank).

Tolerances (`tests/test_torch_train.py`): metrics 1e-5 absolute and
relative; parameters after the step 2e-6 absolute.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xclip_tpu.parallel import create_mesh
from xclip_tpu.train import trainer as jtrainer

from test_torch_distributed import (WORLD, global_batch, jax_clip,
                                    loss_case, rank_results)
from torch_dist_worker import flat_tree, spawn
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

OPT = dict(learning_rate=1e-4)
METRICS = ("loss", "cl_loss", "text_ssl_loss", "image_ssl_loss",
           "multiview_cl_loss", "sim_reg_loss", "temperature", "grad_norm")


def _step_case(name, over, seed, b, **step):
    text, image = global_batch(b=b, seed=seed)
    case = loss_case(name, over, seed, dict(text=text, image=image))
    return {**case, "kind": "step", "optimizer": OPT, "step": step}


CASES = {c["name"]: c for c in [
    _step_case("plain", {}, 20, 8),
    _step_case("dcl_extra_fused", dict(decoupled_contrastive_learning=True,
                                       extra_latent_projection=True,
                                       loss_impl="fused"), 21, 8),
    _step_case("grad_accum2", dict(decoupled_contrastive_learning=True),
               22, 16, grad_accum=2),
]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(list(CASES.values()), WORLD,
                 str(tmp_path_factory.mktemp("gloo")))


def _jax_step(case, order=None):
    """JAX's GSPMD step: (metrics, params after, its warnings)."""
    jclip, params = jax_clip(case)
    grad_accum = case["step"].get("grad_accum", 1)
    mesh = create_mesh((WORLD, 1), devices=jax.devices()[:WORLD])
    opt = jtrainer.default_optimizer(**OPT)
    state = jtrainer.shard_state(jtrainer.TrainState(
        params=params, opt_state=opt.init(params),
        step=jnp.zeros((), jnp.int32)), mesh)
    text, image = (case["batch"][k] for k in ("text", "image"))
    if order is not None:
        text, image = text[order], image[order]
    text, image = jtrainer.shard_batch((jnp.asarray(text),
                                        jnp.asarray(image)), mesh)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step = jtrainer.make_train_step(jclip.model, opt, donate=False,
                                        grad_accum=grad_accum)
    new, metrics = step(state, text, image, jax.random.PRNGKey(1))
    return metrics, flat_tree(new.params), [str(w.message) for w in caught]


def _check(results, metrics, params):
    for r, res in enumerate(results):
        for k in METRICS:
            np.testing.assert_allclose(
                float(res[f"metric:{k}"]), float(metrics[k]), rtol=1e-5,
                atol=1e-5, err_msg=f"rank {r} {k}")
        got = {k[len("param:"):]: v for k, v in res.items()
               if k.startswith("param:")}
        assert got.keys() == params.keys()
        for k, w in params.items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=2e-6,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("name", ["plain", "dcl_extra_fused"])
def test_dp_step_matches_jax_gspmd(ranks, name):
    """One AdamW step: the same metrics, `grad_norm` and parameters on
    every rank as JAX's GSPMD step on the global batch."""
    results = rank_results(ranks, name)
    metrics, params, _ = _jax_step(CASES[name])
    _check(results, metrics, params)
    for res in results:
        assert str(res["warnings"][0]) == ""


def test_dp_grad_accum_matches_jax_and_warns(ranks):
    results = rank_results(ranks, "grad_accum2")
    b, local, mb = 16, 16 // WORLD, 16 // WORLD // 2
    # JAX's microbatch i: rank 0's i-th microbatch, then rank 1's, ...
    order = np.concatenate([
        np.arange(r * local + i * mb, r * local + (i + 1) * mb)
        for i in range(2) for r in range(WORLD)])
    assert sorted(order) == list(range(b))
    metrics, params, jax_warnings = _jax_step(CASES["grad_accum2"], order)
    _check(results, metrics, params)
    assert any("negatives" in w for w in jax_warnings)
    for res in results:
        assert [str(w) for w in res["warnings"]] == [
            w for w in jax_warnings if "negatives" in w]
