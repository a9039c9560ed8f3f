"""Training with every objective against the JAX package on the CPU: one
step of `make_train_step` (MLM, SimSiam or SimCLR, sim-reg, DCL, the
extra heads, K5's loss) against JAX's: the metrics, every parameter and
the folded BatchNorm statistics after it; a multiview step against JAX's
gradients, optax update and `_merge_bn_stats`; `grad_accum=2`, where only
the last microbatch's statistics count; the statistics through a
checkpoint; remat over the extra passes; the SimSiam targets on the
inference forwards; and JAX's assertions.

Tolerances (fp32): metrics, the gradient norm among them, 1e-5 absolute
and relative (the norm is accumulated in fp64: an fp32 norm on the CPU
summed the squares of SimCLR's 4096 × 4096 projector one by one and read
4e-4 low); parameters after the step 2e-6 absolute (the repo's rule);
BatchNorm statistics 1e-6 absolute with 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import xclip_tpu_torch
from xclip_tpu.train import trainer as jtrainer
from xclip_tpu_torch.convert import to_jax_tree
from xclip_tpu_torch.nn import layers as tlayers
from xclip_tpu_torch.train import (default_optimizer, make_train_step,
                                   restore_checkpoint, save_checkpoint)

from test_torch_objectives import ALL, TINY, inputs, leaves, make_pair
from torch_objectives_draws import jax_draws
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

SCHED = dict(learning_rate=1e-4, warmup_steps=2, total_steps=5)
BN_KEYS = ("['mean']", "['var']")


def params_close(got, want):
    """Parameters 2e-6 absolute; the BatchNorm statistics 1e-6 absolute
    with 1e-5 relative."""
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        bn = k.endswith(BN_KEYS)
        np.testing.assert_allclose(got[k], w, rtol=1e-5 if bn else 0,
                                   atol=1e-6 if bn else 2e-6, err_msg=k)


def _jax_state(params):
    jopt = jtrainer.default_optimizer(**SCHED)
    return jopt, jtrainer.TrainState(params=params,
                                     opt_state=jopt.init(params),
                                     step=jnp.zeros((), jnp.int32))


def _metrics_close(got, want):
    assert set(got) == set(want) - {"bn_updates"}
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("ssl", ["simsiam", "simclr"])
def test_train_step_matches_jax(ssl):
    jclip, params, tclip = make_pair(ssl=ssl, seed=5, **ALL,
                                     loss_impl="fused")
    text, image, _, _ = inputs(4, 5)
    jopt, state = _jax_state(params)
    step = make_train_step(tclip, default_optimizer(tclip.parameters(),
                                                    **SCHED))
    before = {k: v.clone() for k, v in tclip.state_dict().items()
              if k.endswith((".mean", ".var"))}
    rng = jax.random.PRNGKey(50)
    state, want = jtrainer.make_train_step(jclip.model, jopt, donate=False)(
        state, jnp.asarray(text), jnp.asarray(image), rng)
    got = step(torch.from_numpy(text), torch.from_numpy(image),
               **jax_draws(rng, b=4, mlm=True, ssl=ssl))
    _metrics_close(got, want)
    params_close(to_jax_tree(tclip), state.params)
    after = tclip.state_dict()
    assert before and all(not torch.equal(after[k], v)
                          for k, v in before.items())


def test_multiview_step_matches_jax():
    """JAX's step takes no augmented views: its gradients of `apply` with
    them, the optax update and `_merge_bn_stats`, as `make_train_step`
    composes them."""
    jclip, params, tclip = make_pair(ssl="simsiam", seed=6, **ALL)
    text, image, aug_text, aug_image = inputs(4, 6)
    rng = jax.random.PRNGKey(60)

    def loss_fn(p):
        return jclip.model.apply(
            p, jnp.asarray(text), jnp.asarray(image),
            aug_text=(jnp.asarray(aug_text),),
            aug_image=(jnp.asarray(aug_image),), return_loss=True, rng=rng,
            training=True, return_metrics=True)

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    jopt, state = _jax_state(params)
    updates, _ = jopt.update(grads, state.opt_state, params)
    new = jtrainer._merge_bn_stats(optax.apply_updates(params, updates),
                                   want.pop("bn_updates"))
    want["grad_norm"] = optax.global_norm(grads)
    got = make_train_step(tclip, default_optimizer(
        tclip.parameters(), **SCHED))(
        torch.from_numpy(text), torch.from_numpy(image),
        aug_text=torch.from_numpy(aug_text),
        aug_image=torch.from_numpy(aug_image),
        **jax_draws(rng, b=4, views=2, mlm=True, ssl="simsiam"))
    _metrics_close(got, want)
    params_close(to_jax_tree(tclip), new)


def test_grad_accum_keeps_the_last_microbatch_statistics():
    """`grad_accum=2` against JAX's: metrics and parameters; the
    statistics are the second microbatch's fold from the stored ones
    alone, as JAX documents (`trainer.py:64-69`)."""
    jclip, params, tclip = make_pair(ssl="simsiam", seed=7, **ALL)
    text, image, _, _ = inputs(4, 7)
    jopt, state = _jax_state(params)
    with pytest.warns(UserWarning, match="grad_accum=2"):
        step = make_train_step(tclip, default_optimizer(
            tclip.parameters(), **SCHED), grad_accum=2)
    rng = jax.random.PRNGKey(70)
    micro = [jax_draws(r, b=2, mlm=True, ssl="simsiam")
             for r in jax.random.split(rng, 2)]
    with pytest.warns(UserWarning):
        jstep = jtrainer.make_train_step(jclip.model, jopt, donate=False,
                                         grad_accum=2)
    state, want = jstep(state, jnp.asarray(text), jnp.asarray(image), rng)
    got = step(torch.from_numpy(text), torch.from_numpy(image),
               keep_idx=torch.cat([d["keep_idx"] for d in micro]),
               mlm_draws=[d["mlm_draws"] for d in micro],
               ssl_draws=[d["ssl_draws"] for d in micro])
    _metrics_close(got, want)
    params_close(to_jax_tree(tclip), state.params)
    # the second microbatch alone, from the stored statistics
    _, _, twin = make_pair(ssl="simsiam", seed=7, **ALL)
    _, m = twin(torch.from_numpy(text[2:]), torch.from_numpy(image[2:]),
                return_loss=True, return_metrics=True,
                keep_idx=micro[1]["keep_idx"], mlm_draws=micro[1][
                    "mlm_draws"], ssl_draws=micro[1]["ssl_draws"])
    state_dict = tclip.state_dict()
    for path, (mean, var) in m["bn_updates"].items():
        assert torch.equal(state_dict[f"model.{path}.mean"], mean)
        assert torch.equal(state_dict[f"model.{path}.var"], var)


def test_statistics_survive_a_checkpoint(tmp_path):
    """After a step, a checkpoint restores the BatchNorm statistics (and
    everything else) bit for bit into a fresh model."""
    _, _, tclip = make_pair(ssl="simsiam", seed=8, use_mlm=True)
    text, image, _, _ = inputs(4, 8)
    opt = default_optimizer(tclip.parameters(), **SCHED)
    make_train_step(tclip, opt)(torch.from_numpy(text),
                                torch.from_numpy(image))
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, tclip, opt, step=1)
    _, _, fresh = make_pair(ssl="simsiam", seed=9, use_mlm=True)
    fresh_opt = default_optimizer(fresh.parameters(), **SCHED)
    assert restore_checkpoint(path, fresh, fresh_opt) == 1
    want, got = tclip.state_dict(), fresh.state_dict()
    assert want.keys() == got.keys()
    assert any(k.endswith(".bn1.mean") for k in got)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_remat_replays_the_extra_passes():
    """`checkpoint_during_training` over the MLM and SSL passes (their
    patch draws from the generator, once): loss and gradients bit for bit
    the step without remat."""
    results = []
    for remat in (False, True):
        _, _, tclip = make_pair(ssl="simsiam", seed=10, **ALL,
                                checkpoint_during_training=remat)
        text, image, aug_text, aug_image = map(torch.from_numpy,
                                               inputs(4, 10))
        loss = tclip(text, image, aug_text=aug_text, aug_image=aug_image,
                     return_loss=True,
                     generator=torch.Generator().manual_seed(3))
        loss.backward()
        results.append((loss, {n: p.grad for n, p in tclip.named_parameters()
                               if p.grad is not None}))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1) and g0.keys() == g1.keys()
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_simsiam_targets_take_the_inference_forwards(monkeypatch):
    """The two target passes (under no_grad) run the lean forwards; the
    MLM pass, the online passes and the main towers the training ones."""
    calls = []

    def spy(name):
        fn = getattr(tlayers, name)

        def wrapped(*a, **k):
            calls.append((name, torch.is_grad_enabled()))
            return fn(*a, **k)
        monkeypatch.setattr(tlayers, name, wrapped)

    for name in ("attention_block", "attention_block_train", "ff_block",
                 "ff_block_train"):
        spy(name)
    _, _, tclip = make_pair(ssl="simsiam", seed=11, use_mlm=True,
                            port_routes=dict(attn_impl="fused",
                                             ff_impl="block_stored"))
    text, image, _, _ = map(torch.from_numpy, inputs(4, 11))
    tclip(text, image, return_loss=True).backward()
    depth = 2
    # text: MLM + main; vision: 2 online + main (training) and 2 targets
    want = {("attention_block_train", True): 5 * depth,
            ("ff_block_train", True): 5 * depth,
            ("attention_block", False): 2 * depth,
            ("ff_block", False): 2 * depth}
    assert {k: calls.count(k) for k in set(calls)} == want


def test_objective_assertions_are_jax_words():
    _, _, tclip = make_pair(ssl="simsiam", seed=12, use_mlm=True)
    text, image, aug_text, _ = map(torch.from_numpy, inputs(4, 12))
    with pytest.raises(AssertionError, match="row_valid only masks"):
        tclip(text, image, return_loss=True,
              row_valid=torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="augmented"):
        tclip(text, image, aug_text=aug_text)
    with pytest.raises(AssertionError):
        tclip(text, image, return_loss=True, aug_text=aug_text[:2])
    clip = xclip_tpu_torch.CLIP(**TINY, multiview_loss_weight=0.0,
                                device="cpu")
    with pytest.raises(AssertionError, match="multiview loss weight"):
        clip(text, image, return_loss=True, aug_text=aug_text)
    with pytest.raises(ValueError, match="unknown visual_ssl_type"):
        xclip_tpu_torch.CLIP(**TINY, use_visual_ssl=True,
                             visual_ssl_type="byol", device="cpu")
    with pytest.raises(AssertionError, match="downsampling"):
        xclip_tpu_torch.CLIP(**TINY, downsample_image_embeds=True,
                             device="cpu")
    clip = xclip_tpu_torch.CLIP(**TINY, use_all_token_embeds=True,
                                sim_reg_loss_weight=0.1, device="cpu")
    with pytest.raises(AssertionError, match="sim_reg with fine"):
        clip(text, image, return_loss=True)
