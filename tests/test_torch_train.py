"""The port's training slice against the JAX package on the CPU: the loss and
full gradient tree of a tiny CLIP on the kernel routes (`attn_impl='fused',
visual_attn_impl='xla', ff_impl='block_stored'`), three AdamW steps of
`make_train_step`, the optimizer's schedule, and the routing of training.

Weights come from `convert.numpy_params` on both sides; the port's
gradients and parameters go back to a JAX-layout tree through
`convert.to_jax_tree`. Patch dropout is on: the port is given the patch
indices JAX draws, recovered here by replaying its draws (`CLIPModel.apply`
gives the vision tower `RngStream(rng)`'s second key, which the tower
splits, drawing uniform scores from the first half and keeping their
top-k). JAX's Pallas kernels run in interpret mode.

Tolerances: loss 1e-5 absolute; gradients per leaf rtol 1e-3 with atol
1e-5 times the leaf's largest magnitude; parameters after AdamW steps
2e-6 absolute, a few fp32 ulps of the O(1) weights, since each step moves
a weight by at most about the learning rate (1e-4) whatever the gradient's
magnitude. The bf16 step's tolerances are with its tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import xclip_tpu
from xclip_tpu.nn import layers as jlayers
from xclip_tpu.train import trainer as jtrainer
import xclip_tpu_torch
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree
from xclip_tpu_torch.nn import layers as tlayers
from xclip_tpu_torch.train import (default_optimizer, make_train_step,
                                   warmup_cosine_lr)

jax.config.update("jax_default_matmul_precision", "highest")

TINY = dict(dim_text=64, dim_image=64, dim_latent=64, num_text_tokens=100,
            text_enc_depth=2, text_seq_len=16, text_heads=2,
            visual_enc_depth=2, visual_heads=2, visual_image_size=48,
            visual_patch_size=16, visual_patch_dropout=0.5)
ROUTES = dict(attn_impl="fused", visual_attn_impl="xla",
              ff_impl="block_stored")


def _inputs(b=4, seed=0):
    npr = np.random.RandomState(seed)
    text = npr.randint(1, 100, (b, 16))
    for i in range(b):
        text[i, 16 - 3 * i:] = 0          # padded captions of mixed lengths
    return text, npr.randn(b, 3, 48, 48).astype(np.float32)


def jax_keep_idx(rng, b, num_patches, prob):
    """The patch indices `CLIPModel.apply(..., rng=rng, training=True)`
    keeps (no MLM / visual SSL: the vision tower takes the second key)."""
    vision_rng = jax.random.fold_in(rng, 1)
    rng_pd, _ = jax.random.split(vision_rng)
    scores = jax.random.uniform(rng_pd, (b, num_patches))
    _, keep = jax.lax.top_k(scores, max(1, int(num_patches * (1 - prob))))
    return torch.from_numpy(np.array(keep))


def _pair(seed=0, **flags):
    config = {**TINY, **ROUTES, **flags}
    tree = numpy_params(config, seed)
    jclip = xclip_tpu.CLIP(**config)
    tclip = xclip_tpu_torch.CLIP(**config, device="cpu")
    load_jax_params(tclip, tree)
    return jclip, jax.tree.map(jnp.asarray, tree), tclip


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _tree_close(got, want, **tol):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if "atol_scale" in tol:
            atol = tol["atol_scale"] * max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(got[k], w, rtol=tol["rtol"],
                                       atol=atol, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=tol["atol"],
                                       err_msg=k)


@pytest.mark.parametrize("flags", [
    {}, dict(decoupled_contrastive_learning=True),
    dict(extra_latent_projection=True), dict(ff_impl="fused")],
    ids=["plain", "dcl", "extra", "fused-ff"])
def test_loss_and_grads_match_jax(flags):
    jclip, params, tclip = _pair(**flags)
    text, image = _inputs()
    rng = jax.random.PRNGKey(5)

    def loss_fn(p):
        return jclip.model.apply(p, jnp.asarray(text), jnp.asarray(image),
                                 return_loss=True, rng=rng, training=True)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    keep = jax_keep_idx(rng, 4, 9, 0.5)
    loss = tclip(torch.from_numpy(text), torch.from_numpy(image),
                 return_loss=True, keep_idx=keep)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    _tree_close(to_jax_tree(tclip, grads=True), want_grads, rtol=1e-3,
                atol_scale=1e-5)


def test_train_steps_match_jax():
    """Three steps of make_train_step against JAX's, warmup-cosine schedule
    on: losses, pre-clip grad norms and every parameter after each step."""
    jclip, params, tclip = _pair(seed=1)
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


def test_step_metrics_match_jax():
    """One step's metrics: JAX's key set, every value within the step
    tolerances (1e-5), and the four losses of features that are off
    (text and image SSL, multiview, sim-reg) exactly 0."""
    jclip, params, tclip = _pair(seed=2)
    text, image = _inputs(seed=2)
    jopt = jtrainer.default_optimizer(learning_rate=1e-4)
    state = jtrainer.TrainState(params=params, opt_state=jopt.init(params),
                                step=jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(7)
    _, want = jtrainer.make_train_step(jclip.model, jopt, donate=False)(
        state, jnp.asarray(text), jnp.asarray(image), rng)
    got = make_train_step(tclip, default_optimizer(
        tclip.parameters(), learning_rate=1e-4))(
        torch.from_numpy(text), torch.from_numpy(image),
        keep_idx=jax_keep_idx(rng, 4, 9, 0.5))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].item(), float(w), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for k in ("text_ssl_loss", "image_ssl_loss", "multiview_cl_loss",
              "sim_reg_loss"):
        assert got[k].item() == 0.0 and float(want[k]) == 0.0, k


# ---------------------------------------------------------- bf16 steps
#
# The flagship trains in bf16 (param_dtype and compute_dtype bfloat16): the
# tiny CLIP on the kernel routes (their plain versions on the CPU) against
# `xclip_tpu`'s bf16 step on the same weights rounded to bf16. The two
# packages round to bf16 at other places (the port's kernels round where
# the Pallas bodies cast; XLA's CPU dots and fusions keep other values in
# fp32), so they are held to the size of bf16 rounding itself, taken from
# JAX: its fp32 step on the same bf16 weights. Tolerances: the loss and
# every gradient leaf within twice what JAX's own bf16 step differs from
# its fp32 step (per leaf, by the largest magnitude) plus two bf16 ulps of
# the leaf's largest magnitude (leaves both compute exactly, as zero
# gradients, get that alone); the gradient norm, which JAX reports in
# bf16, within two bf16 ulps of it; after one AdamW step (which moves a
# weight by +-lr whatever its gradient's size), every weight within 2 lr
# plus one bf16 ulp of it, and at most 1 % of them different at all: the
# two move a weight apart only where its gradient's sign differs, i.e.
# where the gradient is within rounding of zero.

def _bf16_pair(seed):
    config = {**TINY, **ROUTES}
    tree = numpy_params(config, seed)
    jclip = xclip_tpu.CLIP(**config, param_dtype=jnp.bfloat16,
                           compute_dtype="bfloat16")
    tclip = xclip_tpu_torch.CLIP(**config, param_dtype=torch.bfloat16,
                                 compute_dtype="bfloat16", device="cpu")
    load_jax_params(tclip, tree)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)
    return jclip, xclip_tpu.CLIP(**config), params, tclip


def _ulps(x, count=2):
    """`count` bf16 ulps at |x|."""
    return count * 2.0 ** (np.floor(np.log2(max(abs(float(x)),
                                                 2.0 ** -126))) - 7)


def _fp32_loss_and_grads(jclip32, params, text, image, rng):
    """JAX's fp32 step on the bf16 weights: the scale of bf16 rounding."""
    def loss_fn(p):
        return jclip32.model.apply(p, jnp.asarray(text), jnp.asarray(image),
                                   return_loss=True, rng=rng, training=True)
    return jax.value_and_grad(loss_fn)(
        jax.tree.map(lambda x: x.astype(jnp.float32), params))


def test_bf16_loss_and_grads_match_jax():
    jclip, jclip32, params, tclip = _bf16_pair(0)
    text, image = _inputs()
    rng = jax.random.PRNGKey(5)

    def loss_fn(p):
        return jclip.model.apply(p, jnp.asarray(text), jnp.asarray(image),
                                 return_loss=True, rng=rng, training=True)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    ref_loss, ref_grads = _fp32_loss_and_grads(jclip32, params, text, image,
                                               rng)
    loss = tclip(torch.from_numpy(text), torch.from_numpy(image),
                 return_loss=True, keep_idx=jax_keep_idx(rng, 4, 9, 0.5))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= (
        2 * abs(float(want_loss) - float(ref_loss)) + _ulps(want_loss))
    got, want, ref = (_leaves(t) for t in (
        to_jax_tree(tclip, grads=True), want_grads, ref_grads))
    assert got.keys() == want.keys()
    for k, w in want.items():
        top = np.abs(ref[k]).max()
        tol = 2 * np.abs(w - ref[k]).max() + _ulps(top)
        assert np.abs(got[k] - w).max() <= tol, k


def test_bf16_train_step_matches_jax():
    jclip, jclip32, params, tclip = _bf16_pair(1)
    text, image = _inputs(seed=1)
    lr = 1e-4
    jopt = jtrainer.default_optimizer(learning_rate=lr)
    state = jtrainer.TrainState(params=params, opt_state=jopt.init(params),
                                step=jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(100)
    ref_loss, _ = _fp32_loss_and_grads(jclip32, params, text, image, rng)
    state, want = jtrainer.make_train_step(jclip.model, jopt, donate=False)(
        state, jnp.asarray(text), jnp.asarray(image), rng)
    got = make_train_step(tclip, default_optimizer(
        tclip.parameters(), learning_rate=lr))(
        torch.from_numpy(text), torch.from_numpy(image),
        keep_idx=jax_keep_idx(rng, 4, 9, 0.5))
    for k in ("loss", "cl_loss"):
        assert abs(got[k].item() - float(want[k])) <= (
            2 * abs(float(want[k]) - float(ref_loss)) + _ulps(want[k])), k
    for k in ("temperature", "grad_norm"):
        assert abs(got[k].item() - float(want[k])) <= _ulps(want[k]), k
    before = _leaves(params)
    new, want_new = _leaves(to_jax_tree(tclip)), _leaves(state.params)
    differ = moved = total = 0
    for k, w in want_new.items():
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
                      - 7)
        diff = np.abs(new[k] - w)
        assert (diff <= 2 * lr + ulp).all(), k
        differ += int((diff > 0).sum())
        moved += int((w != before[k]).sum())
        total += diff.size
    # the step moves a third of the bf16 weights (the rest sit more than
    # 2 lr from their neighbours); the two disagree on a few in a thousand
    assert moved >= 0.1 * total
    assert differ <= 0.01 * total


@pytest.mark.parametrize("warmup,total", [(0, None), (3, 10), (8, 5),
                                          (1, 2)])
def test_schedule_matches_optax(warmup, total):
    lr = 3e-4
    if warmup and total:
        w = min(warmup, max(total - 1, 1))
        sched = optax.warmup_cosine_decay_schedule(0.0, lr, w, total)
    else:
        sched = lambda count: lr  # noqa: E731
    for t in range(12):
        np.testing.assert_allclose(warmup_cosine_lr(t, lr, warmup, total),
                                   float(sched(t)), rtol=1e-6, atol=1e-12)


def test_clip_matches_optax_global_norm_clip():
    """The clip scales by max_norm / norm (no 1e-6 in the norm)."""
    w = torch.nn.Parameter(torch.tensor([3.0, 4.0]))
    opt = default_optimizer([w], learning_rate=0.0, weight_decay=0.0,
                            max_grad_norm=1.0)
    w.grad = torch.tensor([3.0, 4.0])
    assert opt.step().item() == 5.0
    upd, _ = optax.clip_by_global_norm(1.0).update(jnp.asarray([3.0, 4.0]),
                                                   None)
    mu = opt.state[w]["mu"]
    np.testing.assert_allclose(mu.numpy() / 0.1, np.asarray(upd), rtol=1e-6)


def test_stack_grads_with_jax_sequence_padding():
    """n = 129 text rows: the JAX stack pads to 136 for its kernels, the
    port does not; pad rows get zero cotangents, so every gradient of the
    real rows agrees."""
    tree = numpy_params(dict(dim_text=128, text_heads=2, text_enc_depth=2,
                             text_seq_len=8), seed=3)["text"]["transformer"]
    npr = np.random.RandomState(0)
    x = npr.randn(2, 129, 128).astype(np.float32)
    mask = np.ones((2, 129), dtype=bool)
    mask[0, 50:] = False
    cot = npr.randn(2, 129, 128).astype(np.float32)

    def f(p, xx):
        out = jlayers.transformer_apply(
            p, xx, heads=2, dim_head=64, mask=jnp.asarray(mask),
            attn_impl="fused", ff_impl="block_stored", training=True)
        return jnp.sum(out * cot)

    want_p, want_x = jax.grad(f, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    stack = tlayers.Transformer(128, depth=2, dim_head=64, heads=2)
    load_jax_params(stack, tree)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = stack(tx, torch.from_numpy(mask), attn_impl="fused",
                ff_impl="block_stored", training=True)
    (out * torch.from_numpy(cot)).sum().backward()
    want_x = np.asarray(want_x)
    np.testing.assert_allclose(tx.grad.numpy(), want_x, rtol=1e-3,
                               atol=1e-5 * max(1.0, np.abs(want_x).max()))
    _tree_close(to_jax_tree(stack, grads=True), want_p, rtol=1e-3,
                atol_scale=1e-5)


# ------------------------------------------------------------- routing

@pytest.mark.parametrize("kwargs", [
    pytest.param(dict(attn_impl="flash", attn_dropout=0.1),
                 id="kwargs0-Queue 1, dropout in training"),
    # K8 trains; dropout beside it falls back to the plain FF, as in JAX
    pytest.param(dict(ff_impl="fused", ff_dropout=0.1), id="kwargs1-K8"),
    pytest.param(dict(ff_impl="block", checkpoint_during_training=True),
                 id="kwargs2-Queue 1, remat"),
    pytest.param(dict(checkpoint_during_training=True),
                 id="kwargs3-Queue 1, remat"),
    pytest.param(dict(attn_dropout=0.1),
                 id="kwargs4-Queue 1, dropout in training"),
    pytest.param(dict(ff_dropout=0.1),
                 id="kwargs5-Queue 1, dropout in training"),
])
def test_unported_training_routes_raise(kwargs):
    """The training routes that raised while remat and dropout were
    unported now train as JAX's `transformer_apply` does, the port given
    the keep masks JAX draws (`test_torch_dropout.check_stack_matches_jax`:
    fp32, loss 1e-5, gradients 1e-3 relative)."""
    from test_torch_dropout import check_stack_matches_jax
    check_stack_matches_jax(**kwargs)


def test_stored_h_variant_raises(monkeypatch):
    """XCLIP_FF_STORE=h no longer raises: the kernel routes train through
    K1-h; the tiny CLIP's loss and gradient tree against JAX's under the
    variable."""
    monkeypatch.setenv("XCLIP_FF_STORE", "h")
    test_loss_and_grads_match_jax({})


def test_unported_training_options_raise():
    """What training still lacks raises, naming its ROADMAP.md module;
    remat, `grad_accum` and `valid=`, which raised before, run."""
    text, image = map(torch.from_numpy, _inputs(b=2))
    clip = xclip_tpu_torch.CLIP(**TINY, checkpoint_during_training=True,
                                device="cpu")
    assert torch.isfinite(clip(text, image, return_loss=True))
    clip = xclip_tpu_torch.CLIP(**TINY, sim_reg_loss_weight=0.1,
                                device="cpu")
    with pytest.raises(NotImplementedError,
                       match="Queue 1, the objectives and heads"):
        clip(text, image, return_loss=True)
    with pytest.raises(NotImplementedError,
                       match="Queue 1, the objectives and heads"):
        clip(text, image, return_loss=True, aug_text=text)
    clip = xclip_tpu_torch.CLIP(**TINY, device="cpu")
    with pytest.warns(UserWarning, match="grad_accum=2"):
        step = make_train_step(clip, default_optimizer(clip.parameters()),
                               grad_accum=2)
    assert torch.isfinite(step(text, image)["grad_norm"])
    step = make_train_step(clip, default_optimizer(clip.parameters()))
    metrics = step(text, image, valid=torch.tensor([True, False]))
    assert torch.isfinite(metrics["loss"])


def test_inference_keeps_the_lean_forwards(monkeypatch):
    """Inference goes through K-FF / K-MEGA's wrappers, training through
    K1 / K2's; neither borrows the other's."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(tlayers, name, wrapped)

    for name in ("ff_block", "attention_block", "ff_block_train",
                 "attention_block_train"):
        spy(name, getattr(tlayers, name))
    clip = xclip_tpu_torch.CLIP(**TINY, **ROUTES, device="cpu")
    text, image = map(torch.from_numpy, _inputs(b=2))
    clip(text, image)
    assert set(calls) == {"ff_block", "attention_block"}
    calls.clear()
    clip(text, image, return_loss=True).backward()
    assert set(calls) == {"ff_block_train", "attention_block_train"}


def test_patch_dropout_draws_from_the_generator():
    clip = xclip_tpu_torch.CLIP(**TINY, device="cpu")
    text, image = map(torch.from_numpy, _inputs(b=2))
    a = clip(text, image, return_loss=True,
             generator=torch.Generator().manual_seed(3))
    b = clip(text, image, return_loss=True,
             generator=torch.Generator().manual_seed(3))
    assert a.item() == b.item()
    enc = clip(text, image, return_encodings=True, training=True)[1]
    assert enc.shape == (2, 1 + 4, 64)          # 4 of 9 patches + CLS
