"""The port's tiny CLIP end to end against `xclip_tpu.CLIP` on the same
weights (`numpy_params` → `load_jax_params`), plus the surface checks:
signature, out-of-slice flags, no CPU fallback, no JAX import.

fp32 outputs are compared at 1e-4 absolute; the bf16-compute case at the
tolerance stated there.
"""

import inspect
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xclip_tpu
from xclip_tpu import eval as jeval
import xclip_tpu_torch
from xclip_tpu_torch import eval as teval
from xclip_tpu_torch.convert import load_jax_params, numpy_params
import torch_one_thread  # noqa: F401

TINY = dict(dim_text=64, dim_image=64, dim_latent=64, num_text_tokens=100,
            text_enc_depth=2, text_seq_len=16, text_heads=2,
            visual_enc_depth=2, visual_heads=2, visual_image_size=32,
            visual_patch_size=16)
KERNEL_ROUTES = dict(attn_impl="fused", visual_attn_impl="xla",
                     ff_impl="block_stored")


def _inputs(b=4, seed=0):
    npr = np.random.RandomState(seed)
    text = npr.randint(1, 100, (b, 16))
    for i in range(b):
        text[i, 16 - 3 * i:] = 0          # padded captions of mixed lengths
    return text, npr.randn(b, 3, 32, 32).astype(np.float32)


def _pair(seed=0, **flags):
    """(jax CLIP, jax params, port CLIP) with identical weights."""
    tree = numpy_params({**TINY, **flags}, seed)
    jclip = xclip_tpu.CLIP(**TINY, **flags)
    params = jax.tree.map(jnp.asarray, tree)
    assert (jax.tree.structure(params) == jax.tree.structure(jclip.params))
    tclip = xclip_tpu_torch.CLIP(**TINY, **flags, device="cpu")
    load_jax_params(tclip, tree)
    return jclip, params, tclip


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.fixture(scope="module")
def kernel_pair():
    return _pair(**KERNEL_ROUTES)


def test_sims_encodings_latents_match(kernel_pair):
    jclip, params, tclip = kernel_pair
    text, image = _inputs()
    jt, ji = jnp.asarray(text), jnp.asarray(image)
    tt, ti = torch.from_numpy(text), torch.from_numpy(image)
    _close(tclip(tt, ti), jclip(jt, ji, params=params))
    for got, want in zip(tclip(tt, ti, return_encodings=True),
                         jclip(jt, ji, return_encodings=True, params=params)):
        assert got.shape == want.shape
        _close(got, want)
    for got, want in zip(tclip(tt, ti, return_latents=True),
                         jclip(jt, ji, return_latents=True, params=params)):
        assert got.dtype == torch.float32
        _close(got, want)
    _close(tclip.model.encode_text(tt), jax.jit(jclip.model.encode_text)(params, jt))
    _close(tclip.model.encode_image(ti),
           jax.jit(jclip.model.encode_image)(params, ji))


def test_zero_shot_and_retrieval_match(kernel_pair):
    jclip, params, tclip = kernel_pair
    text, image = _inputs(b=6, seed=1)
    classes, _ = _inputs(b=6, seed=2)       # 3 classes × 2 templates
    jcls = jeval.build_zero_shot_classifier(jclip.model, params,
                                            jnp.asarray(classes),
                                            templates_per_class=2)
    tcls = teval.build_zero_shot_classifier(tclip, torch.from_numpy(classes),
                                            templates_per_class=2)
    _close(tcls, jcls)
    jlog = jeval.zero_shot_logits(jclip.model, params, jnp.asarray(image), jcls)
    tlog = teval.zero_shot_logits(tclip, torch.from_numpy(image), tcls)
    _close(tlog, jlog)
    labels = np.array([0, 1, 2, 0, 1, 2])
    assert (teval.zero_shot_accuracy(tclip, torch.from_numpy(image), labels,
                                     tcls, topk=(1, 2))
            == jeval.zero_shot_accuracy(jclip.model, params, jnp.asarray(image),
                                        labels, jcls, topk=(1, 2)))
    tl, il = tclip(torch.from_numpy(text), torch.from_numpy(image),
                   return_latents=True)
    jl = jclip(jnp.asarray(text), jnp.asarray(image), return_latents=True,
               params=params)
    assert teval.retrieval_metrics(tl, il) == jeval.retrieval_metrics(*jl)


@pytest.mark.parametrize("helper", ["build_zero_shot_classifier",
                                    "zero_shot_logits"])
def test_zero_shot_refuses_filip(helper):
    """A FILIP model's latents are per token: both zero-shot helpers raise
    JAX's ValueError, in its words, where JAX raises it."""
    jclip, params, tclip = _pair(use_all_token_embeds=True)
    classes, image = _inputs(b=2, seed=5)
    with pytest.raises(ValueError) as want:
        if helper == "build_zero_shot_classifier":
            jeval.build_zero_shot_classifier(jclip.model, params,
                                             jnp.asarray(classes))
        else:
            jeval.zero_shot_logits(jclip.model, params, jnp.asarray(image),
                                   jnp.zeros((2, 64)))
    with pytest.raises(ValueError) as got:
        if helper == "build_zero_shot_classifier":
            teval.build_zero_shot_classifier(tclip,
                                             torch.from_numpy(classes))
        else:
            teval.zero_shot_logits(tclip.model, torch.from_numpy(image),
                                   torch.zeros(2, 64))
    assert str(got.value) == str(want.value)
    assert "use_all_token_embeds=True" in str(got.value)


def test_exports_match_jax():
    assert xclip_tpu_torch.__all__ == xclip_tpu.__all__
    for name in xclip_tpu_torch.__all__:
        assert getattr(xclip_tpu_torch, name).__name__ == name


def test_parallel_and_train_exports_match_jax():
    """`xclip_tpu_torch.parallel` and `.train` hold every name of JAX's,
    each with JAX's meaning: `replicated` is the placement whole on every
    rank (the data-parallel loss's collective of that name stays in
    `parallel.collectives`). JAX's `TrainState` and `create_train_state`
    have no counterpart: the port's state is the model and its
    optimizer."""
    import xclip_tpu.parallel as jpar
    import xclip_tpu.train as jtrain
    import xclip_tpu_torch.parallel as tpar
    import xclip_tpu_torch.train as ttrain
    from xclip_tpu_torch.parallel import collectives, mesh, sharding
    assert set(jpar.__all__) <= set(tpar.__all__)
    assert set(jtrain.__all__) - {"TrainState", "create_train_state"} \
        <= set(ttrain.__all__)
    for module, names in ((tpar, jpar.__all__), (ttrain, jtrain.__all__)):
        for name in set(names) & set(module.__all__):
            assert getattr(module, name).__name__ == name
    assert tpar.replicated is mesh.replicated
    assert tpar.replicated is not collectives.replicated
    assert tpar.param_spec is sharding.param_spec
    assert tpar.create_mesh.__module__ == "xclip_tpu_torch.parallel.mesh"


def test_extra_latent_heads_match():
    """All-plain routes, with the extra latent heads: text_to_image=False
    scores through the extra heads, and return_latents gives four."""
    jclip, params, tclip = _pair(extra_latent_projection=True)
    text, image = _inputs(seed=3)
    jt, ji = jnp.asarray(text), jnp.asarray(image)
    tt, ti = torch.from_numpy(text), torch.from_numpy(image)
    _close(tclip(tt, ti, text_to_image=False),
           jclip(jt, ji, text_to_image=False, params=params))
    got = tclip(tt, ti, return_latents=True)
    want = jclip(jt, ji, return_latents=True, params=params)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w)


def test_bf16_compute_matches():
    """compute_dtype='bfloat16' on the kernel routes. Both sides round to
    bf16 at the same places, but a summation-order flip of one rounding
    moves a latent by a bf16 ulp and spreads through two layers; scores
    are |s| <= e, so 2e-2 absolute is a few bf16 ulps of the score."""
    jclip, params, tclip = _pair(compute_dtype="bfloat16", **KERNEL_ROUTES)
    text, image = _inputs(seed=4)
    want = jclip(jnp.asarray(text), jnp.asarray(image), params=params)
    got = tclip(torch.from_numpy(text), torch.from_numpy(image))
    assert got.dtype == torch.float32
    _close(got, want, atol=2e-2)


# ------------------------------------------------------------- the surface

def _params(fn, drop=()):
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if k not in drop}


def test_signature_matches_jax_clip():
    jax_init = _params(xclip_tpu.CLIP.__init__, drop=("key",))
    port_init = _params(xclip_tpu_torch.CLIP.__init__,
                        drop=("device", "seed", "generator"))
    assert list(jax_init) == list(port_init)
    for k in jax_init:
        if k != "param_dtype":              # jnp.float32 vs torch.float32
            assert jax_init[k] == port_init[k], k
    jax_call = _params(xclip_tpu.CLIP.__call__,
                       drop=("rng", "params", "return_metrics"))
    # the port's own training extras: the patch-dropout, dropout, MLM and
    # visual SSL draws (JAX's rng), the metrics flag, the pad-and-mask
    # rows and `gather_impl` (JAX's train step and shard_map callers hand
    # them to `CLIPModel.apply`)
    port_call = _params(xclip_tpu_torch.CLIP.forward,
                        drop=("return_metrics", "generator", "keep_idx",
                              "dropout_keep", "row_valid", "mlm_draws",
                              "ssl_draws", "gather_impl"))
    assert list(jax_call) == list(port_call)


def _jax_loss_and_port_draws(jclip, params, text, image, rng, b, **kw):
    """JAX's training loss with `rng`, and the draws the port is given
    for it (`torch_objectives_draws.jax_draws`)."""
    from torch_objectives_draws import jax_draws
    model = jclip.model
    views = 1 + len(kw.get("aug_image", ()))
    want = jax.jit(lambda p: model.apply(
        p, jnp.asarray(text), jnp.asarray(image), return_loss=True, rng=rng,
        training=True, **kw))(params)
    draws = jax_draws(rng, b=b, views=views, mlm=model.mlm is not None,
                      ssl=(None if model.visual_ssl is None else
                           type(model.visual_ssl).__name__.lower()),
                      num_patches=4, prob=0.5)
    return want, draws


SSL_INSTANCE = "a SimSiam instance"


@pytest.mark.parametrize("flags", [
    pytest.param(dict(use_all_token_embeds=True), id="flags0-FILIP"),
    pytest.param(dict(downsample_image_embeds=True), id="flags1-FILIP"),
    pytest.param(dict(filip_block=4), id="flags2-FILIP"),
    # the rotary, causal text tower and 'flash' are ported
    # (tests/test_torch_rotary.py); so is what they combine with
    pytest.param(dict(use_all_token_embeds=True, text_rotary_pos_emb=True),
                 id="flags3-FILIP"),
    pytest.param(dict(use_visual_ssl=True, text_causal_mask=True,
                      text_eos_id=1), id="flags4-use_visual_ssl"),
    pytest.param(dict(use_mlm=True), id="flags5-use_mlm"),
    pytest.param(dict(use_visual_ssl=True), id="flags6-use_visual_ssl"),
    pytest.param(dict(visual_ssl=SSL_INSTANCE), id="flags7-use_visual_ssl"),
])
def test_out_of_slice_flags_raise(flags):
    """The objectives' flags, which raised while they were unported, now
    build as JAX's do: where JAX refuses them (downsampling without FILIP)
    the port refuses them in its words; elsewhere the port's inference
    scores (1e-4) and training loss (1e-5, JAX's draws injected) match
    JAX's. `visual_ssl` takes each package's own SimSiam."""
    import re
    from xclip_tpu.objectives.ssl import SimSiam as JSimSiam
    from xclip_tpu_torch.objectives.ssl import SimSiam as TSimSiam
    jflags, tflags = dict(flags), dict(flags)
    if flags.get("visual_ssl") == SSL_INSTANCE:
        kw = dict(image_size=32, projection_size=16,
                  projection_hidden_size=32)
        jflags["visual_ssl"], tflags["visual_ssl"] = (JSimSiam(**kw),
                                                      TSimSiam(**kw))
    try:
        jclip = xclip_tpu.CLIP(**TINY, **jflags)
    except AssertionError as err:
        with pytest.raises(AssertionError, match=re.escape(str(err))):
            xclip_tpu_torch.CLIP(**TINY, **tflags, device="cpu")
        return
    tree = numpy_params({**TINY, **jflags}, 0)
    params = jax.tree.map(jnp.asarray, tree)
    assert jax.tree.structure(params) == jax.tree.structure(jclip.params)
    tclip = xclip_tpu_torch.CLIP(**TINY, **tflags, device="cpu")
    load_jax_params(tclip, tree)
    text, image = _inputs(seed=6)
    tt, ti = torch.from_numpy(text), torch.from_numpy(image)
    _close(tclip(tt, ti), jclip(jnp.asarray(text), jnp.asarray(image),
                                params=params))
    want, draws = _jax_loss_and_port_draws(jclip, params, text, image,
                                           jax.random.PRNGKey(9), 4)
    np.testing.assert_allclose(
        tclip(tt, ti, return_loss=True, **draws).item(), float(want),
        atol=1e-5)


@pytest.mark.parametrize("flags", [
    dict(attn_impl="flash", ff_impl="fused"),
    dict(visual_attn_impl="flash", ff_impl="fused"),
    dict(ff_impl="fused")], ids=["flash", "visual-flash", "megablock"])
def test_fused_ff_flags_serve_like_jax(flags):
    """ff_impl='fused' (K8) builds beside every attention route and its
    scores and latents match the JAX package's."""
    jclip, params, tclip = _pair(**{**KERNEL_ROUTES, **flags})
    text, image = _inputs(seed=5)
    jt, ji = jnp.asarray(text), jnp.asarray(image)
    tt, ti = torch.from_numpy(text), torch.from_numpy(image)
    _close(tclip(tt, ti), jclip(jt, ji, params=params))
    for got, want in zip(tclip(tt, ti, return_latents=True),
                         jclip(jt, ji, return_latents=True, params=params)):
        _close(got, want)


def test_training_calls_raise():
    """Training runs (tests/test_torch_train.py), with augmented views too:
    their loss is JAX's (1e-5, JAX's patch draws injected); a loss without
    training and augmented views at inference are errors, as in JAX."""
    jclip, params, clip = _pair()
    npt, npi = _inputs(b=2)
    text, image = torch.from_numpy(npt), torch.from_numpy(npi)
    loss = clip(text, image, return_loss=True)
    assert loss.shape == () and loss.requires_grad
    want, draws = _jax_loss_and_port_draws(
        jclip, params, npt, npi, jax.random.PRNGKey(2), 2,
        aug_image=(jnp.asarray(npi[::-1].copy()),))
    loss = clip(text, image, return_loss=True, aug_image=image.flip(0),
                **draws)
    assert loss.requires_grad
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-5)
    with pytest.raises(ValueError, match="not training"):
        clip(text, image, return_loss=True, training=False)
    with pytest.raises(ValueError, match="augmented"):
        clip(text, image, aug_text=text)
    with pytest.raises(TypeError, match="unexpected"):
        xclip_tpu_torch.CLIP(**TINY, not_a_flag=1, device="cpu")


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not fall back"):
        xclip_tpu_torch.CLIP(**TINY, device="cuda")


def test_device_defaults_to_cuda(monkeypatch):
    """With no `device`, the parameters go to the card; without one that
    raises rather than falling back to the CPU."""
    assert inspect.signature(xclip_tpu_torch.CLIP).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not fall back"):
        xclip_tpu_torch.CLIP(**TINY)


def test_loss_impl_fused_builds_and_runs():
    """`loss_impl='fused'` (K5's streaming log-sum-exp, its plain version
    on the CPU) gives the dense InfoNCE's loss, and trains."""
    text, image = map(torch.from_numpy, _inputs(b=3))
    keep = torch.tensor([[0, 2], [1, 3], [3, 0]])
    losses = []
    for impl in ("xla", "fused"):
        clip = xclip_tpu_torch.CLIP(**TINY, loss_impl=impl, seed=2,
                                    device="cpu")
        loss = clip(text, image, return_loss=True, keep_idx=keep)
        loss.backward()
        assert clip.temperature.grad is not None
        losses.append(loss.item())
    np.testing.assert_allclose(losses[1], losses[0], rtol=0, atol=1e-5)


def test_load_jax_params_is_strict():
    clip = xclip_tpu_torch.CLIP(**TINY, device="cpu")
    tree = numpy_params(TINY, seed=0)
    del tree["to_text_latent_extra"]
    with pytest.raises(KeyError, match="to_text_latent_extra"):
        load_jax_params(clip, tree)
    tree = numpy_params(TINY, seed=0)
    tree["unused"] = {"w": np.zeros(1, np.float32)}
    with pytest.raises(KeyError, match="unused"):
        load_jax_params(clip, tree)
    tree = numpy_params({**TINY, "dim_latent": 128}, seed=0)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(clip, tree)


def test_seeded_init_is_reproducible():
    a = xclip_tpu_torch.CLIP(**TINY, seed=7, device="cpu").state_dict()
    b = xclip_tpu_torch.CLIP(**TINY, seed=7, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["model.to_text_latent.w"],
                       a["model.to_text_latent_extra.w"])


def test_import_leaves_jax_out():
    code = ("import sys, xclip_tpu_torch, xclip_tpu_torch.eval, "
            "xclip_tpu_torch.convert, xclip_tpu_torch.parallel; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    subprocess.run([sys.executable, "-c", code], check=True)
