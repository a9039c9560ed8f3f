"""The rotary, causal-EOS text tower of the port against the JAX package on
the same numpy-seeded weights and inputs: rotary embeddings, `Attention`
with rotary on the 'xla', 'fused' (K6) and 'flash' (K7) routes, the text
tower, EOS pooling, and a tiny CLIP (`text_rotary_pos_emb`,
`text_causal_mask`, `text_eos_id`) on those routes: outputs, the loss, the
full gradient tree and three AdamW steps. JAX's Pallas kernels run in
interpret mode, the port's wrappers their plain versions.

Tolerances: rotary tables fp32 1e-6 relative (an ulp of the angle; cos and
sin come from two libraries), the rotation bit-equal in bf16 from the same
table (both round at the same points); layer and tower outputs fp32 1e-4
absolute; EOS pooling bit-exact (a gather); the CLIP as
`tests/test_torch_train.py`: outputs 1e-4, loss 1e-5, gradients rtol 1e-3
with atol 1e-5 of the leaf's largest magnitude, parameters after each AdamW
step 2e-6.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xclip_tpu
from xclip_tpu.nn import layers as jlayers
from xclip_tpu.nn.text import TextTransformer as JText
from xclip_tpu.train import trainer as jtrainer
import xclip_tpu_torch
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree
from xclip_tpu_torch.kernels import attention_block as core
from xclip_tpu_torch.nn import layers as tlayers
from xclip_tpu_torch.nn.text import TextTransformer
from xclip_tpu_torch.train import default_optimizer, make_train_step

from test_torch_train import _tree_close, jax_keep_idx
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

EOS = 99
TINY = dict(dim_text=64, dim_image=64, dim_latent=64, num_text_tokens=100,
            text_enc_depth=2, text_seq_len=16, text_heads=2,
            visual_enc_depth=2, visual_heads=2, visual_image_size=48,
            visual_patch_size=16, visual_patch_dropout=0.5,
            text_rotary_pos_emb=True, text_causal_mask=True,
            text_eos_id=EOS)
ROUTES = {"xla": dict(attn_impl="xla"),
          "fused": dict(attn_impl="fused", visual_attn_impl="xla",
                        ff_impl="block_stored"),
          "flash": dict(attn_impl="flash", ff_impl="block_stored")}
LAYER_TREE = numpy_params(dict(dim_text=128, text_heads=2, text_enc_depth=2,
                               text_seq_len=8, text_rotary_pos_emb=True,
                               text_causal_mask=True, text_eos_id=1,
                               num_text_tokens=50), seed=3)["text"]


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _captions(b=4, n=16, seed=0):
    """Token ids ending in EOS then pads (row 0), with two EOS (row 1),
    with no EOS (row 2), and EOS in the last position (row 3)."""
    npr = np.random.RandomState(seed)
    text = npr.randint(1, EOS, (max(b, 4), n))
    text[0, 9], text[0, 10:] = EOS, 0
    text[1, 4], text[1, 11], text[1, 12:] = EOS, EOS, 0
    text[2, 13:] = 0
    text[3, n - 1] = EOS
    return text[:b]


# ---------------------------------------------------------------- rotary

@pytest.mark.parametrize("seq_len,rot_dim", [(17, 32), (256, 32), (9, 16)])
def test_rotary_freqs_match(seq_len, rot_dim):
    got = tlayers.rotary_freqs(seq_len, rot_dim)
    assert got.dtype == torch.float32 and got.shape == (seq_len, rot_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jlayers.rotary_freqs(seq_len, rot_dim)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rotary_matches(dtype):
    """Partial rotation of the first 32 of 64 features, cos and sin cast to
    the tensor's dtype: bit-equal in bf16 from the same table."""
    freqs = np.array(jlayers.rotary_freqs(17, 32))
    t = np.random.RandomState(1).randn(2, 3, 17, 64).astype(np.float32)
    want = jlayers.apply_rotary_pos_emb(jnp.asarray(freqs),
                                        jnp.asarray(t, dtype))
    got = tlayers.apply_rotary_pos_emb(
        torch.from_numpy(freqs), torch.from_numpy(t).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    else:
        _close(got, want, atol=1e-6)
    np.testing.assert_array_equal(got[..., 32:].float().numpy(),
                                  np.asarray(want, np.float32)[..., 32:])


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("attn_impl", ["xla", "fused", "flash"])
def test_attention_with_rotary_matches(attn_impl, causal):
    """`Attention` with rotary against `attention_apply` on each route: the
    output and the gradient of the input."""
    npr = np.random.RandomState(2)
    x = npr.randn(2, 17, 128).astype(np.float32)
    mask = np.ones((2, 17), dtype=bool)
    mask[0, 11:] = False
    p = jax.tree.map(lambda a: a[0], LAYER_TREE["transformer"]["layers"])
    rotary = jlayers.rotary_freqs(17, 32)

    def f(xx):
        return jlayers.attention_apply(
            jax.tree.map(jnp.asarray, p["attn"]), xx, heads=2, dim_head=64,
            causal=causal, mask=jnp.asarray(mask), rotary=rotary,
            attn_impl=attn_impl)

    want = f(jnp.asarray(x))
    want_dx = jax.grad(lambda xx: jnp.sum(f(xx) ** 2))(jnp.asarray(x))
    attn = tlayers.Attention(128, dim_head=64, heads=2)
    load_jax_params(attn, p["attn"])
    tx = torch.from_numpy(x).requires_grad_(True)
    got = attn(tx, torch.from_numpy(mask), causal,
               tlayers.rotary_freqs(17, 32), attn_impl)
    (got ** 2).sum().backward()
    _close(got, want)
    _close(tx.grad, want_dx, atol=1e-3 * max(1.0, float(np.abs(want_dx).max())))


def test_fused_route_without_head_groups_takes_the_plain_route():
    """Three heads of 64 do not tile into 128-lane groups: 'fused' warns
    and computes what 'xla' does, as `attention_apply` (no kernel call)."""
    attn = tlayers.Attention(64, dim_head=64, heads=3)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 9, 64)
                         .astype(np.float32))
    rotary = tlayers.rotary_freqs(9, 32)
    before = core.attention_core_fwd.launches
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        got = attn(x, None, True, rotary, "fused")
    torch.testing.assert_close(got, attn(x, None, True, rotary, "xla"),
                               rtol=0, atol=0)
    assert core.attention_core_fwd.launches == before


@pytest.mark.parametrize("attn_impl,ff_impl,causal", [
    ("xla", "xla", True), ("fused", "block_stored", True),
    ("flash", "block_stored", True), ("fused_recompute", "block", True),
    ("fused", "xla", False), ("flash", "xla", False)])
def test_text_tower_rotary_matches(attn_impl, ff_impl, causal):
    """The rotary text tower, causal (no CLS, freqs for n) or not (CLS at
    position 0, freqs for n + 1), against JAX's."""
    text = _captions(b=3, seed=4) % 50
    mask = text != 0
    tree = dict(LAYER_TREE)
    if not causal:
        tree["cls_token"] = np.random.RandomState(5).randn(128).astype(
            np.float32)
    jt = JText(dim=128, num_tokens=50, max_seq_len=8, depth=2, heads=2,
               rotary_pos_emb=True, causal=causal, ff_impl=ff_impl)
    want = jt.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(text),
                    jnp.asarray(mask), attn_impl=attn_impl)
    tt = TextTransformer(128, 50, 8, depth=2, heads=2, rotary_pos_emb=True,
                         causal=causal, ff_impl=ff_impl)
    assert tt.abs_pos_emb is None and (tt.cls_token is None) == causal
    load_jax_params(tt, tree)
    with torch.no_grad():
        got = tt(torch.from_numpy(text), torch.from_numpy(mask),
                 attn_impl=attn_impl)
    assert got.shape == (3, 16 + (not causal), 128)
    _close(got, want)


def test_eos_reorder_matches_jax():
    """Rows with one EOS, two EOS (the first pooled), none (the last non-pad
    token pooled, the last position dropped from the rest) and all pads
    (position n − 1 pooled): bit-exact."""
    text = _captions(b=5, n=16, seed=6)
    text[4] = 0
    enc = np.random.RandomState(7).randn(5, 16, 8).astype(np.float32)
    jclip = xclip_tpu.CLIP(**TINY)
    want = jclip.model._eos_reorder(jnp.asarray(enc), jnp.asarray(text))
    tclip = xclip_tpu_torch.CLIP(**TINY, device="cpu")
    got = tclip.model._eos_reorder(torch.from_numpy(enc),
                                   torch.from_numpy(text))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  enc[np.arange(5), [9, 4, 12, 15, 15]])


# ---------------------------------------------------------------- CLIP

def _pair(route, seed=0):
    config = {**TINY, **ROUTES[route]}
    tree = numpy_params(config, seed)
    jclip = xclip_tpu.CLIP(**config)
    params = jax.tree.map(jnp.asarray, tree)
    assert jax.tree.structure(params) == jax.tree.structure(jclip.params)
    tclip = xclip_tpu_torch.CLIP(**config, device="cpu")
    load_jax_params(tclip, tree)
    return jclip, params, tclip


def _images(b=4, seed=0):
    return np.random.RandomState(seed).randn(b, 3, 48, 48).astype(np.float32)


@pytest.mark.parametrize("route", ["xla", "fused", "flash"])
def test_rotary_clip_outputs_match(route):
    jclip, params, tclip = _pair(route)
    text, image = _captions(), _images()
    jt, ji = jnp.asarray(text), jnp.asarray(image)
    tt, ti = torch.from_numpy(text), torch.from_numpy(image)
    _close(tclip(tt, ti), jclip(jt, ji, params=params))
    for got, want in zip(tclip(tt, ti, return_encodings=True),
                         jclip(jt, ji, return_encodings=True, params=params)):
        assert got.shape == want.shape
        _close(got, want)
    for got, want in zip(tclip(tt, ti, return_latents=True),
                         jclip(jt, ji, return_latents=True, params=params)):
        _close(got, want)
    _close(tclip.model.encode_text(tt),
           jax.jit(jclip.model.encode_text)(params, jt))


@pytest.mark.parametrize("route", ["xla", "fused", "flash"])
def test_rotary_clip_loss_and_grads_match(route):
    jclip, params, tclip = _pair(route)
    text, image = _captions(seed=1), _images(seed=1)
    rng = jax.random.PRNGKey(5)

    def loss_fn(p):
        return jclip.model.apply(p, jnp.asarray(text), jnp.asarray(image),
                                 return_loss=True, rng=rng, training=True)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = tclip(torch.from_numpy(text), torch.from_numpy(image),
                 return_loss=True, keep_idx=jax_keep_idx(rng, 4, 9, 0.5))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    _tree_close(to_jax_tree(tclip, grads=True), want_grads, rtol=1e-3,
                atol_scale=1e-5)


@pytest.mark.parametrize("route", ["xla", "fused", "flash"])
def test_rotary_clip_train_steps_match(route):
    """Three steps of make_train_step against JAX's: losses, pre-clip grad
    norms and every parameter after each step."""
    jclip, params, tclip = _pair(route, seed=2)
    text, image = _captions(seed=2), _images(seed=2)
    sched = dict(learning_rate=1e-4, warmup_steps=2, total_steps=5)
    jopt = jtrainer.default_optimizer(**sched)
    state = jtrainer.TrainState(params=params, opt_state=jopt.init(params),
                                step=jnp.zeros((), jnp.int32))
    jstep = jtrainer.make_train_step(jclip.model, jopt, donate=False)
    step = make_train_step(tclip, default_optimizer(tclip.parameters(),
                                                    **sched))
    for i in range(3):
        rng = jax.random.PRNGKey(200 + i)
        state, want = jstep(state, jnp.asarray(text), jnp.asarray(image), rng)
        got = step(torch.from_numpy(text), torch.from_numpy(image),
                   keep_idx=jax_keep_idx(rng, 4, 9, 0.5))
        for k in ("loss", "cl_loss", "temperature", "grad_norm"):
            np.testing.assert_allclose(got[k].item(), float(want[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        _tree_close(to_jax_tree(tclip), state.params, atol=2e-6)


@pytest.mark.parametrize("attn_impl,kernel", [
    ("fused", "core"), ("fused_recompute", "core"), ("fused_qkv", "core"),
    ("flash", "flash")])
def test_rotary_routes_take_their_kernels(monkeypatch, attn_impl, kernel):
    """Under rotary every megablock flag becomes K6's attention core, in
    inference and training, and 'flash' K7; the megablock is not called."""
    calls = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    spy(core, "attention_core")
    for name in ("flash_attention", "attention_block", "attention_block_train",
                 "attention_block_train_recompute"):
        spy(tlayers, name)
    clip = xclip_tpu_torch.CLIP(**{**TINY, "attn_impl": attn_impl,
                                   "visual_attn_impl": "xla"}, device="cpu")
    text, image = torch.from_numpy(_captions(b=2)), torch.from_numpy(
        _images(b=2))
    want = {"core": "attention_core", "flash": "flash_attention"}[kernel]
    clip(text, image)
    assert set(calls) == {want}
    calls.clear()
    clip(text, image, return_loss=True).backward()
    assert set(calls) == {want}


# ---------------------------------------------------------------- surface

@pytest.mark.parametrize("flags", [
    dict(text_rotary_pos_emb=True),
    dict(text_causal_mask=True, text_eos_id=5),
    dict(text_rotary_pos_emb=True, text_causal_mask=True, text_eos_id=5)],
    ids=["rotary", "causal", "rotary-causal"])
def test_convert_round_trips_rotary_causal_tree(flags):
    """numpy_params leaves out abs_pos_emb under rotary and cls_token when
    causal, as JAX's init; load_jax_params / to_jax_tree round-trip it, and
    the leaves both configs share are drawn alike."""
    base = {k: v for k, v in TINY.items() if not k.startswith("text_") or
            k in ("text_enc_depth", "text_seq_len", "text_heads")}
    config = {**base, **flags}
    tree = numpy_params(config, seed=4)
    jclip = xclip_tpu.CLIP(**config)
    assert (jax.tree.structure(jax.tree.map(jnp.asarray, tree))
            == jax.tree.structure(jclip.params))
    assert ("abs_pos_emb" in tree["text"]) == (
        not flags.get("text_rotary_pos_emb"))
    assert ("cls_token" in tree["text"]) == (
        not flags.get("text_causal_mask"))
    tclip = xclip_tpu_torch.CLIP(**config, device="cpu")
    load_jax_params(tclip, tree)
    _tree_close(to_jax_tree(tclip), tree, atol=0)
    np.testing.assert_array_equal(
        tree["text"]["token_emb"]["emb"],
        numpy_params(base, seed=4)["text"]["token_emb"]["emb"])


def test_causal_needs_an_eos_id():
    with pytest.raises(AssertionError, match="EOS"):
        xclip_tpu.CLIP(**{**TINY, "text_eos_id": None})
    with pytest.raises(AssertionError, match="EOS"):
        xclip_tpu_torch.CLIP(**{**TINY, "text_eos_id": None}, device="cpu")
