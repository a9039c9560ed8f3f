"""The port's layers and towers against the JAX package on the same weights.

Weights are a numpy-seeded JAX-layout tree (`xclip_tpu_torch.convert.
numpy_params`), loaded into the port with `load_jax_params`; inputs come
from a numpy seed. JAX's Pallas kernels run in interpret mode on the CPU,
the port's wrappers run their plain versions. Small sizes: dim 128,
2 heads × 64, depth 2. fp32 is compared at 1e-4 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.nn import core as jcore
from xclip_tpu.nn import layers as jlayers
from xclip_tpu.nn.text import TextTransformer as JText
from xclip_tpu.nn.vision import VisionTransformer as JVision
from xclip_tpu.utils import cast_tuple as jcast_tuple, l2norm as jl2norm, \
    masked_mean as jmasked_mean
from xclip_tpu_torch import utils as tutils
from xclip_tpu_torch.convert import load_jax_params, numpy_params
from xclip_tpu_torch.nn import layers as tlayers
from xclip_tpu_torch.nn.core import layer_norm
from xclip_tpu_torch.nn.text import TextTransformer
from xclip_tpu_torch.nn.vision import VisionTransformer
import torch_one_thread  # noqa: F401

CFG = dict(dim_text=128, dim_image=128, dim_latent=64, num_text_tokens=50,
           text_enc_depth=2, text_seq_len=8, text_heads=2,
           visual_enc_depth=2, visual_heads=2, visual_image_size=16,
           visual_patch_size=8)
TREE = numpy_params(CFG, seed=3)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(a, dtype=torch.float32):
    a = np.asarray(a)
    return torch.from_numpy(a) if a.dtype in (bool, np.int32, np.int64) \
        else torch.from_numpy(a.astype(np.float32)).to(dtype)


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def _x_mask(b=2, n=17, dim=128, seed=0, with_mask=True):
    npr = np.random.RandomState(seed)
    x = npr.randn(b, n, dim).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.ones((b, n), dtype=bool)
        mask[0, n // 3:] = False
    return x, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches(dtype):
    npr = np.random.RandomState(1)
    x, g = npr.randn(5, 64).astype(np.float32) * 3 + 1, npr.randn(64)
    want = jcore.layer_norm_apply({"g": jnp.asarray(g, dtype)},
                                  jnp.asarray(x, dtype))
    got = layer_norm(_t(x, getattr(torch, dtype)), _t(g, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # bf16: one ulp at |y| < 8
    _close(got, want, atol=1e-5 if dtype == "float32" else 2.0 ** -5)


def test_utils_match():
    for t in (3, (3, 4), [3]):
        assert tutils.cast_tuple(t) == jcast_tuple(t)
    npr = np.random.RandomState(2)
    t = npr.randn(4, 6, 8).astype(np.float32)
    t[0] = 0.0
    mask = npr.rand(4, 6) > 0.5
    mask[1] = False
    _close(tutils.l2norm(_t(t)), jl2norm(jnp.asarray(t)), atol=1e-6)
    _close(tutils.masked_mean(_t(t), _t(mask)[..., None]),
           jmasked_mean(jnp.asarray(t), jnp.asarray(mask)[..., None]),
           atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_xla_route_matches(causal):
    x, mask = _x_mask()
    p = jax.tree.map(lambda a: a[0], TREE["text"]["transformer"]["layers"])
    want = jlayers.attention_apply(_j(p["attn"]), jnp.asarray(x), heads=2,
                                   dim_head=64, causal=causal,
                                   mask=jnp.asarray(mask))
    attn = tlayers.Attention(128, dim_head=64, heads=2)
    load_jax_params(attn, p["attn"])
    with torch.no_grad():
        got = attn(_t(x), _t(mask), causal)
    _close(got, want)


def test_feed_forward_xla_route_matches():
    x, _ = _x_mask()
    p = jax.tree.map(lambda a: a[1], TREE["text"]["transformer"]["layers"])
    want = jlayers.feed_forward_apply(_j(p["ff"]), jnp.asarray(x))
    ff = tlayers.FeedForward(128)
    load_jax_params(ff, p["ff"])
    with torch.no_grad():
        _close(ff(_t(x)), want)


STACK_CASES = [  # (attn_impl, ff_impl, n, with_mask)
    ("xla", "xla", 17, True),
    ("xla", "block_stored", 17, False),
    ("fused", "xla", 17, True),
    ("fused", "block_stored", 17, True),
    ("fused_recompute", "block", 17, False),
    # n >= 128: the JAX stack pads 129 → 136 rows for its kernels
    ("fused", "block_stored", 129, True),
    # K8 beside the plain attention and the megablock
    ("xla", "fused", 17, True),
    ("fused", "fused", 17, False),
]


@pytest.mark.parametrize("attn_impl,ff_impl,n,with_mask", STACK_CASES)
def test_transformer_stack_matches(attn_impl, ff_impl, n, with_mask):
    x, mask = _x_mask(n=n, with_mask=with_mask)
    tree = TREE["text"]["transformer"]
    want = jlayers.transformer_apply(
        _j(tree), jnp.asarray(x), heads=2, dim_head=64,
        mask=None if mask is None else jnp.asarray(mask),
        attn_impl=attn_impl, ff_impl=ff_impl)
    stack = tlayers.Transformer(128, depth=2, dim_head=64, heads=2)
    load_jax_params(stack, tree)
    with torch.no_grad():
        got = stack(_t(x), None if mask is None else _t(mask),
                    attn_impl=attn_impl, ff_impl=ff_impl)
    _close(got, want)


def test_transformer_stack_matches_bf16():
    """bf16 storage on the kernel route: both sides round at the same
    places; 4 bf16 ulps at |out| < 4 allow summation-order flips that
    propagate through two layers."""
    x, mask = _x_mask()
    tree = TREE["text"]["transformer"]
    want = jlayers.transformer_apply(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree),
        jnp.asarray(x, jnp.bfloat16), heads=2, dim_head=64,
        mask=jnp.asarray(mask), attn_impl="fused", ff_impl="block_stored")
    stack = tlayers.Transformer(128, depth=2, dim_head=64, heads=2,
                                dtype=torch.bfloat16)
    load_jax_params(stack, tree)
    with torch.no_grad():
        got = stack(_t(x, torch.bfloat16), _t(mask), attn_impl="fused",
                    ff_impl="block_stored")
    _close(got, want, atol=4 * 2.0 ** -6)


def test_routes_out_of_slice_raise():
    """Every ff_impl has a route ('fused' runs K8); unknown routes raise."""
    stack = tlayers.Transformer(64, depth=1, dim_head=64, heads=1)
    x = torch.zeros(1, 3, 64)
    with torch.no_grad():
        assert stack(x, ff_impl="fused").shape == x.shape
    with pytest.raises(ValueError):
        stack(x, attn_impl="nope")
    with pytest.raises(ValueError):
        stack(x, ff_impl="nope")


@pytest.mark.parametrize("attn_impl,ff_impl", [("xla", "xla"),
                                               ("fused", "block_stored"),
                                               ("fused", "fused")])
def test_text_tower_matches(attn_impl, ff_impl):
    npr = np.random.RandomState(4)
    ids = npr.randint(1, 50, (3, 8))
    mask = np.ones((3, 8), dtype=bool)
    mask[0, 5:] = False
    jt = JText(dim=128, num_tokens=50, max_seq_len=8, depth=2, heads=2,
               ff_impl=ff_impl)
    want = jt.apply(_j(TREE["text"]), jnp.asarray(ids), jnp.asarray(mask),
                    attn_impl=attn_impl)
    tt = TextTransformer(128, 50, 8, depth=2, heads=2, ff_impl=ff_impl)
    load_jax_params(tt, TREE["text"])
    with torch.no_grad():
        got = tt(torch.from_numpy(ids), _t(mask), attn_impl=attn_impl)
    assert got.shape == (3, 9, 128)
    _close(got, want)


def test_vision_tower_matches():
    img = np.random.RandomState(5).randn(2, 3, 16, 16).astype(np.float32)
    jv = JVision(dim=128, image_size=16, patch_size=8, depth=2, heads=2,
                 ff_impl="block_stored")
    want = jv.apply(_j(TREE["visual"]), jnp.asarray(img), attn_impl="xla")
    tv = VisionTransformer(128, 16, 8, depth=2, heads=2,
                           ff_impl="block_stored")
    load_jax_params(tv, TREE["visual"])
    np.testing.assert_array_equal(
        tv.patchify(_t(img)).numpy(),
        np.asarray(jv.patchify(jnp.asarray(img))))
    with torch.no_grad():
        got = tv(_t(img), attn_impl="xla")
    assert got.shape == (2, 5, 128)
    _close(got, want)
