"""Heads at their true width, up to 256 columns, in the port's attention
kernels against the JAX package, on the CPU.

The bf16 kernels read a head of any multiple of 8 up to 256 columns at its
true width (⌈dim_head / 64⌉ 64-column halves, the last zero-filled on
chip); the fp32 ones take 64 and 128. `_common.kernel_width` is the one
rule the wrappers follow, on the CPU as on the card. Here the wrappers run
their plain versions, held to JAX's Pallas bodies (interpret mode, jitted)
on the same numpy-seeded inputs, fp32:

* K-MEGA, K2 (`store_qkv=True`), K2 keeping only qkv (`store_qkv="qkv"`,
  the port's K3 qkv mode) and K3 (recompute) at (heads 2, dim_head 192)
  and (1, 256), with key pads and dead rows, causal and not: the output
  and every gradient;
* K6 at (2, 256) causal, alone and inside `Attention` with rotary;
* K7 at 192 and 256;
* a tiny CLIP (one layer a tower) with `text_dim_head=256` (rotary,
  causal EOS, on the K6 route) and `visual_dim_head=192` (the megablock),
  carried over by `convert`: the loss, every gradient and one AdamW step;
* the width rule for each (dim_head, heads, dtype) case, and spies: the
  bf16 wrappers at 80 and 192 never call `pad_heads`, and their plain
  versions get the true width.

Tolerances as `tests/test_torch_wide_heads.py`: outputs 1e-5 absolute,
the CLIP's loss 1e-5, gradients rtol 1e-3 with atol 1e-5 of the leaf's
largest magnitude; parameters after the AdamW step 2e-6, as
`tests/test_torch_train.py`, except where JAX's gradient is nonzero but
within 1e-5 of its leaf's largest magnitude: Adam's first step moves an
element by lr·g/(|g| + ε), which two gradients that close to zero can
turn into different shares of lr, so there the parameter is held to the
step size lr itself, and such elements must be under 1 % of each leaf
(exact zeros, unused token rows and the unused latent heads, stay at
2e-6). A head of 384, wider than any CUDA kernel takes, keeps its width
and runs the plain versions, held to JAX's K6, K7 and megablock; the
checks the wrappers make on the card refuse it.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import xclip_tpu
from xclip_tpu.model import CLIPModel as JCLIPModel
from xclip_tpu.kernels import attention_block as jcore
from xclip_tpu.kernels import attention_megablock as jmega
from xclip_tpu.kernels import flash_attention as jflash
from xclip_tpu.nn import layers as jlayers
from xclip_tpu.train import trainer as jtrainer
import xclip_tpu_torch
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree
from xclip_tpu_torch.kernels import attention_block as core
from xclip_tpu_torch.kernels import attention_megablock as mega
from xclip_tpu_torch.kernels import flash_attention as flash
from xclip_tpu_torch.kernels._common import kernel_width
from xclip_tpu_torch.nn import layers as tlayers
from xclip_tpu_torch.train import default_optimizer, make_train_step

from test_torch_rotary import TINY, _captions, _images
from test_torch_routes import _Limits
from test_torch_train import _leaves, _tree_close, jax_keep_idx
from test_torch_wide_heads import (GRAD_ATOL_SCALE, GRAD_RTOL, LOSS_ATOL,
                                   OUT_ATOL, MEGA_VARIANTS, _close,
                                   _close_grad, _mega_inputs)
from torch_port_inputs import core_args, flash_args
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

BF16, F32 = torch.bfloat16, torch.float32


# ------------------------------------------------------------ the rule

WIDTH_CASES = [  # (dim_head, heads (None: K6 / K7), dtype, kernel width)
    (32, None, BF16, 32), (72, None, BF16, 72), (80, None, BF16, 80),
    (88, None, BF16, 88), (104, None, BF16, 104), (128, None, BF16, 128),
    (192, None, BF16, 192), (256, None, BF16, 256), (100, None, BF16, 104),
    (8, None, BF16, 8), (3, None, BF16, 8),
    # the megablock: heads · width on the product kernel's 64 grid
    (80, 16, BF16, 80), (88, 16, BF16, 88), (104, 16, BF16, 104),
    (72, 16, BF16, 72), (32, 16, BF16, 32), (80, 2, BF16, 96),
    (72, 2, BF16, 96), (192, 2, BF16, 192), (256, 1, BF16, 256),
    (200, 1, BF16, 256),
    # fp32: 64 or 128, wider kept (the fp32 kernels' why_not refuses it)
    (80, None, F32, 128), (80, 16, F32, 128), (32, None, F32, 64),
    (128, None, F32, 128), (192, None, F32, 192)]


@pytest.mark.parametrize("dim_head,heads,dtype,width", WIDTH_CASES)
def test_kernel_width(monkeypatch, dim_head, heads, dtype, width):
    """The width each head runs at, and whether the CUDA predicates take
    it there: bf16 always (with the megablock's heads too); fp32 up to
    128."""
    monkeypatch.setattr(mega._build, "library", _Limits)
    assert kernel_width(dim_head, dtype, heads) == width
    dim = None if heads is None else 64 * heads
    reason = mega.why_not(dim, heads or 2, width, 64, dtype)
    assert (reason is None) == (dtype == BF16 or width <= 128), reason
    if heads is None:
        assert (flash.why_not(width, dtype) is None) == (reason is None)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("heads", [None, 1, 16])
def test_kernel_width_raises_past_256(dtype, heads):
    """No kernel takes a head wider than 256: the rule keeps such a head's
    width (the CPU's plain versions run it, as JAX's bodies do), and the
    checks the wrappers make before any launch on the card raise naming
    the limit: K6's and K7's with no heads given, the megablock's with
    them."""
    d = 264
    assert kernel_width(d, dtype, heads) == d
    limit = "up to 256" if dtype == BF16 else "64 or 128"
    mask = torch.ones(2, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match=f"{limit}.*not {d}"):
        if heads is None:
            qkv = torch.zeros(2, 64, 3 * 2 * d, dtype=dtype)
            mega._check_core("attention_core_fwd", qkv, mask, 2, d, False)
        else:
            dim, hd = 64, heads * d
            mega._check("attention_block", (
                torch.zeros(2, 64, dim, dtype=dtype),
                torch.ones(dim, dtype=dtype),
                torch.zeros(dim, 3 * hd, dtype=dtype),
                torch.zeros(hd, dim, dtype=dtype),
                torch.ones(dim, dtype=dtype)), mask, heads, d)
    if heads is None:
        with pytest.raises(ValueError, match=f"{limit}.*not {d}"):
            flash._check("flash_attention_fwd", [
                torch.zeros(4, 64, d, dtype=dtype) for _ in range(3)],
                mask.repeat(2, 1))


@pytest.mark.parametrize("which,heads,d", [
    ("mega", 16, 80), ("mega", 2, 192), ("k6", 2, 80), ("k6", 2, 192),
    ("k7", 2, 80), ("k7", 2, 192)])
def test_bf16_wrappers_keep_the_true_width(monkeypatch, which, heads, d):
    """The bf16 top-level wrappers at 80 and 192 never call `pad_heads`
    (nor pad K7's heads) and hand their plain versions the true width."""
    pads, widths = [], []
    pad_heads = mega.pad_heads

    def spy_pad(*a, **kw):
        pads.append(a[1])
        return pad_heads(*a, **kw)

    monkeypatch.setattr(mega, "pad_heads", spy_pad)
    monkeypatch.setattr(core, "pad_heads", spy_pad)
    for module, name, width_of in (
            (mega, "attention_block_plain", lambda a: a[7]),
            (mega, "attention_block_fwd_stored_plain", lambda a: a[7]),
            (core, "attention_core_fwd_plain", lambda a: a[3]),
            (flash, "flash_attention_fwd_plain", lambda a: a[0].shape[-1])):
        plain = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _p=plain, _w=width_of,
                            **kw: (widths.append(_w(a)), _p(*a, **kw))[1])
    gen = torch.Generator().manual_seed(d)
    b, n = 2, 9
    mask = torch.ones(b, n, dtype=torch.bool)
    mask[1, 5:] = False
    hd = heads * d
    if which == "mega":
        dim = 64
        x = torch.randn(b, n, dim, generator=gen).to(BF16)
        g = torch.ones(dim, dtype=BF16)
        w_qkv = (torch.randn(dim, 3 * hd, generator=gen) / 8).to(BF16)
        w_out = (torch.randn(hd, dim, generator=gen) / 8).to(BF16)
        with torch.no_grad():
            out = mega.attention_block(x, g, w_qkv, w_out, g, mask, heads, d,
                                       d ** -0.5)
        leaves = [t.clone().requires_grad_(True) for t in (x, w_qkv, w_out)]
        trained = mega.attention_block_train(leaves[0], g, leaves[1],
                                             leaves[2], g, mask, heads, d,
                                             d ** -0.5)
        trained.float().sum().backward()
        assert out.shape == trained.shape == x.shape
        assert leaves[1].grad.shape == (dim, 3 * hd)
    elif which == "k6":
        qkv = torch.randn(b, n, 3 * hd, generator=gen).to(BF16)
        out = core.attention_core(qkv, mask, heads, d, d ** -0.5, True)
        assert out.shape == (b, n, hd)
    else:
        q, k, v = (torch.randn(b, heads, n, d, generator=gen).to(BF16)
                   for _ in range(3))
        out = flash.flash_attention(q, k, v, mask, causal=True)
        assert out.shape == q.shape
    assert pads == []
    assert widths and set(widths) == {d}


# ------------------------------------------------------- the megablock

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("variant", list(MEGA_VARIANTS))
@pytest.mark.parametrize("heads,dim_head", [(2, 192), (1, 256)])
def test_megablock_at_true_width_matches_pallas(heads, dim_head, variant,
                                                causal):
    """K2, K2's qkv mode and K3 at heads of 192 and 256: the output and the
    gradients of all five tensors against `jmega.attention_block` in
    interpret mode (outputs 1e-5, gradients rtol 1e-3, atol 1e-5 of the
    largest magnitude); K-MEGA's forward under no_grad against JAX's
    inference forward (1e-5)."""
    args = _mega_inputs(dim_head, n=16, dim=64, heads=heads)
    scale = dim_head ** -0.5
    store_qkv, train, kw = MEGA_VARIANTS[variant]
    cot = np.random.RandomState(1).randn(*args[0].shape).astype(np.float32)
    ja = [jnp.asarray(a) for a in args]

    def f(*a):
        out = jmega.attention_block(*a, ja[5], heads, dim_head, scale, causal,
                                    True, True, store_qkv)
        return jnp.sum(out * cot), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(
        f, argnums=range(5), has_aux=True))(*ja[:5])
    ta = [torch.from_numpy(a) for a in args]
    leaves = [t.clone().requires_grad_(True) for t in ta[:5]]
    out = train(*leaves, ta[5], heads, dim_head, scale, causal, True, **kw)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, want, OUT_ATOL)
    for name, t, w in zip(("x", "g_pre", "w_qkv", "w_out", "g_out"), leaves,
                          want_grads):
        _close_grad(t.grad, w, name)
    if variant == "K2":
        with torch.no_grad():
            lean = mega.attention_block(*ta, heads, dim_head, scale, causal)
        _close(lean, jax.jit(lambda *a: jmega.attention_block(
            *a, heads, dim_head, scale, causal, True, True))(*ja), OUT_ATOL)


# ------------------------------------------------------------ K6 and K7

def test_k6_at_head_width_256_matches_pallas():
    """K6 on heads of 256, causal, with key pads, masked tiles and a dead
    element: the output (1e-5) and the gradient of a sum of squares (rtol
    1e-3) against `jcore.attention_core` in interpret mode."""
    qkv, mask, _ = core_args(n=33, mask_kind="dead", dim_head=256)
    scale = 256 ** -0.5

    def f(x):
        return jcore.attention_core(x, jnp.asarray(mask), 2, 256, scale,
                                    True, True, True)

    want, want_grad = jax.jit(lambda x: (f(x), jax.grad(
        lambda y: jnp.sum(f(y) ** 2))(x)))(jnp.asarray(qkv))
    tq = torch.from_numpy(qkv).requires_grad_(True)
    got = core.attention_core(tq, torch.from_numpy(mask), 2, 256, scale,
                              True, True)
    (got ** 2).sum().backward()
    _close(got, want, OUT_ATOL)
    _close_grad(tq.grad, want_grad)


def _attention_matches_jax(dim_head, attn_impl):
    """`Attention` (2 heads of `dim_head`) with rotary and causal on
    `attn_impl`'s route (PreNorm, qkv, rotary, the core, out product)
    against `attention_apply`: the output (1e-5) and the input's gradient
    (rtol 1e-3)."""
    tree = numpy_params(dict(dim_text=64, text_heads=2,
                             text_dim_head=dim_head, text_enc_depth=1,
                             text_seq_len=16, num_text_tokens=50), seed=3)
    p = jax.tree.map(lambda a: a[0],
                     tree["text"]["transformer"]["layers"])["attn"]
    npr = np.random.RandomState(4)
    x = npr.randn(2, 17, 64).astype(np.float32)
    mask = np.ones((2, 17), dtype=bool)
    mask[0, 11:] = False
    mask[1, :2] = False
    rotary = jlayers.rotary_freqs(17, 32)

    def f(xx):
        return jlayers.attention_apply(
            jax.tree.map(jnp.asarray, p), xx, heads=2, dim_head=dim_head,
            causal=True, mask=jnp.asarray(mask), rotary=rotary,
            attn_impl=attn_impl)

    want, want_dx = jax.jit(lambda xx: (f(xx), jax.grad(
        lambda y: jnp.sum(f(y) ** 2))(xx)))(jnp.asarray(x))
    attn = tlayers.Attention(64, dim_head=dim_head, heads=2)
    load_jax_params(attn, p)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = attn(tx, torch.from_numpy(mask), True, tlayers.rotary_freqs(17, 32),
               attn_impl)
    (got ** 2).sum().backward()
    _close(got, want, OUT_ATOL)
    _close_grad(tx.grad, want_dx)


def test_k6_route_with_rotary_at_head_width_256_matches_jax():
    """`Attention` with rotary and causal on the 'fused' route, K6 at heads
    of 256, against `attention_apply` (`_attention_matches_jax`)."""
    _attention_matches_jax(256, "fused")


@pytest.mark.parametrize("route", ["fused", "flash", "megablock"])
def test_heads_past_256_run_plain_on_the_cpu(monkeypatch, route):
    """A head of 384, wider than any CUDA kernel takes but taken by JAX's
    K6, K7 and megablock, keeps its width on the CPU, where the wrappers
    run their plain versions (no pad_heads call): `Attention` with rotary
    on the 'fused' (K6) and 'flash' (K7) routes against `attention_apply`
    (`_attention_matches_jax`), and K2 at one head of 384 against
    `jmega.attention_block` in interpret mode (outputs 1e-5, gradients
    rtol 1e-3)."""
    def no_pad(*a, **kw):
        raise AssertionError("pad_heads called")

    monkeypatch.setattr(mega, "pad_heads", no_pad)
    monkeypatch.setattr(core, "pad_heads", no_pad)
    if route != "megablock":
        _attention_matches_jax(384, route)
        return
    args = _mega_inputs(384, n=16, dim=64, heads=1)
    ja = [jnp.asarray(a) for a in args]

    def f(*a):
        out = jmega.attention_block(*a, ja[5], 1, 384, 384 ** -0.5, False,
                                    True, True, True)
        return jnp.sum(out), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(
        f, argnums=range(5), has_aux=True))(*ja[:5])
    ta = [torch.from_numpy(a) for a in args]
    leaves = [t.clone().requires_grad_(True) for t in ta[:5]]
    out = mega.attention_block_train(*leaves, ta[5], 1, 384, 384 ** -0.5)
    out.sum().backward()
    _close(out, want, OUT_ATOL)
    for name, t, w in zip(("x", "g_pre", "w_qkv", "w_out", "g_out"), leaves,
                          want_grads):
        _close_grad(t.grad, w, name)


@pytest.mark.parametrize("d", [192, 256])
def test_flash_at_true_width_matches_pallas(d):
    """K7 on heads of 192 and 256, causal (`flash_attention`, n padded to
    the kernels' tile) against `jflash.flash_attention` in interpret mode:
    the output (1e-5) and the gradients of q, k and v (rtol 1e-3)."""
    q, k, v, mask, _ = flash_args(n=37, mask_kind="holes", d=d)

    def f(a, b, c):
        return jflash.flash_attention(a, b, c, mask=jnp.asarray(mask),
                                      causal=True, interpret=True)

    ja = [jnp.asarray(t) for t in (q, k, v)]
    want, want_grads = jax.jit(lambda *a: (f(*a), jax.grad(
        lambda *b: jnp.sum(f(*b) ** 2), argnums=(0, 1, 2))(*a)))(*ja)
    tt = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    got = flash.flash_attention(*tt, torch.from_numpy(mask), True)
    (got ** 2).sum().backward()
    _close(got, want, OUT_ATOL)
    for name, t, w in zip("qkv", tt, want_grads):
        _close_grad(t.grad, w, name)


# ------------------------------------------------------------ the CLIP

def test_clip_at_true_widths_matches_jax(monkeypatch):
    """A tiny CLIP whose text heads are 256 wide (rotary, causal EOS: the
    K6 route) and whose vision heads are 192 wide (the megablock), its
    weights carried over by `convert`: the loss (1e-5) and every gradient
    (rtol 1e-3, atol 1e-5 of the leaf's largest magnitude), then one AdamW
    step of make_train_step (its loss and grad norm 1e-5, every parameter
    2e-6) against the JAX package's."""
    config = {**TINY, "text_dim_head": 256, "visual_dim_head": 192,
              "text_enc_depth": 1, "visual_enc_depth": 1,
              "attn_impl": "fused", "visual_attn_impl": "fused",
              "ff_impl": "block_stored"}
    tree = numpy_params(config, 6)
    # JAX's own random init would be thrown away for `tree`: skip it
    with mock.patch.object(JCLIPModel, "init", lambda *a, **kw: None):
        jclip = xclip_tpu.CLIP(**config)
    params = jax.tree.map(jnp.asarray, tree)
    tclip = xclip_tpu_torch.CLIP(**config, device="cpu")
    load_jax_params(tclip, tree)
    text, image = _captions(seed=6), _images(seed=6)
    jt, ji = jnp.asarray(text), jnp.asarray(image)
    tt, ti = torch.from_numpy(text), torch.from_numpy(image)
    rng = jax.random.PRNGKey(6)
    keep = jax_keep_idx(rng, 4, 9, 0.5)

    def loss_fn(p):
        return jclip.model.apply(p, jt, ji, return_loss=True, rng=rng,
                                 training=True)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    calls = []
    for module, name in ((core, "attention_core_fwd"),
                         (mega, "attention_block_fwd_stored")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _f=fn, _n=name, **kw:
                            (calls.append(_n), _f(*a, **kw))[1])
    loss = tclip(tt, ti, return_loss=True, keep_idx=keep)
    # both towers on their kernels' plain versions: K6 in the text layers,
    # K2 in the vision layers
    assert sorted(set(calls)) == ["attention_block_fwd_stored",
                                  "attention_core_fwd"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=LOSS_ATOL)
    _tree_close(to_jax_tree(tclip, grads=True), want_grads, rtol=GRAD_RTOL,
                atol_scale=GRAD_ATOL_SCALE)
    # JAX's train step on these gradients (its make_train_step applies the
    # optimizer to the same value_and_grad at grad_accum 1)
    jopt = jtrainer.default_optimizer(learning_rate=1e-4)
    want_params = jax.jit(lambda g, p: optax.apply_updates(
        p, jopt.update(g, jopt.init(p), p)[0]))(want_grads, params)
    tclip.zero_grad(set_to_none=True)
    got = make_train_step(tclip, default_optimizer(
        tclip.parameters(), learning_rate=1e-4))(tt, ti, keep_idx=keep)
    for k, w in (("loss", want_loss),
                 ("grad_norm", optax.global_norm(want_grads))):
        np.testing.assert_allclose(got[k].item(), float(w), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    got_params, want_params = _leaves(to_jax_tree(tclip)), _leaves(
        want_params)
    grads = _leaves(want_grads)
    assert got_params.keys() == want_params.keys() == grads.keys()
    for key, w in want_params.items():
        g = np.abs(grads[key])
        floor = (g > 0) & (g <= GRAD_ATOL_SCALE * float(g.max()))
        err = np.abs(got_params[key] - w)
        tol = np.where(floor, 1e-4, 2e-6)
        assert floor.mean() < 0.01, (key, float(floor.mean()))
        assert (err <= tol).all(), (key, float(err.max()),
                                    float(err[~floor].max(initial=0)))
