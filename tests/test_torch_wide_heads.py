"""Heads wider than 64 in the port's attention kernels against the JAX
package, on the CPU.

The fp32 kernels take heads of 64 and 128 (two 64-column halves); the
top-level wrappers zero-pad an fp32 head of 65 to 127 columns to 128
(`attention_megablock.pad_heads`, `_common.kernel_width`), so fp32's 80
runs at 128 (bf16 runs it at its true width:
`tests/test_torch_head_widths.py`). Here the wrappers run their plain
versions (the padding included), held to JAX's Pallas bodies in
interpret mode on the same numpy-seeded inputs, fp32:

* K-MEGA, K2 (`store_qkv=True`), K2 keeping only qkv (`store_qkv="qkv"`,
  the port's K3 qkv mode) and K3 (recompute) at (heads 2, dim_head 80) and
  (2, 128), with key pads and dead rows, causal and not: the output and
  every gradient;
* K6 at (2, 128) causal, alone and inside `Attention` with rotary;
* fp32 K7 at 128;
* a tiny CLIP with `visual_dim_head=80` and `text_dim_head=128`, carried
  over by `convert`: the loss and every gradient;
* `pad_heads` at 80 → 128 (fp32) against the plain versions at the true
  width.

Tolerances: outputs 1e-5 absolute (`tests/test_torch_attention_cores.py`;
the megablock's too, tighter than the 1e-4 of
`tests/test_torch_train_kernels.py`), the CLIP's loss 1e-5
(`tests/test_torch_train.py`); gradients rtol 1e-3 with atol 1e-5 of the
leaf's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.kernels import attention_block as jcore
from xclip_tpu.kernels import attention_megablock as jmega
from xclip_tpu.kernels import flash_attention as jflash
from xclip_tpu.nn import layers as jlayers
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree
from xclip_tpu_torch.kernels import attention_block as core
from xclip_tpu_torch.kernels import attention_megablock as mega
from xclip_tpu_torch.kernels import flash_attention as flash
from xclip_tpu_torch.nn import layers as tlayers

from test_torch_train import _inputs, _pair, _tree_close, jax_keep_idx
from torch_port_inputs import core_args, flash_args
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

OUT_ATOL, LOSS_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-3, 1e-5


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _close_grad(got, want, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=GRAD_RTOL,
        atol=GRAD_ATOL_SCALE * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _mega_inputs(dim_head, n=24, dim=128, heads=2, seed=0):
    """x, gains, weights and a (3, n) key mask: element 0 right-padded,
    element 1 with its first key masked (a dead first row under causal),
    element 2 all masked (every row dead)."""
    npr = np.random.RandomState(seed + dim_head)
    hd = heads * dim_head
    mask = np.ones((3, n), dtype=bool)
    mask[0, n - 7:] = False
    mask[1, 0] = False
    mask[2] = False
    return (npr.randn(3, n, dim).astype(np.float32),
            (1 + 0.1 * npr.randn(dim)).astype(np.float32),
            (npr.randn(dim, 3 * hd) / np.sqrt(dim)).astype(np.float32),
            (npr.randn(hd, dim) / np.sqrt(hd)).astype(np.float32),
            (1 + 0.1 * npr.randn(dim)).astype(np.float32), mask)


# (JAX store_qkv, the port's training wrapper and its keyword arguments)
MEGA_VARIANTS = {
    "K2": (True, mega.attention_block_train, {}),
    "K2 qkv": ("qkv", mega.attention_block_train_recompute,
               dict(keep_qkv=True)),
    "K3": (False, mega.attention_block_train_recompute, {}),
}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("variant", list(MEGA_VARIANTS))
@pytest.mark.parametrize("dim_head", [80, 128])
def test_megablock_at_wide_heads_matches_pallas(dim_head, variant, causal):
    """K2, K2's qkv mode and K3 at heads of 80 (padded to 128) and 128:
    the output and the gradients of all five tensors against
    `jmega.attention_block` in interpret mode (outputs 1e-5, gradients
    rtol 1e-3, atol 1e-5 of the largest magnitude); K-MEGA's forward
    under no_grad against JAX's inference forward (1e-5)."""
    heads = 2
    args = _mega_inputs(dim_head, heads=heads)
    scale = dim_head ** -0.5
    store_qkv, train, kw = MEGA_VARIANTS[variant]
    cot = np.random.RandomState(1).randn(*args[0].shape).astype(np.float32)
    ja = [jnp.asarray(a) for a in args]

    def f(*a):
        out = jmega.attention_block(*a, ja[5], heads, dim_head, scale, causal,
                                    True, True, store_qkv)
        return jnp.sum(out * cot), out

    (_, want), want_grads = jax.value_and_grad(f, argnums=range(5),
                                               has_aux=True)(*ja[:5])
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
        _close(lean, jmega.attention_block(*ja, heads, dim_head, scale,
                                           causal, True, True),
               OUT_ATOL)


def test_k6_at_head_width_128_matches_pallas():
    """K6 on heads of 128, causal, with key pads, masked tiles and a dead
    element: the output (1e-5) and the gradient of a sum of squares (rtol
    1e-3) against `jcore.attention_core` in interpret mode."""
    qkv, mask, _ = core_args(n=33, mask_kind="dead", dim_head=128)
    scale = 128 ** -0.5

    def f(x):
        return jcore.attention_core(x, jnp.asarray(mask), 2, 128, scale,
                                    True, True, True)

    want = f(jnp.asarray(qkv))
    want_grad = jax.grad(lambda x: jnp.sum(f(x) ** 2))(jnp.asarray(qkv))
    tq = torch.from_numpy(qkv).requires_grad_(True)
    got = core.attention_core(tq, torch.from_numpy(mask), 2, 128, scale,
                              True, True)
    (got ** 2).sum().backward()
    _close(got, want, OUT_ATOL)
    _close_grad(tq.grad, want_grad)


def test_k6_route_with_rotary_at_head_width_128_matches_jax():
    """`Attention` with rotary and causal on the 'fused' route (PreNorm,
    qkv, rotary, K6 at heads of 128, out product) against
    `attention_apply`: the output (1e-5) and the input's gradient (rtol
    1e-3)."""
    tree = numpy_params(dict(dim_text=128, text_heads=2, text_dim_head=128,
                             text_enc_depth=1, text_seq_len=16,
                             num_text_tokens=50), seed=3)
    p = jax.tree.map(lambda a: a[0],
                     tree["text"]["transformer"]["layers"])["attn"]
    npr = np.random.RandomState(4)
    x = npr.randn(2, 17, 128).astype(np.float32)
    mask = np.ones((2, 17), dtype=bool)
    mask[0, 11:] = False
    mask[1, :2] = False
    rotary = jlayers.rotary_freqs(17, 32)

    def f(xx):
        return jlayers.attention_apply(
            jax.tree.map(jnp.asarray, p), xx, heads=2, dim_head=128,
            causal=True, mask=jnp.asarray(mask), rotary=rotary,
            attn_impl="fused")

    want = f(jnp.asarray(x))
    want_dx = jax.grad(lambda xx: jnp.sum(f(xx) ** 2))(jnp.asarray(x))
    attn = tlayers.Attention(128, dim_head=128, heads=2)
    load_jax_params(attn, p)
    tx = torch.from_numpy(x).requires_grad_(True)
    before = core.attention_core_fwd.launches
    got = attn(tx, torch.from_numpy(mask), True, tlayers.rotary_freqs(17, 32),
               "fused")
    assert core.attention_core_fwd.launches == before   # the plain version
    (got ** 2).sum().backward()
    _close(got, want, OUT_ATOL)
    _close_grad(tx.grad, want_dx)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_f32_at_head_width_128_matches_pallas(causal):
    """fp32 K7 on heads of 128 (`flash_attention`, n padded to the
    kernels' tile) against `jflash.flash_attention` in interpret mode: the
    output (1e-5) and the gradients of q, k and v (rtol 1e-3)."""
    q, k, v, mask, _ = flash_args(n=37, mask_kind="holes", d=128)

    def f(a, b, c):
        return jflash.flash_attention(a, b, c, mask=jnp.asarray(mask),
                                      causal=causal, interpret=True)

    ja = [jnp.asarray(t) for t in (q, k, v)]
    want = f(*ja)
    want_grads = jax.grad(lambda *a: jnp.sum(f(*a) ** 2),
                          argnums=(0, 1, 2))(*ja)
    tt = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    got = flash.flash_attention(*tt, torch.from_numpy(mask), causal)
    (got ** 2).sum().backward()
    _close(got, want, OUT_ATOL)
    for name, t, w in zip("qkv", tt, want_grads):
        _close_grad(t.grad, w, name)


def test_clip_with_wide_heads_matches_jax():
    """A tiny CLIP with vision heads of 80 (zero-padded to 128) and text
    heads of 128 on the megablock routes ('fused' in both towers,
    'block_stored'), its weights carried over by `convert`: the loss
    (1e-5) and every gradient (rtol 1e-3, atol 1e-5 of the leaf's largest
    magnitude) against the JAX package's."""
    jclip, params, tclip = _pair(text_dim_head=128, visual_dim_head=80,
                                 visual_attn_impl="fused")
    text, image = _inputs()
    rng = jax.random.PRNGKey(7)

    def loss_fn(p):
        return jclip.model.apply(p, jnp.asarray(text), jnp.asarray(image),
                                 return_loss=True, rng=rng, training=True)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    loss = tclip(torch.from_numpy(text), torch.from_numpy(image),
                 return_loss=True, keep_idx=jax_keep_idx(rng, 4, 9, 0.5))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=LOSS_ATOL)
    _tree_close(to_jax_tree(tclip, grads=True), want_grads, rtol=GRAD_RTOL,
                atol_scale=GRAD_ATOL_SCALE)


def test_pad_heads_to_128_matches_the_plain_versions_at_80():
    """`pad_heads` takes a head of 80 to 128 and `unpad_heads` back; the
    megablock's, K6's and K7's wrappers on the padded heads match the plain
    versions at the true width of 80, output and gradients (fp32, 1e-5 of
    the largest magnitude: summation order only)."""
    heads, b, n, dim, d = 2, 2, 19, 128, 80
    gen = torch.Generator().manual_seed(80)
    hd = heads * d
    mask = torch.ones(b, n, dtype=torch.bool)
    mask[1, 13:] = False
    qkv = torch.randn(b, n, 3 * hd, generator=gen).requires_grad_(True)
    padded = mega.pad_heads(qkv, d)
    assert padded.shape == (b, n, 3 * heads * 128)
    assert not padded.reshape(b, n, 3 * heads, 128)[..., d:].any()
    assert torch.equal(mega.unpad_heads(padded, d), qkv)
    scale = d ** -0.5

    def close(f, g, inputs):
        a, b_ = f(), g()
        torch.testing.assert_close(a, b_, rtol=0,
                                   atol=1e-5 * float(b_.detach().abs().max()))
        cot = torch.randn(a.shape, generator=gen)
        for x, y in zip(torch.autograd.grad(a, inputs, cot),
                        torch.autograd.grad(b_, inputs, cot)):
            torch.testing.assert_close(x, y, rtol=0,
                                       atol=1e-5 * float(y.abs().max()))

    close(lambda: core.attention_core(qkv, mask, heads, d, scale, causal=True),
          lambda: core.attention_core_fwd_plain(qkv, mask, heads, d, scale,
                                                True)[0], [qkv])
    q, k, v = (torch.randn(b, heads, n, d, generator=gen).requires_grad_(True)
               for _ in range(3))
    close(lambda: flash.flash_attention(q, k, v, mask),
          lambda: flash.flash_attention_fwd_plain(
              *flash.pad_flat((q, k, v), mask)[0],
              flash.pad_flat((q,), mask)[1])[0].reshape(b, heads, -1, d)[
                  :, :, :n], [q, k, v])
    x = torch.randn(b, n, dim, generator=gen).requires_grad_(True)
    w_qkv = (torch.randn(dim, 3 * hd, generator=gen) * dim ** -0.5
             ).requires_grad_(True)
    w_out = (torch.randn(hd, dim, generator=gen) * hd ** -0.5
             ).requires_grad_(True)
    g = torch.ones(dim)
    for train in (mega.attention_block_train,
                  mega.attention_block_train_recompute):
        close(lambda: train(x, g, w_qkv, w_out, g, mask, heads, d, scale),
              lambda: mega.attention_block_plain(x, g, w_qkv, w_out, g, mask,
                                                 heads, d, scale),
              [x, w_qkv, w_out])
