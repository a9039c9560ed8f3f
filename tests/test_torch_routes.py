"""The port's routing gate against the JAX package's.

JAX routes each kernel flag through its own gates and falls back to its
XLA path, with a warning, where a kernel cannot apply (`xclip_tpu/nn/
layers.py:39-46`, `:163-175`, `:314-345`, `:384-415`). The port mirrors
those gates (K6's head groups, the FF block's column blocks) and no
others, the same on every device: where JAX runs a kernel, so does the
port, and on the card its CUDA wrapper launches the kernel or raises
(each kernel module's `why_not` names the limit), never giving way to the
plain version. `nn.layers.transformer_routes` decides it from the shapes
alone, so it is held here without a card, and so are the wrappers'
predicates (the library's attention length limits stood in for).

Then what the wider shapes run, on the CPU: the bf16 kernels take a head
at its true width (any multiple of 8 up to 256), the fp32 ones heads of 64
and 128, and a head narrower than one of those runs zero-padded to it
(`attention_megablock.pad_heads`), held to the unpadded plain versions;
and the stack at head widths 32 and 128
against `transformer_apply` (forward and every gradient, fp32: outputs
1e-4, gradients rtol 1e-3 with atol 1e-5 of the leaf's largest magnitude,
as tests/test_torch_fused_ff.py).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.kernels import attention_block as jab
from xclip_tpu.kernels import attention_megablock as jmega
from xclip_tpu.kernels import fused_ff_block as jffb
from xclip_tpu.nn import layers as jlayers
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree
from xclip_tpu_torch.kernels import attention_block as k6
from xclip_tpu_torch.kernels._common import kernel_width
from xclip_tpu_torch.kernels import attention_megablock as mega
from xclip_tpu_torch.kernels import flash_attention as flash
from xclip_tpu_torch.kernels import fused_ff as k8
from xclip_tpu_torch.kernels import fused_ff_block as ffb
from xclip_tpu_torch.nn import layers as tlayers
from xclip_tpu_torch.objectives import contrastive as tcon

from test_torch_train import _tree_close
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

BF16, F32 = torch.bfloat16, torch.float32
JDT = {BF16: jnp.bfloat16, F32: jnp.float32}
MAX_WIDTH = 8192


class _Limits:
    """A stand-in for the kernel library's two length queries, with the
    limits its source states (csrc/attention_core.cuh): 2048 forward and
    backward in both dtypes (the mask words of 32 key tiles)."""

    def xclip_attention_block_max_n(self, dtype):
        return 2048

    def xclip_attention_block_bwd_max_n(self, dtype):
        return 2048


@pytest.fixture
def limits(monkeypatch):
    monkeypatch.setattr(mega._build, "library", _Limits)


def _head_limit(dtype):
    """The widest head the CUDA attention kernels take in `dtype`."""
    return 256 if dtype == BF16 else 128


def _cuda_takes_attention(dim, dim_head, n, dtype, training):
    """The CUDA attention wrappers' limits, as documented: dim_head up to
    256 in bf16 (at the true width, or the next multiple of 8 whose heads
    fill the 64-column grid) and 128 in fp32 (64 and 128, narrower heads
    zero-padded to the next of those), a block width on the 64 grid up to
    8192 (None: no block), n up to 2048 in both dtypes, with a backward
    too."""
    return (dim_head <= _head_limit(dtype) and n <= 2048 and (
        dim is None or (dim % 64 == 0 and dim <= MAX_WIDTH)))


def _kernel_dim_head(dim_head, dtype, heads=None):
    """The head width the top-level wrappers hand the kernels."""
    return kernel_width(dim_head, dtype, heads)


def _message(warn, requested, reason):
    """The text a `_warn_fallback` warns with, the cause cleared first."""
    module = jlayers if warn is jlayers._warn_fallback else tlayers
    module._warned_fallbacks.discard((requested, reason))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        warn(requested, reason)
    assert len(caught) == 1
    return str(caught[0].message)


def _same_words(fallback):
    """The port words its fallback as JAX's `_warn_fallback` does."""
    assert (_message(tlayers._warn_fallback, *fallback)
            == _message(jlayers._warn_fallback, *fallback))


def _routes(**kw):
    base = dict(attn_impl="fused", ff_impl="block", dim=512, heads=8,
                dim_head=64, inner=2048, rotary=False)
    base.update(kw)
    attn_impl, ff_impl = base.pop("attn_impl"), base.pop("ff_impl")
    return tlayers.transformer_routes(attn_impl, ff_impl, **base)


MEGA_CASES = [  # (attn_impl, dim, heads, dim_head, n, dtype, training)
    ("fused", 512, 8, 64, 257, BF16, False),
    ("fused", 512, 8, 64, 257, BF16, True),
    ("fused_recompute", 512, 8, 64, 257, BF16, True),
    ("fused_qkv", 512, 8, 64, 257, BF16, True),
    ("fused", 512, 16, 32, 257, BF16, False),
    ("fused", 512, 16, 32, 257, BF16, True),
    ("fused_recompute", 512, 4, 128, 257, BF16, True),
    ("fused", 512, 4, 128, 257, BF16, False),
    ("fused", 512, 8, 64, 2048, BF16, True),
    ("fused", 512, 8, 64, 2049, BF16, False),
    ("fused_recompute", 512, 8, 64, 2049, BF16, True),
    ("fused", 500, 8, 64, 257, BF16, False),
    ("fused", 480, 8, 64, 257, BF16, True),
    ("fused", 512, 8, 64, 640, F32, True),
    ("fused", 512, 8, 64, 641, F32, True),
    ("fused", 512, 8, 64, 1621, F32, False),
    ("fused", 512, 8, 64, 1622, F32, False),
    ("fused", 512, 8, 64, 1621, F32, True),
    ("fused", 512, 8, 64, 1622, F32, True),
    ("fused", 512, 8, 64, 2048, F32, False),
    ("fused", 512, 8, 64, 2049, F32, False),
    ("fused", 512, 8, 64, 2048, F32, True),
    ("fused_recompute", 512, 8, 64, 2049, F32, True),
    ("fused", 72, 2, 64, 257, BF16, True),
    ("fused", 1280, 16, 80, 257, BF16, False),      # ViT-H/14
    ("fused", 1280, 16, 80, 257, BF16, True),
    ("fused_recompute", 1664, 16, 104, 257, BF16, True),  # ViT-bigG/14
    ("fused", 1024, 4, 256, 257, BF16, True),
]
# towers whose weights alone pass JAX's VMEM budget (24 MB) and whose heads
# do not tile into K6's 128-lane groups: JAX runs its XLA path there; the
# port, which does not copy the VMEM gate, runs its megablock
PAST_VMEM = {(1280, 16, 80), (1664, 16, 104)}


@pytest.mark.parametrize("attn_impl,dim,heads,dim_head,n,dtype,training",
                         MEGA_CASES)
def test_megablock_route_holds_to_jax(limits, attn_impl, dim, heads,
                                      dim_head, n, dtype, training):
    """Where JAX runs a kernel for a megablock flag without rotary (its
    megablock, or K6 where the megablock's VMEM gate turns it off), the
    port runs its megablock, with no warning, whatever the shape (JAX's
    VMEM gate is a TPU artefact the port does not copy: ViT-H/14's and
    ViT-bigG/14's towers run it too); on the card its wrappers take a head
    up to 256 wide in bf16 (at its true width) and 128 in fp32 (padded to
    64 or 128), and raise past the CUDA limits instead of giving way."""
    n_pad = (n + 127) // 128 * 128
    jax_kernel = (jmega.supported(heads, dim_head, dim, n_pad, JDT[dtype])
                  or jab.supported(heads, dim_head))
    assert jax_kernel == ((dim, heads, dim_head) not in PAST_VMEM)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _routes(attn_impl=attn_impl, ff_impl="xla", dim=dim,
                       heads=heads, dim_head=dim_head) == ("mega", "xla", [])
    reason = mega.why_not(dim, heads, _kernel_dim_head(dim_head, dtype, heads),
                          n, dtype, training)
    assert (reason is None) == _cuda_takes_attention(dim, dim_head, n, dtype,
                                                     training)
    if reason:
        limit = _head_limit(dtype)
        assert ("dim_head" in reason) == (dim_head > limit)
        assert ("exceeds" in reason) == (dim_head <= limit and dim % 64 == 0)


K6_CASES = [  # (heads, dim_head, n, dtype, training)
    (8, 64, 256, BF16, True), (8, 32, 256, BF16, False),
    (4, 128, 256, BF16, True), (3, 64, 256, BF16, False),
    (2, 32, 256, BF16, False), (8, 64, 2049, BF16, False),
    (8, 64, 700, F32, True), (8, 64, 700, F32, False),
    (8, 64, 2048, F32, True), (8, 64, 2049, F32, False),
    (2, 256, 256, BF16, True)]


@pytest.mark.parametrize("heads,dim_head,n,dtype,training", K6_CASES)
@pytest.mark.parametrize("attn_impl", ["fused", "fused_recompute"])
def test_k6_route_holds_to_jax(limits, attn_impl, heads, dim_head, n, dtype,
                               training):
    """With rotary, a 'fused*' flag means K6 (`attention_apply`): JAX's
    head-group gate, with its own warning, and no other; on the card the
    core's wrapper raises past the CUDA limits."""
    attn, _, fallbacks = _routes(attn_impl=attn_impl, dim=heads * dim_head,
                                 heads=heads, dim_head=dim_head, rotary=True)
    jax_ok = jab.supported(heads, dim_head)
    assert attn == ("fused" if jax_ok else "xla")
    if not jax_ok:
        assert fallbacks == [("attn_impl='fused'",
                              f"heads={heads}, dim_head={dim_head} does "
                              "not tile into 128-lane head groups")]
    else:
        assert fallbacks == []
    for fallback in fallbacks:
        _same_words(fallback)
    reason = mega.why_not(None, heads, _kernel_dim_head(dim_head, dtype), n,
                          dtype, training)
    assert (reason is None) == _cuda_takes_attention(None, dim_head, n, dtype,
                                                     training)


@pytest.mark.parametrize("dim_head", [32, 64, 96, 128, 160])
@pytest.mark.parametrize("n", [64, 257, 8192])
def test_flash_route_holds_to_jax(dim_head, n):
    """JAX's K7 takes any head width and pads any length, and the port
    routes 'flash' to K7 at every shape; its wrapper on the card takes
    heads at any length, in bf16 at their true width up to 256, in fp32 up
    to 128 (narrower heads zero-padded to 64 or 128)."""
    for rotary in (False, True):
        attn, _, fallbacks = _routes(attn_impl="flash", dim_head=dim_head,
                                     rotary=rotary)
        assert (attn, fallbacks) == ("flash", [])
    for dt in (BF16, F32):
        width = kernel_width(dim_head, dt)
        assert width == (dim_head if dt == BF16 else
                         64 if dim_head <= 64 else
                         128 if dim_head <= 128 else dim_head)
        reason = flash.why_not(width, dt)
        assert (reason is None) == (dim_head <= _head_limit(dt))
        if reason:
            assert "dim_head 64" in reason and f"not {dim_head}" in reason


FF_CASES = [  # (dim, inner)
    (512, 2048), (512, 2000), (512, 8192), (512, 8256), (500, 2048),
    (72, 288), (128, 7), (128, 521 * 2), (64, 8192 + 64)]


@pytest.mark.parametrize("dim,inner", FF_CASES)
@pytest.mark.parametrize("ff_impl", ["block", "block_stored", "fused"])
def test_ff_route_holds_to_jax(ff_impl, dim, inner):
    """The FF block: JAX's column-block gate (`fused_ff_block.supported`),
    with its warning, and no other. K8 ('fused'): JAX always runs it, and
    so does the port. On the card the FF block's wrappers take dim and
    inner on the 64 grid up to 8192, K8's inner up to 8192, and raise
    past that."""
    jax_ok = ff_impl == "fused" or jffb.supported(dim, inner)
    _, ff, fallbacks = _routes(attn_impl="xla", ff_impl=ff_impl, dim=dim,
                               inner=inner)
    kernel = "fused" if ff_impl == "fused" else "block"
    assert ff == (kernel if jax_ok else "xla")
    if not jax_ok:
        assert fallbacks == [(f"ff_impl={ff_impl!r}",
                              f"inner width {inner} has no usable "
                              "column block divisor for the dW pass")]
    else:
        assert fallbacks == []
    for fallback in fallbacks:
        _same_words(fallback)
    if ff_impl == "fused":
        takes = inner <= MAX_WIDTH
        assert (k8.why_not(inner, BF16) is None) == takes
    else:
        takes = (dim % 64 == 0 and inner % 64 == 0
                 and max(dim, inner) <= MAX_WIDTH)
        assert (ffb.why_not(dim, inner, BF16) is None) == takes


@pytest.mark.parametrize("d", [512, 1024, 1025, 1100])
def test_loss_route(d):
    """K5: JAX runs it at any latent width, and so does the port (its
    kernels walk d in slices): 'fused' gives the dense loss's value and
    gradients at widths past 1024 too, with no warning."""
    gen = torch.Generator().manual_seed(d)
    lat = [torch.nn.functional.normalize(torch.randn(
        9, d, generator=gen, dtype=torch.float64), dim=-1).float()
        .requires_grad_(True) for _ in range(2)]
    temp = torch.tensor(3.0)
    got = []
    for loss_impl in ("fused", "xla"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            (loss,), _ = tcon.clip_contrastive_loss(
                *(t[None] for t in lat), temp,
                decoupled_contrastive_learning=True, loss_impl=loss_impl)
        got.append((loss.detach(), *torch.autograd.grad(loss, lat)))
    for a, b in zip(*got):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_fallback_warns_once_per_cause():
    """One warning per (requested, reason), as JAX's."""
    cause = ("attn_impl='flash'", "a cause of this test's own")
    tlayers._warned_fallbacks.discard(cause)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            tlayers._warn_fallback(*cause)
    assert len(caught) == 1


# ------------------------- narrower heads, zero-padded to 64 (or 128)

@pytest.mark.parametrize("dim_head", [16, 32, 48])
def test_padded_heads_match_the_unpadded_plain_versions(dim_head):
    """K6's, K7's and the megablock's wrappers run a head narrower than 64
    zero-padded to 64: outputs and gradients match the plain versions at
    the true width (fp32, 1e-5 of the largest magnitude: summation order
    only)."""
    heads, b, n, dim = 4, 2, 19, 128
    gen = torch.Generator().manual_seed(dim_head)
    hd = heads * dim_head
    mask = torch.ones(b, n, dtype=torch.bool)
    mask[1, 13:] = False
    qkv = torch.randn(b, n, 3 * hd, generator=gen).requires_grad_(True)
    assert torch.equal(mega.unpad_heads(mega.pad_heads(qkv, dim_head),
                                        dim_head), qkv)
    scale = dim_head ** -0.5

    def close(f, g, inputs):
        a, b_ = f(), g()
        torch.testing.assert_close(a, b_, rtol=0,
                                   atol=1e-5 * float(b_.detach().abs().max()))
        cot = torch.randn(a.shape, generator=gen)
        for x, y in zip(torch.autograd.grad(a, inputs, cot),
                        torch.autograd.grad(b_, inputs, cot)):
            torch.testing.assert_close(x, y, rtol=0,
                                       atol=1e-5 * float(y.abs().max()))

    close(lambda: k6.attention_core(qkv, mask, heads, dim_head, scale,
                                    causal=True),
          lambda: k6.attention_core_fwd_plain(qkv, mask, heads, dim_head,
                                              scale, True)[0], [qkv])
    q, k, v = (torch.randn(b, heads, n, dim_head, generator=gen)
               .requires_grad_(True) for _ in range(3))
    def sdpa():
        s = q @ k.transpose(-1, -2)
        valid = mask[:, None, None, :] & torch.ones(n, n, dtype=torch.bool
                                                   ).tril()
        return s.masked_fill(~valid, float("-inf")).softmax(-1) @ v

    close(lambda: flash.flash_attention(q, k, v, mask, causal=True), sdpa,
          [q, k, v])
    x = torch.randn(b, n, dim, generator=gen).requires_grad_(True)
    w_qkv = (torch.randn(dim, 3 * hd, generator=gen) * dim ** -0.5
             ).requires_grad_(True)
    w_out = (torch.randn(hd, dim, generator=gen) * hd ** -0.5
             ).requires_grad_(True)
    g = torch.ones(dim)
    for train in (mega.attention_block_train,
                  mega.attention_block_train_recompute):
        close(lambda: train(x, g, w_qkv, w_out, g, mask, heads, dim_head,
                            scale),
              lambda: mega.attention_block_plain(x, g, w_qkv, w_out, g, mask,
                                                 heads, dim_head, scale),
              [x, w_qkv, w_out])
    with torch.no_grad():
        torch.testing.assert_close(
            mega.attention_block(x, g, w_qkv, w_out, g, mask, heads,
                                 dim_head, scale),
            mega.attention_block_plain(x, g, w_qkv, w_out, g, mask, heads,
                                       dim_head, scale), rtol=0, atol=1e-5)


# ---------------------------------------------- the plain routes, on the CPU

@pytest.mark.parametrize("dim_head", [32, 128])
@pytest.mark.parametrize("attn_impl,ff_impl", [
    ("fused", "block_stored"), ("fused_recompute", "block"),
    ("xla", "xla")])
def test_stack_at_other_head_widths_matches_jax(dim_head, attn_impl,
                                                ff_impl):
    """Forward and every gradient of a two-layer stack at dim_head 32 (its
    heads zero-padded to 64 on the kernel routes) and 128 against
    `transformer_apply`, fp32."""
    heads, dim = 4, 128
    tree = numpy_params(dict(dim_text=dim, text_heads=heads,
                             text_dim_head=dim_head, text_enc_depth=2,
                             text_seq_len=16, num_text_tokens=50),
                        seed=11)["text"]["transformer"]
    npr = np.random.RandomState(12)
    x = npr.randn(2, 17, dim).astype(np.float32)
    mask = np.ones((2, 17), dtype=bool)
    mask[0, 11:] = False
    cot = npr.randn(2, 17, dim).astype(np.float32)

    def f(p, xx):
        return jlayers.transformer_apply(
            p, xx, heads=heads, dim_head=dim_head, mask=jnp.asarray(mask),
            attn_impl=attn_impl, ff_impl=ff_impl, training=True)

    want, vjp = jax.vjp(f, jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(cot))
    stack = tlayers.Transformer(dim, depth=2, dim_head=dim_head, heads=heads)
    load_jax_params(stack, tree)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = stack(tx, torch.from_numpy(mask), attn_impl=attn_impl,
                ff_impl=ff_impl, training=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    out.backward(torch.from_numpy(cot))
    want_x = np.asarray(want_x)
    np.testing.assert_allclose(tx.grad.numpy(), want_x, rtol=1e-3,
                               atol=1e-5 * max(1.0, np.abs(want_x).max()))
    _tree_close(to_jax_tree(stack, grads=True), want_p, rtol=1e-3,
                atol_scale=1e-5)
