"""Transformer building blocks — the counterparts of `xclip_tpu/nn/layers.py`
for the inference slice: the plain GEGLU feed-forward and attention (the
`'xla'` route) and the sandwich-norm stack with kernel routing.

Routing, as the JAX stack does it at inference:
  * `attn_impl` in ('fused', 'fused_recompute', 'fused_qkv') without rotary
    → the attention megablock kernel (`kernels/attention_megablock.py`),
    which also does the PreNorm, the output LayerNorm and the residual;
  * `ff_impl` in ('block', 'block_stored') → the FF block kernel
    (`kernels/fused_ff_block.py`), PreNorm to residual;
  * `'xla'` → the plain PyTorch modules below plus the residual.
The JAX stack pads a text sequence of n >= 128 to the TPU sublane tile when
both kernels run; the port does not, since pad rows are masked keys and the
FF block is row-wise, so real rows are unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention_megablock import attention_block
from ..kernels.fused_ff_block import ff_block
from .core import LayerNorm, Linear, layer_norm

ATTN_IMPLS = ("xla", "fused", "fused_recompute", "fused_qkv")
MEGA_IMPLS = ATTN_IMPLS[1:]
FF_IMPLS = ("xla", "block", "block_stored")
FF_BLOCK_IMPLS = FF_IMPLS[1:]


def check_impls(attn_impl, ff_impl):
    """Raise for a route this slice of the port does not have."""
    if attn_impl == "flash":
        raise NotImplementedError(
            "attn_impl='flash' (k-blocked FlashAttention, Pallas "
            "flash_attention.py) is not ported yet: ROADMAP.md Queue 2, K7")
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    if ff_impl == "fused":
        raise NotImplementedError(
            "ff_impl='fused' (GEGLU + inner LayerNorm kernel, Pallas "
            "fused_ff.py) is not ported yet: ROADMAP.md Queue 2, K8")
    if ff_impl not in FF_IMPLS:
        raise ValueError(f"unknown ff_impl {ff_impl!r}")


class FeedForward(nn.Module):
    """PreNorm → w_in → GEGLU (exact GELU) → inner LayerNorm → w_out."""

    def __init__(self, dim: int, mult: int = 4, *, generator=None,
                 dtype=torch.float32):
        super().__init__()
        inner = dim * mult
        self.norm = LayerNorm(dim, dtype=dtype)
        self.w_in = Linear(dim, inner * 2, generator=generator, dtype=dtype)
        self.inner_norm = LayerNorm(inner, dtype=dtype)
        self.w_out = Linear(inner, dim, generator=generator, dtype=dtype)

    def forward(self, x):
        x = self.norm(x)
        w = self.w_in.w.to(x.dtype)
        inner = w.shape[-1] // 2
        v, gate = x @ w[:, :inner], x @ w[:, inner:]
        x = layer_norm(v * F.gelu(gate), self.inner_norm.g)
        return self.w_out(x)


class Attention(nn.Module):
    """PreNorm → fused qkv → per-head softmax attention (q pre-scaled, masks
    filled with -finfo.max, fp32 softmax) → output projection → LayerNorm."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, *,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = dim_head * heads
        self.norm = LayerNorm(dim, dtype=dtype)
        self.to_qkv = Linear(dim, inner * 3, generator=generator, dtype=dtype)
        self.to_out = Linear(inner, dim, generator=generator, dtype=dtype)
        self.out_norm = LayerNorm(dim, dtype=dtype)

    def forward(self, x, mask=None, causal=False):
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        qkv = self.to_qkv(self.norm(x))
        q, k, v = (t.reshape(b, n, h, d).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        sim = (q * d ** -0.5) @ k.transpose(-1, -2)
        big_neg = -torch.finfo(sim.dtype).max
        if mask is not None:
            sim = torch.where(mask[:, None, None, :], sim, big_neg)
        if causal:
            future = torch.ones(n, n, dtype=torch.bool,
                                device=x.device).triu(1)
            sim = torch.where(future, big_neg, sim)
        if sim.dtype == torch.float32:
            attn = sim.softmax(dim=-1)
        else:  # fp32 statistics, storage-dtype weights
            shifted = (sim - sim.amax(dim=-1, keepdim=True)).float()
            denom = shifted.exp().sum(dim=-1, keepdim=True).log()
            attn = (shifted - denom).exp().to(sim.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, n, h * d)
        return self.out_norm(self.to_out(out))


class Layer(nn.Module):
    def __init__(self, dim, *, dim_head, heads, ff_mult, generator, dtype):
        super().__init__()
        self.attn = Attention(dim, dim_head=dim_head, heads=heads,
                              generator=generator, dtype=dtype)
        self.ff = FeedForward(dim, mult=ff_mult, generator=generator,
                              dtype=dtype)


class Transformer(nn.Module):
    """Sandwich-norm stack: norm_in → depth × (attention + residual, FF +
    residual) → norm_out, layers in an `nn.ModuleList`."""

    def __init__(self, dim: int, *, depth: int, dim_head: int = 64,
                 heads: int = 8, ff_mult: int = 4, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.layers = nn.ModuleList(
            Layer(dim, dim_head=dim_head, heads=heads, ff_mult=ff_mult,
                  generator=generator, dtype=dtype) for _ in range(depth))
        self.norm_in = LayerNorm(dim, dtype=dtype)
        self.norm_out = LayerNorm(dim, dtype=dtype)

    def forward(self, x, mask=None, *, causal=False, attn_impl="xla",
                ff_impl="xla"):
        check_impls(attn_impl, ff_impl)
        use_mega = attn_impl in MEGA_IMPLS
        use_ffb = ff_impl in FF_BLOCK_IMPLS
        dt = x.dtype
        x = self.norm_in(x)
        if use_mega:
            key_mask = (mask if mask is not None else
                        torch.ones(x.shape[:2], dtype=torch.bool,
                                   device=x.device))
        for layer in self.layers:
            a, f = layer.attn, layer.ff
            if use_mega:
                x = attention_block(
                    x, a.norm.g.to(dt), a.to_qkv.w.to(dt), a.to_out.w.to(dt),
                    a.out_norm.g.to(dt), key_mask, self.heads, self.dim_head,
                    self.dim_head ** -0.5, causal, mask is not None)
            else:
                x = a(x, mask, causal) + x
            if use_ffb:
                x = ff_block(x, f.norm.g.to(dt), f.w_in.w.to(dt),
                             f.inner_norm.g.to(dt), f.w_out.w.to(dt))
            else:
                x = f(x) + x
        return self.norm_out(x)
