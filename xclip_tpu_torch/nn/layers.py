"""Transformer building blocks — the counterparts of `xclip_tpu/nn/layers.py`:
the plain GEGLU feed-forward and attention (the `'xla'` route), the
sandwich-norm stack with kernel routing, and FLIP patch dropout.

Routing, as `transformer_apply` does it (`nn/layers.py:311-419`):
  * inference: `attn_impl` in ('fused', 'fused_recompute', 'fused_qkv')
    → the megablock's lean forward K-MEGA
    (`kernels/attention_megablock.attention_block`), `ff_impl` in
    ('block', 'block_stored') → the FF block's lean forward K-FF
    (`kernels/fused_ff_block.ff_block`), each PreNorm to residual;
  * training: 'fused' → K2, the stored megablock forward and backward
    (`attention_block_train`); 'fused_qkv' and 'fused_recompute' → K3, the
    memory-lean megablock keeping qkv or nothing but row statistics
    (`attention_block_train_recompute`); 'block_stored' → K1, the
    stored-GEGLU FF block (`ff_block_train`); 'block' → K-FF-s with the
    recompute backward (`ff_block_train_recompute`). The JAX stack's
    scoped-VMEM gates between these variants are TPU artefacts: each flag
    takes its own route. What training does not have yet (XCLIP_FF_STORE=h,
    remat, dropout) raises `NotImplementedError` naming its ROADMAP.md
    item;
  * `'xla'` → the plain PyTorch modules below plus the residual, trained
    by autograd.
The JAX stack pads a text sequence of n >= 128 to the TPU sublane tile when
both kernels run; the port does not, since pad rows are masked keys and the
FF block is row-wise, so real rows are unchanged and pad rows, whose
cotangents are zero, add nothing to any gradient.
"""

from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention_megablock import (attention_block,
                                          attention_block_train,
                                          attention_block_train_recompute)
from ..kernels.fused_ff_block import (ff_block, ff_block_train,
                                      ff_block_train_recompute)
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


def check_training_routes(attn_impl, ff_impl, *, checkpoint=False,
                          attn_dropout=0.0, ff_dropout=0.0):
    """Raise for a training route this slice of the port does not have."""
    if checkpoint:
        raise NotImplementedError(
            "checkpoint_during_training (per-block remat) is not ported yet: "
            "ROADMAP.md Queue 1, item 2")
    if attn_dropout > 0.0 or ff_dropout > 0.0:
        raise NotImplementedError(
            "attention / FF dropout in training is not ported yet: "
            "ROADMAP.md Queue 1, items 1-2")
    if ff_impl == "block_stored" and os.environ.get("XCLIP_FF_STORE") == "h":
        raise NotImplementedError(
            "XCLIP_FF_STORE=h (the stored-h FF block) is not ported yet: "
            "ROADMAP.md Queue 2, K1 fwd and K1 bwd")


def patch_dropout(x, prob, *, generator=None, keep_idx=None):
    """FLIP patch dropout (reference x_clip.py:134-151): keep
    max(1, int(n·(1 − prob))) uniformly random, unordered patches per image
    → (x gathered (b, kept, ·), keep_idx (b, kept)). `keep_idx` injects the
    indices (the JAX package draws them with its own RNG); otherwise
    they are the top-k of uniform scores drawn from `generator`."""
    b, n = x.shape[:2]
    if keep_idx is None:
        num_keep = max(1, int(n * (1 - prob)))
        scores = torch.rand((b, n), generator=generator,
                            device=generator.device if generator is not None
                            else x.device)
        keep_idx = scores.topk(num_keep, dim=-1).indices
    keep_idx = keep_idx.to(x.device, torch.long)
    idx = keep_idx[..., None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx), keep_idx


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
                ff_impl="xla", training=False,
                checkpoint_during_training=False, attn_dropout=0.0,
                ff_dropout=0.0):
        """`training` selects the kernels' training routes (K2 or K3, K1 or
        the recompute FF block); otherwise the lean inference forwards run,
        which take no gradient."""
        check_impls(attn_impl, ff_impl)
        if training:
            check_training_routes(
                attn_impl, ff_impl, checkpoint=checkpoint_during_training,
                attn_dropout=attn_dropout, ff_dropout=ff_dropout)
        use_mega = attn_impl in MEGA_IMPLS
        use_ffb = ff_impl in FF_BLOCK_IMPLS
        mega, ffb = attention_block, ff_block
        if training:
            mega = (attention_block_train if attn_impl == "fused" else
                    functools.partial(attention_block_train_recompute,
                                      keep_qkv=attn_impl == "fused_qkv"))
            ffb = (ff_block_train if ff_impl == "block_stored"
                   else ff_block_train_recompute)
        dt = x.dtype
        x = self.norm_in(x)
        if use_mega:
            key_mask = (mask if mask is not None else
                        torch.ones(x.shape[:2], dtype=torch.bool,
                                   device=x.device))
        for layer in self.layers:
            a, f = layer.attn, layer.ff
            if use_mega:
                x = mega(
                    x, a.norm.g.to(dt), a.to_qkv.w.to(dt), a.to_out.w.to(dt),
                    a.out_norm.g.to(dt), key_mask, self.heads, self.dim_head,
                    self.dim_head ** -0.5, causal, mask is not None)
            else:
                x = a(x, mask, causal) + x
            if use_ffb:
                x = ffb(x, f.norm.g.to(dt), f.w_in.w.to(dt),
                        f.inner_norm.g.to(dt), f.w_out.w.to(dt))
            else:
                x = f(x) + x
        return self.norm_out(x)
