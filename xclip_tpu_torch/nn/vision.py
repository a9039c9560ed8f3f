"""Vision tower — the counterpart of `xclip_tpu/nn/vision.py`: patchify with
per-patch feature order (p1, p2, c), a linear patch projection with bias,
learned position embedding, the transformer stack, and a DERIVED CLS
(mean-pool over the output tokens → `to_cls`) prepended. Returns
(b, kept + 1, dim). Input layout is NCHW.

FLIP patch dropout acts only in training: the kept patches are gathered
BEFORE the projection, their position embeddings with them (the JAX
tower's order, `nn/vision.py:92-106`; numerically the reference's
drop-after-pos-emb). At inference every patch is kept."""

from __future__ import annotations

import torch
from torch import nn

from .core import Embedding, Linear, cast
from .layers import Transformer, patch_dropout


class VisionTransformer(nn.Module):
    def __init__(self, dim: int, image_size: int, patch_size: int,
                 channels: int = 3, patch_dropout: float = 0.5,
                 depth: int = 6, heads: int = 8, dim_head: int = 64,
                 ff_mult: int = 4, ff_impl: str = "xla", *,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 checkpoint_during_training: bool = False,
                 remat_policy: str | None = None, generator=None,
                 dtype=torch.float32):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("Image dimensions must be divisible by the "
                             "patch size.")
        self.dim, self.patch_size, self.ff_impl = dim, patch_size, ff_impl
        self.patch_dropout = patch_dropout
        self.num_patches = (image_size // patch_size) ** 2
        self.train_flags = dict(
            attn_dropout=attn_dropout, ff_dropout=ff_dropout,
            checkpoint_during_training=checkpoint_during_training,
            remat_policy=remat_policy)
        num_patches = self.num_patches
        self.patch_proj = Linear(channels * patch_size ** 2, dim, bias=True,
                                 generator=generator, dtype=dtype)
        self.pos_emb = Embedding(num_patches, dim, generator=generator,
                                 dtype=dtype)
        self.transformer = Transformer(dim, depth=depth, dim_head=dim_head,
                                       heads=heads, ff_mult=ff_mult,
                                       generator=generator, dtype=dtype)
        self.to_cls = Linear(dim, dim, generator=generator, dtype=dtype)

    def patchify(self, x):
        """(b, c, H, W) → (b, h·w, p·p·c), feature order (p1, p2, c)."""
        b, c, H, W = x.shape
        p = self.patch_size
        x = x.reshape(b, c, H // p, p, W // p, p).permute(0, 2, 4, 3, 5, 1)
        return x.reshape(b, (H // p) * (W // p), p * p * c)

    def forward(self, x, *, attn_impl: str = "xla", training: bool = False,
                generator=None, keep_idx=None, dropout_keep=None,
                return_hidden=None):
        """In training with patch dropout, `keep_idx` ((b, kept) patch
        indices) injects the kept patches; otherwise they are drawn from
        `generator` (see `layers.patch_dropout`), which then feeds the
        stack's dropout, or `dropout_keep` its masks
        (`Transformer.forward`). With `return_hidden` (a layer index),
        returns (out, the residual stream after that layer), as the JAX
        tower does for the visual SSL's hidden-layer tap."""
        patches = self.patchify(x)
        n = patches.shape[1]
        if training and self.patch_dropout > 0.0:
            patches, keep_idx = patch_dropout(
                patches, self.patch_dropout, generator=generator,
                keep_idx=keep_idx)
            pos = self.pos_emb(keep_idx)
        else:
            pos = self.pos_emb.emb[:n][None]
        tokens = self.patch_proj(patches)
        tokens = tokens + cast(pos, tokens.dtype)
        out = self.transformer(tokens, attn_impl=attn_impl,
                               ff_impl=self.ff_impl, training=training,
                               return_hidden=return_hidden,
                               **(dict(self.train_flags, generator=generator,
                                       dropout_keep=dropout_keep)
                                  if training else {}))
        if return_hidden is not None:
            out, hidden = out
        cls = self.to_cls(out.mean(dim=1))
        full = torch.cat([cls[:, None], out], dim=1)
        return full if return_hidden is None else (full, hidden)
