"""Vision tower — the counterpart of `xclip_tpu/nn/vision.py` for the
inference slice: patchify with per-patch feature order (p1, p2, c), a linear
patch projection with bias, learned position embedding, the transformer
stack, and a DERIVED CLS (mean-pool over the output tokens → `to_cls`)
prepended. Returns (b, num_patches + 1, dim). Input layout is NCHW.

FLIP patch dropout acts only in training, which this slice does not have:
at inference every patch is kept, as in the JAX tower."""

from __future__ import annotations

import torch
from torch import nn

from .core import Embedding, Linear
from .layers import Transformer


class VisionTransformer(nn.Module):
    def __init__(self, dim: int, image_size: int, patch_size: int,
                 channels: int = 3, patch_dropout: float = 0.5,
                 depth: int = 6, heads: int = 8, dim_head: int = 64,
                 ff_mult: int = 4, ff_impl: str = "xla", *, generator=None,
                 dtype=torch.float32):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("Image dimensions must be divisible by the "
                             "patch size.")
        self.patch_size, self.ff_impl = patch_size, ff_impl
        num_patches = (image_size // patch_size) ** 2
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

    def forward(self, x, *, attn_impl: str = "xla"):
        patches = self.patchify(x)
        n = patches.shape[1]
        tokens = self.patch_proj(patches)
        tokens = tokens + self.pos_emb.emb[:n].to(tokens.dtype)[None]
        out = self.transformer(tokens, attn_impl=attn_impl,
                               ff_impl=self.ff_impl)
        cls = self.to_cls(out.mean(dim=1))
        return torch.cat([cls[:, None], out], dim=1)
