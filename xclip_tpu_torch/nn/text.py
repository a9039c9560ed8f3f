"""Text tower — the counterpart of `xclip_tpu/nn/text.py`: token embedding,
EITHER a learned absolute position embedding OR rotary embeddings
(`rotary_freqs(n + 1, min(dim_head, 32))` with the CLS at position 0; for
the n tokens alone when causal), a learned CLS token prepended only when
not causal (the padding mask extended by a leading True), the transformer
stack (with its dropout and remat in training). Returns the full
(b, n[+1], dim) sequence."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .core import Embedding, cast
from .layers import Transformer, rotary_freqs


class TextTransformer(nn.Module):
    def __init__(self, dim: int, num_tokens: int, max_seq_len: int,
                 depth: int = 6, heads: int = 8, dim_head: int = 64,
                 rotary_pos_emb: bool = False, causal: bool = False,
                 ff_mult: int = 4, ff_impl: str = "xla", *,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 checkpoint_during_training: bool = False,
                 remat_policy: str | None = None, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.dim, self.ff_impl = dim, ff_impl
        self.dim_head, self.causal = dim_head, causal
        self.rotary_pos_emb = rotary_pos_emb
        self.train_flags = dict(
            attn_dropout=attn_dropout, ff_dropout=ff_dropout,
            checkpoint_during_training=checkpoint_during_training,
            remat_policy=remat_policy)
        self.token_emb = Embedding(num_tokens, dim, generator=generator,
                                   dtype=dtype)
        self.abs_pos_emb = None if rotary_pos_emb else Embedding(
            max_seq_len, dim, generator=generator, dtype=dtype)
        self.cls_token = None
        if not causal:
            cls = torch.empty(dim, dtype=torch.float32).normal_(
                generator=generator)
            self.cls_token = nn.Parameter(cls.to(dtype))
        self.transformer = Transformer(dim, depth=depth, dim_head=dim_head,
                                       heads=heads, ff_mult=ff_mult,
                                       generator=generator, dtype=dtype)

    def forward(self, x, mask=None, *, attn_impl: str = "xla", dtype=None,
                training: bool = False, generator=None, dropout_keep=None):
        """x: (b, n) token ids; mask: (b, n) bool or None. `dtype` is the
        compute dtype (default: the parameters'). In training, `generator`
        and `dropout_keep` feed the stack's dropout
        (`Transformer.forward`)."""
        b, n = x.shape
        dtype = dtype or self.token_emb.emb.dtype
        h = cast(self.token_emb(x), dtype)
        if self.abs_pos_emb is not None:
            h = h + cast(self.abs_pos_emb.emb[:n], dtype)[None]
        rotary = None
        if self.rotary_pos_emb:
            rotary = rotary_freqs(n + (0 if self.causal else 1),
                                  min(self.dim_head, 32), device=x.device)
        if not self.causal:
            cls = cast(self.cls_token, dtype).expand(b, 1, self.dim)
            h = torch.cat([cls, h], dim=1)
            if mask is not None:
                mask = F.pad(mask, (1, 0), value=True)
        return self.transformer(h, mask, causal=self.causal, rotary=rotary,
                                attn_impl=attn_impl, ff_impl=self.ff_impl,
                                training=training,
                                **(dict(self.train_flags,
                                        generator=generator,
                                        dropout_keep=dropout_keep)
                                   if training else {}))
