"""DeCLIP's masked language modelling over the shared text tower — the
counterpart of `xclip_tpu/objectives/mlm.py`.

  * `get_mask_subset_with_prob`: per row, the top-k (k = ceil(prob · n)) of
    uniforms over the eligible positions (ties, the ineligible ones at
    −1e9, in position order, as `lax.top_k` takes them), the j-th pick
    dropped where the cumulative count of eligible positions up to j
    exceeds ceil(eligible · prob), scattered through an (n + 1) buffer whose
    slot 0 takes the dropped picks.
  * `MLM.forward`: labels are the tokens where masked, else pad; optional
    random-token corruption; the mask token where a uniform is below
    `replace_prob`; the text tower over the corrupted sequence with the
    original padding mask; the biased `to_logits` head, position 0 (the
    CLS) dropped; cross-entropy over the labels that are not pad, divided
    by their count clipped to at least 1 (a batch with no masked token
    gives 0).

Injected draws (`forward(..., draws=)`): a dict of (b, n) tensors,
`subset` (the uniforms the subset is taken from), `replace` (the
uniforms compared with `replace_prob`) and, when `random_token_prob` > 0,
`random` (uniforms compared with it) and `random_tokens` (ids in [0,
num_tokens)). Missing draws come from the generator.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import Linear


def mask_with_tokens(t, token_ids):
    """True where t equals any of `token_ids`."""
    mask = torch.zeros_like(t, dtype=torch.bool)
    for tid in token_ids:
        mask = mask | (t == tid)
    return mask


def get_mask_subset_with_prob(mask, prob: float, uniforms):
    """(b, n) bool `mask` of eligible positions, (b, n) `uniforms` → the
    (b, n) bool mask of the picked positions (`mlm.py:39-55`)."""
    b, seq_len = mask.shape
    max_masked = math.ceil(prob * seq_len)
    num_tokens = mask.sum(dim=-1, keepdim=True)
    mask_excess = mask.cumsum(dim=-1) > torch.ceil(num_tokens * prob)
    mask_excess = mask_excess[:, :max_masked]
    rand = torch.where(mask, uniforms.float(), -1e9)
    # a stable descending sort: equal values keep their position order
    sampled = torch.sort(rand, dim=-1, descending=True,
                         stable=True).indices[:, :max_masked]
    sampled = torch.where(mask_excess, 0, sampled + 1)
    new_mask = torch.zeros((b, seq_len + 1), dtype=torch.bool,
                           device=mask.device)
    new_mask[torch.arange(b, device=mask.device)[:, None], sampled] = True
    return new_mask[:, 1:]


class MLM(nn.Module):
    """`xclip_tpu.objectives.mlm.MLM`: its fields, and the `to_logits`
    head (dim → num_tokens, with bias)."""

    def __init__(self, dim: int, num_tokens: int, mask_prob: float = 0.15,
                 replace_prob: float = 0.9, random_token_prob: float = 0.0,
                 mask_token_id: int = 2, pad_token_id: int = 0,
                 mask_ignore_token_ids: Tuple[int, ...] = (), *,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.dim, self.num_tokens = dim, num_tokens
        self.mask_prob, self.replace_prob = mask_prob, replace_prob
        self.random_token_prob = random_token_prob
        self.mask_token_id, self.pad_token_id = mask_token_id, pad_token_id
        self.mask_ignore_token_ids = tuple(mask_ignore_token_ids)
        self.to_logits = Linear(dim, num_tokens, bias=True,
                                generator=generator, dtype=dtype)

    @property
    def ignore_ids(self):
        return tuple({*self.mask_ignore_token_ids, self.pad_token_id})

    def draws(self, seq, generator=None):
        """The draws of one forward over `seq`, from `generator`."""
        dev = generator.device if generator is not None else seq.device
        kw = dict(generator=generator, device=dev)
        d = {"subset": torch.rand(seq.shape, **kw)}
        if self.random_token_prob > 0:
            d["random"] = torch.rand(seq.shape, **kw)
            d["random_tokens"] = torch.randint(0, self.num_tokens, seq.shape,
                                               **kw)
        d["replace"] = torch.rand(seq.shape, **kw)
        return {k: v.to(seq.device) for k, v in d.items()}

    def masked(self, seq, draws):
        """(the corrupted sequence, the labels)."""
        no_mask = mask_with_tokens(seq, self.ignore_ids)
        mlm_mask = get_mask_subset_with_prob(~no_mask, self.mask_prob,
                                             draws["subset"])
        labels = torch.where(mlm_mask, seq, self.pad_token_id)
        masked_seq = seq
        if self.random_token_prob > 0:
            random_tokens = draws["random_tokens"].to(seq.dtype)
            use_random = draws["random"] < self.random_token_prob
            use_random = use_random & ~mask_with_tokens(random_tokens,
                                                        self.ignore_ids)
            masked_seq = torch.where(use_random, random_tokens, masked_seq)
            mlm_mask = mlm_mask & ~use_random
        replace = draws["replace"] < self.replace_prob
        masked_seq = torch.where(mlm_mask & replace, self.mask_token_id,
                                 masked_seq)
        return masked_seq, labels

    def forward(self, text_encoder, seq, *, mask=None, training=True,
                attn_impl="xla", dtype=None, generator=None, draws=None):
        """The MLM loss of `seq` (b, n) through `text_encoder`, in the
        tower's output dtype."""
        if draws is None:
            draws = self.draws(seq, generator)
        masked_seq, labels = self.masked(seq, draws)
        embedding = text_encoder(masked_seq, mask, attn_impl=attn_impl,
                                 dtype=dtype, training=training,
                                 generator=generator)
        logits = self.to_logits(embedding)[:, 1:]   # the CLS dropped
        keep = labels != self.pad_token_id
        total = F.cross_entropy(logits.float().flatten(0, 1),
                                labels.flatten().long(), reduction="sum",
                                ignore_index=self.pad_token_id)
        count = keep.sum().clamp(min=1)
        return (total / count).to(embedding.dtype)
