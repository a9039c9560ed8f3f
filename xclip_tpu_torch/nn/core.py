"""Parameter containers and the gain-only LayerNorm — the counterparts of
`xclip_tpu/nn/core.py`.

Layout: every linear weight is stored as JAX stores it, `(in_features,
out_features)`, and applied as `x @ w` — the transpose of `torch.nn.Linear`.
The kernels take that layout without a transpose, and `convert.py` carries
JAX weights across leaf for leaf. Parameter names follow the JAX param tree
(`w`, `b`, `emb`, `g`).

Initialisation draws from an explicit `torch.Generator` with the JAX
package's distributions: linear weight and bias U(-1/sqrt(in), 1/sqrt(in)),
embeddings N(0, 1), LayerNorm gains 1. The numbers differ from JAX's.

Mixed precision: a module applies its parameters cast to the dtype of the
activation it is given (`w.to(x.dtype)`), which is what the JAX model's
cast of every float parameter to `compute_dtype` at entry amounts to.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _uniform(shape, bound, generator, dtype):
    w = torch.empty(shape, dtype=torch.float32)
    w.uniform_(-bound, bound, generator=generator)
    return w.to(dtype)


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 generator=None, dtype=torch.float32):
        super().__init__()
        bound = 1.0 / math.sqrt(d_in)
        self.w = nn.Parameter(_uniform((d_in, d_out), bound, generator, dtype))
        self.b = (nn.Parameter(_uniform((d_out,), bound, generator, dtype))
                  if bias else None)

    def forward(self, x):
        y = x @ self.w.to(x.dtype)
        return y + self.b.to(x.dtype) if self.b is not None else y


class Embedding(nn.Module):
    def __init__(self, num: int, dim: int, *, generator=None,
                 dtype=torch.float32):
        super().__init__()
        emb = torch.empty(num, dim, dtype=torch.float32)
        emb.normal_(generator=generator)
        self.emb = nn.Parameter(emb.to(dtype))

    def forward(self, ids):
        # F.embedding, not self.emb[ids]: its backward sums rows with a
        # segmented reduction instead of index_put's sort-and-accumulate
        return F.embedding(ids, self.emb)


def layer_norm(x, g):
    """Gain-only LayerNorm with a dtype-dependent eps (1e-5 fp32, 1e-3
    otherwise) and fp32 biased statistics; the normalisation itself runs in
    x.dtype: inv and mean are cast to x.dtype before (x - mean) * inv."""
    eps = 1e-5 if x.dtype == torch.float32 else 1e-3
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    inv = (torch.rsqrt(var + eps) * g.to(x.dtype).float()).to(x.dtype)
    return (x - mean.to(x.dtype)) * inv


class LayerNorm(nn.Module):
    def __init__(self, dim: int, *, dtype=torch.float32):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.g)
