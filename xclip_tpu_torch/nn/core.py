"""Parameter containers, the gain-only LayerNorm, BatchNorm1d and dropout —
the counterparts of `xclip_tpu/nn/core.py`.

Layout: every linear weight is stored as JAX stores it, `(in_features,
out_features)`, and applied as `x @ w` — the transpose of `torch.nn.Linear`.
The kernels take that layout without a transpose, and `convert.py` carries
JAX weights across leaf for leaf. Parameter names follow the JAX param tree
(`w`, `b`, `emb`, `g`).

Initialisation draws from an explicit `torch.Generator` with the JAX
package's distributions: linear weight and bias U(-1/sqrt(in), 1/sqrt(in)),
embeddings N(0, 1), LayerNorm gains 1. The numbers differ from JAX's.

Mixed precision: a module applies its parameters cast to the dtype of the
activation it is given, through `cast(w, x.dtype)`. Under
`computing_in(dtype)` (the model's `compute_dtype`, set by `CLIPModel`)
`cast` rounds a parameter to that dtype first, as the JAX model casts
every float parameter, BatchNorm statistics included, to `compute_dtype`
on entry: an fp32 activation (the SSL views, which the augmentation
promotes) then meets the rounded weight, and the gradient is rounded on
its way back, as JAX's is. A remat recompute runs outside the forward's
context, so `Transformer` carries it into what it recomputes.

BatchNorm1d (the SSL heads' only normalisation) keeps its running `mean`
and `var` as buffers, not parameters: they carry no gradient, so the
optimizer never touches them; the train step folds their new values in
(`objectives/ssl.py`, `train/trainer.py`).

Dropout draws from explicit generators, as JAX's `RngStream` folds a site
counter into one key a layer: `RngStream(seed)` gives the i-th dropout
site of a layer its own generator, seeded from (seed, i). A stream is
built anew each time its layer runs, so a recomputing backward
(`torch.utils.checkpoint`) draws the same masks. `RngStream(masks=...)`
hands out injected keep masks instead (JAX's and torch's random bits
never agree, so tests inject the masks JAX draws).
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import axis_size, psum, pvary


_COMPUTE_DTYPE = contextvars.ContextVar("compute_dtype", default=None)


@contextlib.contextmanager
def computing_in(dtype):
    """Parameters are rounded to `dtype` (None: not at all) by `cast`
    within this context."""
    token = _COMPUTE_DTYPE.set(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE.reset(token)


def compute_dtype():
    """The dtype of the innermost `computing_in`, or None."""
    return _COMPUTE_DTYPE.get()


def cast(p, dtype):
    """Parameter or buffer `p` in `dtype`, rounded first to the compute
    dtype where one is set (`computing_in`)."""
    rounding = _COMPUTE_DTYPE.get()
    if rounding is not None and p.dtype != rounding and p.is_floating_point():
        p = p.to(rounding)
    return p.to(dtype)


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
        return linear(x, self.w, self.b)


def linear(x, w, b=None):
    """JAX's x @ w (+ b): the product in the promoted dtype of the input
    and of the weight as the model holds it (the compute dtype, if set), so
    bf16 images meet fp32 weights in fp32."""
    dtype = torch.promote_types(x.dtype, _COMPUTE_DTYPE.get() or w.dtype)
    y = x.to(dtype) @ cast(w, dtype)
    return y + cast(b, dtype) if b is not None else y


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


def layer_norm(x, g, group=None):
    """Gain-only LayerNorm with a dtype-dependent eps (1e-5 fp32, 1e-3
    otherwise) and fp32 biased statistics; the normalisation itself runs in
    x.dtype: inv and mean are cast to x.dtype before (x - mean) * inv.
    With `group` (a model group), `x` and `g` are this rank's slices of a
    width sharded over it, and the statistics are the whole row's: the
    ranks' fp32 row sums, then their sums of squares about the mean (two
    passes, as above), each summed over the group (`pvary(psum(...))`)."""
    eps = 1e-5 if x.dtype == torch.float32 else 1e-3
    xf = x.float()
    if group is None:
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
    else:
        width = x.shape[-1] * axis_size(group)

        def total(t):
            return pvary(psum(t.sum(dim=-1, keepdim=True), group), group)

        mean = total(xf) / width
        var = total((xf - mean) ** 2) / width
    inv = (torch.rsqrt(var + eps) * cast(g, x.dtype).float()).to(x.dtype)
    return (x - mean.to(x.dtype)) * inv


class LayerNorm(nn.Module):
    def __init__(self, dim: int, *, dtype=torch.float32):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.g)


class BatchNorm1d(nn.Module):
    """`batch_norm_init` / `batch_norm_apply` (`xclip_tpu/nn/core.py:
    104-128`): in training, normalised by the batch's mean and biased
    variance; outside it, by the running statistics (buffers, zeros and
    ones at init). `affine=False` leaves out `scale` and `bias`. eps 1e-5
    whatever the dtype."""

    def __init__(self, dim: int, *, affine: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.register_buffer("mean", torch.zeros(dim, dtype=dtype))
        self.register_buffer("var", torch.ones(dim, dtype=dtype))
        self.scale = self.bias = None
        if affine:
            self.scale = nn.Parameter(torch.ones(dim, dtype=dtype))
            self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype))

    def forward(self, x, training: bool, eps: float = 1e-5):
        """(rows, dim) x → (out, (mean, var)): the statistics it normalised
        by, in x.dtype (the batch's are taken in fp32, as jnp.mean /
        jnp.var take a bf16 input's)."""
        if training:
            xf = x.float()
            mean = xf.mean(dim=0).to(x.dtype)
            var = xf.var(dim=0, unbiased=False).to(x.dtype)
        else:
            mean, var = cast(self.mean, x.dtype), cast(self.var, x.dtype)
        out = (x - mean) * torch.rsqrt(var + eps)
        if self.scale is not None:
            out = out * cast(self.scale, x.dtype) + cast(self.bias, x.dtype)
        return out, (mean, var)


class RngStream:
    """One layer's dropout sites in order (`xclip_tpu/nn/core.py:22-41`):
    the i-th `keep(shape, rate, device)` is the i-th site's keep mask,
    Bernoulli(1 − rate) drawn from a generator seeded from (seed, i), or
    the i-th of the injected `masks`."""

    def __init__(self, seed: int | None = None, masks=None):
        self.seed, self.masks, self.count = seed, masks, 0

    def keep(self, shape, rate: float, device) -> torch.Tensor:
        i, self.count = self.count, self.count + 1
        if self.masks is not None:
            return self.masks[i].to(device)
        g = torch.Generator(device).manual_seed(hash((self.seed, i)) % 2 ** 63)
        return torch.rand(shape, generator=g, device=device) < 1.0 - rate


def dropout(x, rate: float, rngs: RngStream, shard=None):
    """`where(keep, x / (1 − rate), 0)` in x's dtype, keep from `rngs`
    (`xclip_tpu/nn/core.py:97-101`). `shard` (dim, index, count): `x` is
    block `index` of `count` along `dim` of the whole tensor (a rank's heads
    or inner slice), and takes that block of the whole tensor's mask."""
    if shard is None:
        keep = rngs.keep(x.shape, rate, x.device)
    else:
        dim, index, count = shard
        shape = list(x.shape)
        shape[dim] *= count
        keep = rngs.keep(tuple(shape), rate, x.device).narrow(
            dim, index * x.shape[dim], x.shape[dim])
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)
