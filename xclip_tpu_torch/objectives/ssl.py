"""Visual self-supervision, SimSiam and SimCLR, over the shared vision tower
— the counterpart of `xclip_tpu/objectives/ssl.py`.

  * `MLP` (linear with bias, BatchNorm, ReLU, linear with bias) and
    `SimSiamMLP` (three bias-free linears, each followed by BatchNorm, the
    last without affine parameters; ReLU between).
  * The hidden-layer tap (`get_representation`): −1 is the tower's output
    projected PER TOKEN, (b·(n+1), d); −2 the transformer output before the
    derived CLS, flattened per image, (b, n·d); another int the residual
    stream after that block (`VisionTransformer.forward(return_hidden=)`),
    flattened per image. `resolve_hidden_layer` also takes JAX's names.
  * `SimSiam`: two augmented views, online tower + projector (with
    gradients), predictor, and the targets from two more tower passes of
    the same tower under `torch.no_grad()` (JAX's stop_gradient; the
    kernels' inference forwards run there); loss (2 − 2cos)(p1, t2) +
    (2 − 2cos)(p2, t1), batch mean.
  * `SimCLR`: NT-Xent over 2N rows at `temperature`, the diagonal removed
    by a cyclic column gather as JAX does.

BatchNorm running statistics: a training forward normalises by the batch;
it also returns the statistics' new values (`bn_updates`, {"projector/bn1":
(mean, var), ...}): each BN call folds momentum 0.1 with the UNBIASED batch
variance, sequentially in the reference's order (online projector ×2,
predictor ×2, target projector ×2), starting from the stored buffers. The
train step writes them into the buffers in their stored dtype.

Injected draws (`forward(..., draws=)`): a dict with `augment`, a list of
the two views' augmentation draws (`augment.augment_draws`; SimCLR without
`augment_both` reads only the second), and `keep_idx`, a list of the tower
passes' patch indices in order (SimSiam: online one, online two, target
one, target two; SimCLR: queries, keys). Missing draws come from the
generator.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import nn

from ..nn.core import BatchNorm1d, Linear
from ..utils import l2norm
from .augment import default_augment


def _bn(bn, x, training, updates, key, dtype=None):
    """BatchNorm `bn` on x, and with `updates` (a dict) the fold of its
    running statistics under `key`: momentum 0.1, unbiased batch variance,
    from the last fold of the same layer in this forward or the stored
    buffers in `dtype` (the model's compute dtype, to which JAX casts them;
    by default their own; `ssl.py:53-69`)."""
    out, (mean, var) = bn(x, training)
    if updates is not None and training:
        with torch.no_grad():
            dt = dtype or bn.mean.dtype
            prev_mean, prev_var = updates.get(
                key, (bn.mean.to(dt), bn.var.to(dt)))
            n = x.shape[0]
            unbiased = var * (n / max(n - 1, 1))
            updates[key] = (0.9 * prev_mean + 0.1 * mean,
                            0.9 * prev_var + 0.1 * unbiased)
    return out


class MLP(nn.Module):
    def __init__(self, dim, projection_size, hidden_size=None, *,
                 generator=None, dtype=torch.float32):
        super().__init__()
        hidden_size = hidden_size or dim
        kw = dict(generator=generator, dtype=dtype)
        self.l1 = Linear(dim, hidden_size, bias=True, **kw)
        self.bn1 = BatchNorm1d(hidden_size, dtype=dtype)
        self.l2 = Linear(hidden_size, projection_size, bias=True, **kw)

    def forward(self, x, training=True, updates=None, prefix="", dtype=None):
        x = _bn(self.bn1, self.l1(x), training, updates, prefix + "bn1",
                dtype)
        return self.l2(torch.relu(x))


class SimSiamMLP(nn.Module):
    def __init__(self, dim, projection_size, hidden_size=4096, *,
                 generator=None, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        self.l1 = Linear(dim, hidden_size, **kw)
        self.bn1 = BatchNorm1d(hidden_size, dtype=dtype)
        self.l2 = Linear(hidden_size, hidden_size, **kw)
        self.bn2 = BatchNorm1d(hidden_size, dtype=dtype)
        self.l3 = Linear(hidden_size, projection_size, **kw)
        self.bn3 = BatchNorm1d(projection_size, affine=False, dtype=dtype)

    def forward(self, x, training=True, updates=None, prefix="", dtype=None):
        x = torch.relu(_bn(self.bn1, self.l1(x), training, updates,
                           prefix + "bn1", dtype))
        x = torch.relu(_bn(self.bn2, self.l2(x), training, updates,
                           prefix + "bn2", dtype))
        return _bn(self.bn3, self.l3(x), training, updates, prefix + "bn3",
                   dtype)


def resolve_hidden_layer(hidden_layer) -> int:
    """An int block index, or JAX's names: "transformer" / "norm_out" (the
    stack's output, −2) and "transformer/<i>" (after block i)."""
    if isinstance(hidden_layer, int):
        return hidden_layer
    name = str(hidden_layer)
    if name in ("transformer", "norm_out"):
        return -2
    if name.startswith("transformer/"):
        return int(name.split("/", 1)[1])
    raise ValueError(
        f"unknown hidden layer name {name!r}; use an int block index, "
        f"'transformer', 'norm_out', or 'transformer/<block>'")


def representation_dim(encoder, hidden_layer) -> int:
    """The projector's input width: the tower's dim at −1, else the kept
    patches (`int(n·(1 − patch_dropout))`, at least 1) times dim."""
    if resolve_hidden_layer(hidden_layer) == -1:
        return encoder.dim
    num_patches = encoder.num_patches
    if getattr(encoder, "patch_dropout", 0.0) > 0.0:
        num_patches = max(1, int(num_patches * (1 - encoder.patch_dropout)))
    return num_patches * encoder.dim


def get_representation(encoder, x, hidden_layer, *, training=True,
                       attn_impl="xla", generator=None, keep_idx=None):
    """The 2-D representation fed to the projector (see the module
    docstring)."""
    hidden_layer = resolve_hidden_layer(hidden_layer)
    kw = dict(attn_impl=attn_impl, training=training, generator=generator,
              keep_idx=keep_idx)
    if hidden_layer in (-1, -2):
        full = encoder(x, **kw)
        if hidden_layer == -1:
            return full.reshape(-1, full.shape[-1])
        return full[:, 1:].reshape(full.shape[0], -1)
    _, hidden = encoder(x, return_hidden=hidden_layer, **kw)
    return hidden.reshape(hidden.shape[0], -1)


def _neg_cos(a, b):
    """2 − 2·cos, per row."""
    return 2.0 - 2.0 * (l2norm(a) * l2norm(b)).sum(dim=-1)


def _draw(draws, key, i):
    items = (draws or {}).get(key)
    return None if items is None else items[i]


class SimSiam(nn.Module):
    """`xclip_tpu.objectives.ssl.SimSiam`, its constructor's arguments;
    `build(encoder)` makes the heads for the vision tower (`CLIP` calls
    it). An `augment_fn` is called as `augment_fn(generator, x)`, as JAX
    calls it with a key."""

    def __init__(self, image_size: int, channels: int = 3,
                 hidden_layer: Any = -2, projection_size: int = 256,
                 projection_hidden_size: int = 4096,
                 augment_fn: Optional[Callable] = None,
                 augment_fn2: Optional[Callable] = None):
        super().__init__()
        self.image_size, self.channels = image_size, channels
        self.hidden_layer = hidden_layer
        self.projection_size = projection_size
        self.projection_hidden_size = projection_hidden_size
        self.augment_fn, self.augment_fn2 = augment_fn, augment_fn2
        self.projector = self.predictor = None

    def build(self, encoder, *, generator=None, dtype=torch.float32):
        """The projector and predictor for `encoder`, drawn from
        `generator`."""
        kw = dict(generator=generator, dtype=dtype)
        self.projector = SimSiamMLP(
            representation_dim(encoder, self.hidden_layer),
            self.projection_size, self.projection_hidden_size, **kw)
        self.predictor = MLP(self.projection_size, self.projection_size,
                             self.projection_hidden_size, **kw)
        return self

    def _augment(self, fn, x, generator, draws):
        if fn is not None:
            return fn(generator, x)
        return default_augment(x, self.image_size, self.channels,
                               generator=generator, draws=draws)

    def forward(self, encoder, x, *, training=True, attn_impl="xla",
                generator=None, draws=None, dtype=None):
        """→ (loss, bn_updates); `dtype` the model's compute dtype."""
        aug2 = self.augment_fn2 or self.augment_fn
        image_one = self._augment(self.augment_fn, x, generator,
                                  _draw(draws, "augment", 0))
        image_two = self._augment(aug2, x, generator,
                                  _draw(draws, "augment", 1))
        updates = {}

        def proj(img, i):
            rep = get_representation(
                encoder, img, self.hidden_layer, training=training,
                attn_impl=attn_impl, generator=generator,
                keep_idx=_draw(draws, "keep_idx", i))
            return self.projector(rep, training, updates, "projector/",
                                  dtype)

        online_one, online_two = proj(image_one, 0), proj(image_two, 1)
        pred_one = self.predictor(online_one, training, updates,
                                  "predictor/", dtype)
        pred_two = self.predictor(online_two, training, updates,
                                  "predictor/", dtype)
        with torch.no_grad():     # fresh passes, fresh patch draws
            target_one, target_two = proj(image_one, 2), proj(image_two, 3)
        loss = _neg_cos(pred_one, target_two) + _neg_cos(pred_two, target_one)
        return loss.mean(), updates


def nt_xent_loss(queries, keys, temperature=0.1):
    """NT-Xent over 2N rows (`ssl.py:246-259`): each row's positive lands
    at column N − 1 of the cyclically gathered logits."""
    b = queries.shape[0]
    n = 2 * b
    projs = torch.cat([queries, keys], dim=0)
    logits = projs @ projs.T
    rows = torch.arange(n, device=projs.device)[:, None]
    cols = (rows + 1 + torch.arange(n - 1, device=projs.device)[None]) % n
    logits = torch.gather(logits, 1, cols) / temperature
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp[:, b - 1].mean().to(queries.dtype)


class SimCLR(nn.Module):
    """`xclip_tpu.objectives.ssl.SimCLR`, its constructor's arguments;
    `build(encoder)` as `SimSiam`'s."""

    def __init__(self, image_size: int, channels: int = 3,
                 hidden_layer: Any = -2, project_hidden: bool = True,
                 project_dim: int = 128, augment_both: bool = True,
                 temperature: float = 0.1,
                 augment_fn: Optional[Callable] = None,
                 use_nt_xent_loss: bool = False):
        super().__init__()
        self.image_size, self.channels = image_size, channels
        self.hidden_layer, self.project_hidden = hidden_layer, project_hidden
        self.project_dim, self.augment_both = project_dim, augment_both
        self.temperature, self.augment_fn = temperature, augment_fn
        self.use_nt_xent_loss = use_nt_xent_loss   # ignored, as in JAX
        self.projector = None

    def build(self, encoder, *, generator=None, dtype=torch.float32):
        self.projector = SimSiamMLP(
            representation_dim(encoder, self.hidden_layer), self.project_dim,
            4096, generator=generator, dtype=dtype)
        return self

    def forward(self, encoder, x, *, training=True, attn_impl="xla",
                generator=None, draws=None, dtype=None):
        """→ (loss, bn_updates); `dtype` the model's compute dtype."""
        def aug(i):
            if self.augment_fn is not None:
                return self.augment_fn(generator, x)
            return default_augment(x, self.image_size, self.channels,
                                   generator=generator,
                                   draws=_draw(draws, "augment", i))

        one = aug(0) if self.augment_both else x
        two = aug(1)
        updates = {}

        def proj(img, i):
            rep = get_representation(
                encoder, img, self.hidden_layer, training=training,
                attn_impl=attn_impl, generator=generator,
                keep_idx=_draw(draws, "keep_idx", i))
            return self.projector(rep, training, updates, "projector/",
                                  dtype)

        loss = nt_xent_loss(proj(one, 0), proj(two, 1), self.temperature)
        return loss, updates
