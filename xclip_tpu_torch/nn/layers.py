"""Transformer building blocks — the counterparts of `xclip_tpu/nn/layers.py`:
rotary embeddings, the plain GEGLU feed-forward and attention (the `'xla'`
route), the sandwich-norm stack with kernel routing, and FLIP patch
dropout.

Routing, as `transformer_apply` does it (`nn/layers.py:311-419`):
  * the megablock, only when no rotary embedding is given (rotary acts
    between the qkv product and the scores, inside the megablock): at
    inference `attn_impl` in ('fused', 'fused_recompute', 'fused_qkv') →
    the lean forward K-MEGA (`kernels/attention_megablock.attention_block`);
    in training 'fused' → K2, the stored megablock forward and backward
    (`attention_block_train`), 'fused_qkv' and 'fused_recompute' → K3, the
    memory-lean megablock keeping qkv or nothing but row statistics
    (`attention_block_train_recompute`);
  * with a rotary embedding, `Attention` itself, as `attention_apply`:
    'fused' (and 'fused_recompute' / 'fused_qkv', which mean it there) →
    PreNorm, the qkv product, rotary on the fused qkv, K6's whole-head
    attention core (`kernels/attention_block.attention_core`), the output
    projection and LayerNorm; 'flash' → q pre-scaled, rotary on q, k and
    v, K7 (`kernels/flash_attention.flash_attention`), in inference and
    training alike; 'flash' takes this route with or without rotary;
  * `ff_impl` in ('block', 'block_stored') → the FF block's lean forward
    K-FF at inference (`kernels/fused_ff_block.ff_block`); in training
    'block_stored' → K1, the stored-GEGLU FF block (`ff_block_train`), or,
    with the environment variable XCLIP_FF_STORE=h when the layer runs,
    K1-h, the stored-h FF block (`ff_block_train_stored_h`); 'block' →
    K-FF-s with the recompute backward (`ff_block_train_recompute`). The
    JAX stack's scoped-VMEM gates between these variants are TPU
    artefacts: each flag takes its own route;
  * `ff_impl='fused'` → `FeedForward` itself, as `feed_forward_apply`:
    PreNorm, the w_in product, K8's GEGLU + inner LayerNorm
    (`kernels/fused_ff.geglu_layernorm`), the w_out product, in inference
    and training alike;
  * `'xla'` → the plain PyTorch modules below plus the residual, trained
    by autograd.
A training pass under `torch.no_grad()` (the SimSiam targets) takes the
inference forwards K-MEGA and K-FF: no backward will read residuals.
Where the JAX package itself falls back to its XLA path (K6's head
groups, the FF block's column blocks, and in training attention or FF
dropout, which no kernel has: the megablock, 'fused', 'flash', the FF
block and K8 all give way), so does the port, on every device, and warns
once per cause as JAX's `_warn_fallback` words it; `transformer_routes`
decides it from the shapes and, in training, the dropout rates. Everywhere
else a kernel flag takes its kernel: on the card the CUDA wrapper launches
it or raises (`why_not` in each kernel module names the limit), and never
gives way to the plain version; on the CPU every kernel route runs its
plain version. The bf16 attention kernels take a head at its true width,
any multiple of 8 up to 256 (ViT-H/14's 80 at 80), the fp32 ones heads of
64 and 128; another head runs on them zero-padded to its
`kernels._common.kernel_width` (`attention_megablock.pad_heads`: fp32's 80
at 128), and a head wider than the kernels take raises on the card.

Tensor parallelism (`parallel.shard_params`, `Transformer.model_group`):
on the plain route a layer holds its heads' q, k and v columns of
`to_qkv.w`, their rows of `to_out.w`, and its inner slice of `w_in.w`
(value and gate), `inner_norm.g` and `w_out.w`. The replicated input of
each column-parallel product passes `collectives.pvary` (the identity;
its backward sums the ranks' gradients), the row-parallel outputs are
summed over the model group (`collectives.psum`), and the inner
LayerNorm's statistics are the whole row's (`core.layer_norm` with the
group), so each rank computes the whole layer's output and every
replicated parameter's whole gradient. A kernel route gathers the
layer's weights over the model group (`sharding.whole`) and runs its
kernel on the whole layer, unchanged; the gather's backward keeps this
rank's shard of the weight gradient, which every rank computes whole.

Dropout (training only): the plain attention drops its weights after the
softmax, the plain FF its inner activations after the inner LayerNorm;
each layer's sites draw from a `core.RngStream` whose seed is drawn from
the step's generator before the stack runs (one seed a layer, as JAX
splits one key a layer), or take injected keep masks.

Remat (`checkpoint_during_training` in training, `nn/layers.py:298-312`,
`:421-424` of the JAX package): `remat_policy=None` wraps each layer's
attention and FF in `torch.utils.checkpoint` (non-reentrant: the kernels'
autograd Functions keep their `save_for_backward` tensors only through
its hooks, and their forwards run again in the backward); `'dots'` does
the same keeping the outputs of the 2-D products (`save_products`);
`'wide'` wraps no layer, only the plain FF's middle and, without attention
dropout, the plain attention's softmax part, as JAX does.
The JAX stack pads a text sequence of n >= 128 to the TPU sublane tile when
both kernels run; the port does not, since pad rows are masked keys and the
FF block is row-wise, so real rows are unchanged and pad rows, whose
cotangents are zero, add nothing to any gradient.
"""

from __future__ import annotations

import functools
import os
import warnings

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels import attention_block as core
from ..kernels import fused_ff_block as _ffb
from ..kernels.attention_megablock import (attention_block,
                                          attention_block_train,
                                          attention_block_train_recompute)
from ..kernels.flash_attention import flash_attention
from ..kernels.fused_ff import geglu_layernorm
from ..kernels.fused_ff_block import (ff_block, ff_block_train,
                                      ff_block_train_recompute,
                                      ff_block_train_stored_h)
from ..parallel.collectives import axis_index, axis_size, psum, pvary
from ..parallel.sharding import whole
from .core import (LayerNorm, Linear, RngStream, cast, compute_dtype,
                   computing_in, dropout, layer_norm, linear)

ATTN_IMPLS = ("xla", "fused", "fused_recompute", "fused_qkv", "flash")
MEGA_IMPLS = ("fused", "fused_recompute", "fused_qkv")
FF_IMPLS = ("xla", "block", "block_stored", "fused")
FF_BLOCK_IMPLS = ("block", "block_stored")
REMAT_POLICIES = (None, "dots", "wide")


def check_impls(attn_impl, ff_impl, remat_policy=None):
    """Raise for an unknown route or remat policy."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    if ff_impl not in FF_IMPLS:
        raise ValueError(f"unknown ff_impl {ff_impl!r}")
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}")


def save_products(ctx, op, *args, **kwargs):
    """The `'dots'` remat policy, JAX's `dots_with_no_batch_dims_saveable`:
    keep the outputs of 2-D products (`aten.mm`, which a 3-D × 2-D `@`
    reaches; a batched one reaches `aten.bmm`) and recompute the rest. A
    CUDA kernel's products run inside its library, unseen by the
    dispatcher, so a kernel layer keeps none, as a `pallas_call` is no
    dot."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(save_products)


_warned_fallbacks = set()


def _warn_fallback(requested: str, reason: str):
    """Warn once per distinct cause when a requested kernel route takes the
    plain ('xla') route, in the words of the JAX package's `_warn_fallback`
    (`xclip_tpu/nn/layers.py:39-46`)."""
    if (requested, reason) not in _warned_fallbacks:
        _warned_fallbacks.add((requested, reason))
        warnings.warn(f"{requested} requested but falling back to the XLA "
                      f"path: {reason}", stacklevel=3)


def attention_route(attn_impl, *, heads, dim_head, training=False,
                    attn_dropout=0.0):
    """`Attention`'s route, as `attention_apply` takes it → (route,
    fallback): route 'fused' (K6), 'flash' (K7) or 'xla'; fallback None, or
    (requested, reason) where JAX's own gates turn the kernel off
    (attention dropout in training for both; K6's head groups)."""
    if attn_impl in ("fused_recompute", "fused_qkv"):
        # the store/recompute distinction is the megablock's only
        attn_impl = "fused"
    dropout_active = training and attn_dropout > 0.0
    if attn_impl == "fused" and dropout_active:
        return "xla", ("attn_impl='fused'",
                       "attn_dropout > 0 in training mode (the fused "
                       "whole-head kernel has no attention dropout)")
    if attn_impl == "fused" and not core.supported(heads, dim_head):
        return "xla", (f"attn_impl={attn_impl!r}",
                       f"heads={heads}, dim_head={dim_head} does not tile "
                       "into 128-lane head groups")
    if attn_impl == "flash" and dropout_active:
        return "xla", ("attn_impl='flash'",
                       "attn_dropout > 0 in training mode (the flash kernel "
                       "does not implement attention-weight dropout)")
    return attn_impl, None


def ff_route(ff_impl, *, dim, inner, training=False, ff_dropout=0.0):
    """The FF route → (route, fallback): route 'block' (the FF block
    kernels), 'fused' (K8) or 'xla'; fallback None, or (requested, reason)
    where JAX's own gates turn the kernel off (FF dropout in training for
    both; the FF block's column blocks, `fused_ff_block.supported`)."""
    dropout_active = training and ff_dropout > 0.0
    if ff_impl == "fused" and dropout_active:
        return "xla", ("ff_impl='fused'",
                       "ff_dropout > 0 in training mode (the fused GEGLU+LN "
                       "kernel has no dropout epilogue)")
    if ff_impl not in FF_BLOCK_IMPLS:
        return ff_impl, None
    if dropout_active:
        return "xla", (f"ff_impl={ff_impl!r}",
                       "ff_dropout active in training mode")
    if not _ffb.supported(dim, inner):
        return "xla", (f"ff_impl={ff_impl!r}",
                       f"inner width {inner} has no usable column block "
                       "divisor for the dW pass")
    return "block", None


def transformer_routes(attn_impl, ff_impl, *, dim, heads, dim_head, inner,
                       rotary, training=False, attn_dropout=0.0,
                       ff_dropout=0.0):
    """The routes `Transformer.forward` takes → (attn, ff, fallbacks): attn
    'mega' (the megablock: a megablock flag, no rotary embedding and no
    attention dropout in training) or `attention_route`'s; ff `ff_route`'s;
    fallbacks the (requested, reason) of each kernel route that JAX's gates
    turn off. A function of the shapes and, in training, of the dropout
    rates, the same on every device."""
    fallbacks = []
    if (attn_impl in MEGA_IMPLS and not rotary
            and not (training and attn_dropout > 0.0)):
        attn = "mega"
    else:
        attn, fallback = attention_route(
            attn_impl, heads=heads, dim_head=dim_head, training=training,
            attn_dropout=attn_dropout)
        fallbacks += [fallback] if fallback else []
    ff, fallback = ff_route(ff_impl, dim=dim, inner=inner, training=training,
                            ff_dropout=ff_dropout)
    fallbacks += [fallback] if fallback else []
    return attn, ff, fallbacks


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


def ff_middle(x, w, g, group=None):
    """w_in (as two half products) → GEGLU (exact GELU) → inner LayerNorm:
    the inner-width part of the plain FF, which `'wide'` remat recomputes
    (`_ff_middle`). With a model `group`, `w` holds this rank's value and
    gate columns and `g` its slice of the gain (`parallel.sharding`)."""
    inner = w.shape[-1] // 2
    v, gate = x @ w[:, :inner], x @ w[:, inner:]
    return layer_norm(v * F.gelu(gate), g, group)


class FeedForward(nn.Module):
    """PreNorm → w_in → GEGLU (exact GELU) → inner LayerNorm → w_out;
    with `ff_impl='fused'` the middle is K8 (fp32 GEGLU and statistics,
    the output rounded once), otherwise plain PyTorch, dropping its inner
    activations at `rate` from `rngs`. Under a model `group` (its weights
    sharded, `parallel.sharding`) the plain route computes this rank's
    inner slice and sums the ranks' outputs; K8 runs on the gathered
    weights."""

    def __init__(self, dim: int, mult: int = 4, *, generator=None,
                 dtype=torch.float32):
        super().__init__()
        inner = dim * mult
        self.inner = inner
        self.norm = LayerNorm(dim, dtype=dtype)
        self.w_in = Linear(dim, inner * 2, generator=generator, dtype=dtype)
        self.inner_norm = LayerNorm(inner, dtype=dtype)
        self.w_out = Linear(inner, dim, generator=generator, dtype=dtype)

    def forward(self, x, ff_impl="xla", *, rate=0.0, rngs=None,
                remat_wide=False, group=None):
        x = self.norm(x)
        w_in, g, w_out = self.w_in.w, self.inner_norm.g, self.w_out.w
        shard = None
        if ff_impl == "fused":   # K8 takes the layer whole
            w_in, g, w_out = whole(w_in), whole(g), whole(w_out)
        elif group is not None:
            x = pvary(x, group)
            shard = (-1, axis_index(group), axis_size(group))
        w = cast(w_in, x.dtype)
        g = cast(g, x.dtype)
        if ff_impl == "fused":
            x = geglu_layernorm(x @ w, g)
        else:
            if remat_wide:
                x = checkpoint(ff_middle, x, w, g, group,
                               use_reentrant=False)
            else:
                x = ff_middle(x, w, g, group)
            if rate:
                x = dropout(x, rate, rngs, shard)
        x = linear(x, w_out)
        return x if shard is None else psum(x, group)


def rotary_freqs(seq_len: int, rot_dim: int, device=None) -> torch.Tensor:
    """`cat((freqs, freqs), -1)` of shape (seq_len, rot_dim), fp32, with
    inv_freq = 1/10000^(2i/rot_dim) (`xclip_tpu/nn/layers.py:53-59`)."""
    inv_freq = 1.0 / (10000 ** (torch.arange(
        0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.einsum("i,j->ij", t, inv_freq)
    return torch.cat([freqs, freqs], dim=-1)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(freqs, t):
    """Partial rotation: the first rot_dim features of `t` rotated, the rest
    passed through; cos and sin are cast to t's dtype before the products
    (`xclip_tpu/nn/layers.py:67-75`)."""
    rot_dim = freqs.shape[-1]
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    cos, sin = freqs.cos().to(t.dtype), freqs.sin().to(t.dtype)
    t_rot = t_rot * cos + _rotate_half(t_rot) * sin
    return torch.cat([t_rot, t_pass], dim=-1)


class Attention(nn.Module):
    """PreNorm → fused qkv → per-head softmax attention → output projection
    → LayerNorm, `attention_apply`'s routes: 'xla' (q pre-scaled, masks
    filled with -finfo.max, fp32 softmax), 'fused' (K6 on the fused qkv)
    and 'flash' (K7). A rotary embedding rotates q, k AND v (the reference
    quirk, `x_clip.py:223`). Under a model `group` (its weights sharded,
    `parallel.sharding`) the plain route attends with this rank's heads
    and sums the ranks' output projections; the kernels run on the
    gathered weights."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, *,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = dim_head * heads
        self.norm = LayerNorm(dim, dtype=dtype)
        self.to_qkv = Linear(dim, inner * 3, generator=generator, dtype=dtype)
        self.to_out = Linear(inner, dim, generator=generator, dtype=dtype)
        self.out_norm = LayerNorm(dim, dtype=dtype)

    def forward(self, x, mask=None, causal=False, rotary=None,
                attn_impl="xla"):
        # the reference's routing and its warning (`nn/layers.py:163-175`)
        route, fallback = attention_route(attn_impl, heads=self.heads,
                                          dim_head=self.dim_head)
        if fallback:
            _warn_fallback(*fallback)
        return self.run(x, mask, causal, rotary, route)

    def run(self, x, mask, causal, rotary, route, *, rate=0.0, rngs=None,
            remat_wide=False, group=None):
        """The layer on a route `attention_route` has resolved: 'fused',
        'flash' or 'xla' (which drops its attention weights at `rate` from
        `rngs`, and under `remat_wide` without dropout recomputes its
        softmax part in the backward); `group` the model group of sharded
        weights, or None."""
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        scale = d ** -0.5
        w_qkv, w_out = self.to_qkv.w, self.to_out.w
        xn, shard = self.norm(x), None
        if route != "xla":   # K6 and K7 take the layer whole
            w_qkv, w_out = whole(w_qkv), whole(w_out)
        elif group is not None:
            xn = pvary(xn, group)
            h //= axis_size(group)
            shard = (1, axis_index(group), axis_size(group))
        qkv = linear(xn, w_qkv)
        if route == "fused":
            if rotary is not None:
                # the same rotation of every dim_head-wide head slice
                qkv = apply_rotary_pos_emb(
                    rotary[:, None, :], qkv.reshape(b, n, 3 * h, d)
                ).reshape(b, n, 3 * h * d)
            key_mask = (mask if mask is not None else
                        torch.ones((b, n), dtype=torch.bool, device=x.device))
            out = core.attention_core(qkv, key_mask, h, d, scale, causal,
                                      mask is not None)
            return self.out_norm(linear(out, w_out))
        q, k, v = (t.reshape(b, n, h, d).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        q = q * scale
        if rotary is not None:
            q, k, v = (apply_rotary_pos_emb(rotary, t) for t in (q, k, v))
        if route == "flash":
            out = flash_attention(q, k, v, mask=mask, causal=causal)
        elif remat_wide and not rate:
            out = checkpoint(self._attend, q, k, v, mask, causal,
                             use_reentrant=False)
        else:
            out = self._attend(q, k, v, mask, causal, rate, rngs, shard)
        out = linear(out.transpose(1, 2).reshape(b, n, h * d), w_out)
        if shard is not None:
            out = psum(out, group)
        return self.out_norm(out)

    @staticmethod
    def _attend(q, k, v, mask, causal, rate=0.0, rngs=None, shard=None):
        """The 'xla' route's softmax(q·kᵀ)·v on (b, h, n, d), q pre-scaled,
        the weights dropped at `rate` after the softmax (`shard`: q holds
        that block of the heads, `core.dropout`)."""
        n = q.shape[2]
        sim = q @ k.transpose(-1, -2)
        big_neg = -torch.finfo(sim.dtype).max
        if mask is not None:
            sim = torch.where(mask[:, None, None, :], sim, big_neg)
        if causal:
            future = torch.ones(n, n, dtype=torch.bool,
                                device=q.device).triu(1)
            sim = torch.where(future, big_neg, sim)
        if sim.dtype == torch.float32:
            attn = sim.softmax(dim=-1)
        else:  # fp32 statistics, storage-dtype weights
            shifted = (sim - sim.amax(dim=-1, keepdim=True)).float()
            denom = shifted.exp().sum(dim=-1, keepdim=True).log()
            attn = (shifted - denom).exp().to(sim.dtype)
        if rate:
            attn = dropout(attn, rate, rngs, shard)
        return attn @ v


class Layer(nn.Module):
    def __init__(self, dim, *, dim_head, heads, ff_mult, generator, dtype):
        super().__init__()
        self.attn = Attention(dim, dim_head=dim_head, heads=heads,
                              generator=generator, dtype=dtype)
        self.ff = FeedForward(dim, mult=ff_mult, generator=generator,
                              dtype=dtype)


class Transformer(nn.Module):
    """Sandwich-norm stack: norm_in → depth × (attention + residual, FF +
    residual) → norm_out, layers in an `nn.ModuleList`. `model_group` is
    the model group of its tensor-parallel weights once
    `parallel.shard_params` has sharded them (None: whole weights)."""

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
        self.model_group = None

    def forward(self, x, mask=None, *, causal=False, rotary=None,
                attn_impl="xla", ff_impl="xla", training=False,
                checkpoint_during_training=False, remat_policy=None,
                attn_dropout=0.0, ff_dropout=0.0, generator=None,
                dropout_keep=None, return_hidden=None):
        """`rotary`: (n, rot_dim) fp32 frequencies (`rotary_freqs`) or
        None. `training` selects dropout and remat and, where a gradient
        will be taken (`torch.is_grad_enabled()`), the kernels' training
        routes (K2 or K3; K1, K1-h or the recompute FF block; K8 with its
        backward); otherwise the lean inference forwards run, which take
        no gradient and keep no residuals (K8 serves both): a training
        pass under `torch.no_grad()`, as the SimSiam targets', takes them.
        Dropout seeds, one a layer, are drawn from `generator` (None:
        PyTorch's default generator); `dropout_keep` injects the keep masks
        instead: for each layer, its sites' masks in order (attention,
        then FF). `return_hidden` (an int, negative counting from the end)
        also returns the residual stream after that layer:
        (out, hidden)."""
        check_impls(attn_impl, ff_impl, remat_policy)
        attn_rate = attn_dropout if training else 0.0
        ff_rate = ff_dropout if training else 0.0
        attn_route, ffn_route, fallbacks = transformer_routes(
            attn_impl, ff_impl, dim=x.shape[-1], heads=self.heads,
            dim_head=self.dim_head,
            inner=self.layers[0].ff.inner if self.layers else 0,
            rotary=rotary is not None, training=training,
            attn_dropout=attn_dropout, ff_dropout=ff_dropout)
        for fallback in fallbacks:
            _warn_fallback(*fallback)
        use_mega = attn_route == "mega"
        use_ffb = ffn_route == "block"
        mega, ffb = attention_block, ff_block
        if training and torch.is_grad_enabled():
            mega = (attention_block_train if attn_impl == "fused" else
                    functools.partial(attention_block_train_recompute,
                                      keep_qkv=attn_impl == "fused_qkv"))
            if ff_impl != "block_stored":
                ffb = ff_block_train_recompute
            elif os.environ.get("XCLIP_FF_STORE") == "h":   # as JAX reads it
                ffb = ff_block_train_stored_h
            else:
                ffb = ff_block_train
        streams = [None] * len(self.layers)
        if dropout_keep is not None:
            streams = [dict(masks=m) for m in dropout_keep]
        elif attn_rate or ff_rate:
            # one seed a layer, fixed before the stack, so that a
            # recomputing backward draws the same masks
            seeds = torch.randint(
                2 ** 62, (len(self.layers),), generator=generator,
                device=generator.device if generator is not None else "cpu")
            streams = [dict(seed=s) for s in seeds.tolist()]
        remat = (training and checkpoint_during_training
                 and torch.is_grad_enabled())
        wide = remat and remat_policy == "wide"
        x = self.norm_in(x)
        if use_mega:
            key_mask = (mask if mask is not None else
                        torch.ones(x.shape[:2], dtype=torch.bool,
                                   device=x.device))

        rounding = compute_dtype()
        group = self.model_group

        def block(x, layer, stream):
            """One layer, attention then FF; its weight casts (in the
            forward's compute dtype) and dropout stream inside, where a
            recompute repeats them."""
            with computing_in(rounding):
                return layer_body(x, layer, stream)

        def layer_body(x, layer, stream):
            a, f = layer.attn, layer.ff
            dt = x.dtype
            rngs = RngStream(**stream) if stream else None
            # a kernel takes the layer's weights whole (`whole` gathers
            # the shards of a tensor-parallel one)
            if use_mega:
                x = mega(
                    x, cast(a.norm.g, dt), cast(whole(a.to_qkv.w), dt),
                    cast(whole(a.to_out.w), dt), cast(a.out_norm.g, dt),
                    key_mask, self.heads, self.dim_head,
                    self.dim_head ** -0.5, causal, mask is not None)
            else:
                x = a.run(x, mask, causal, rotary, attn_route, rate=attn_rate,
                          rngs=rngs, remat_wide=wide, group=group) + x
            if use_ffb:
                return ffb(x, cast(f.norm.g, dt), cast(whole(f.w_in.w), dt),
                           cast(whole(f.inner_norm.g), dt),
                           cast(whole(f.w_out.w), dt))
            return f(x, ffn_route, rate=ff_rate, rngs=rngs,
                     remat_wide=wide, group=group) + x

        hiddens = []
        for layer, stream in zip(self.layers, streams):
            if remat and not wide:
                # the masks come from the layer's own seeds, so the default
                # generators' states need no saving
                x = checkpoint(block, x, layer, stream, use_reentrant=False,
                               preserve_rng_state=False,
                               **({"context_fn": _dots_context}
                                  if remat_policy == "dots" else {}))
            else:
                x = block(x, layer, stream)
            if return_hidden is not None:
                hiddens.append(x)
        out = self.norm_out(x)
        if return_hidden is not None:   # `transformer_apply`'s tap
            return out, hiddens[return_hidden]
        return out
