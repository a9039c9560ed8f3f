"""The train step — the counterpart of `xclip_tpu/train/trainer.py`'s
`make_train_step`, `default_optimizer` and `shard_batch`.

`default_optimizer` is optax's chain `clip_by_global_norm(max_grad_norm)`
→ `adamw(schedule, b1, b2, eps=1e-8, weight_decay)` written out in
PyTorch, operation for operation:
  * the global norm is sqrt(Σ_leaves Σ g²) (here in fp32, from the
    per-tensor norms, an fp32 tensor's accumulated in fp64, as JAX's tree
    reductions come close to it), and the clip scales by max_norm / norm
    only when norm ≥ max_norm (`clip_by_global_norm`; `torch.nn.utils.
    clip_grad_norm_` adds 1e-6 to the norm, so it is not used);
  * Adam moments live in the parameter dtype (optax's `mu_dtype=None`),
    mu = (1 − b1)·g + b1·mu, nu = (1 − b2)·g² + b2·nu, divided by the
    bias corrections 1 − b^t rounded to fp32;
  * update = mu_hat / (sqrt(nu_hat) + eps) + weight_decay·p for EVERY
    parameter (optax `adamw` with `mask=None`), scaled by −lr(count);
  * the learning rate follows `optax.warmup_cosine_decay_schedule(0, lr,
    warmup, total)` when both are set (warmup clamped to total − 1, as
    `trainer.py:208`), else stays constant.
A parameter that receives no gradient (an unused extra latent head) is
updated with a zero gradient, as JAX differentiates every leaf.

The optimizer's step count (`AdamW.count`, which optax keeps in its state)
is part of `AdamW.state_dict()`, so a restored optimizer resumes the
schedule and the bias corrections where they were.

The step runs eagerly on the parameters' device and returns the metrics as
0-d tensors (no host sync): the model's metrics (JAX's seven keys) and
`grad_norm` (before the clip). `grad_accum > 1` splits the batch into that
many microbatches, each with its own forward and backward (activation
memory is one microbatch's, as under JAX's `lax.scan`); the gradients
accumulate in the parameters' dtype in microbatch order, as JAX sums them
from zeros, and are divided by `grad_accum` once, at the end, as are the
metrics; `grad_norm` is the averaged gradients'. `valid=` is the loader's
pad-and-mask (`CLIPModel.forward`'s `row_valid`).

With a visual SSL head, the step writes the forward's BatchNorm statistics
(`bn_updates`) into the heads' buffers after the optimizer's update, in
their stored dtype (`trainer.py:44-56`, `:146-151`): they are buffers, so
AdamW never sees them (JAX's optax keeps moments for them, zeros at every
step, as their gradient is zero, and its update of them is overwritten by
the fold). Under `grad_accum > 1`, as JAX documents it, only the LAST
microbatch's statistics are kept, each microbatch folding from the
statistics stored before the step.

Data parallelism (`axis_name`, a `torch.distributed` `ProcessGroup`): each
rank runs the step on its shard of the global batch (`shard_batch`: its
contiguous rows), every forward with `axis_name`, so the contrastive loss
is the global batch's on every rank (`CLIPModel.forward`). The summed
gradients are then all-reduced (summed) once a step, one flat buffer a
dtype, before the division by `grad_accum`, the norm and the clip, so
`grad_norm` and the clip are the global ones and every rank makes the same
update. For the contrastive objectives this is JAX's GSPMD step
(`make_train_step` over `shard_batch`ed arrays); the MLM and visual SSL
losses follow JAX's `axis_name` semantics instead (this shard's loss,
averaged over the ranks), and each rank folds its own shard's BatchNorm
statistics: JAX's two distributed entry points differ there (ROADMAP.md).
A microbatch under `grad_accum` is each rank's share of it, so its
negatives are the ranks' i-th microbatches together.

The mesh step (`make_train_step(..., mesh=mesh)`, a `parallel.create_mesh`
grid of (data, model) ranks, after `shard_state` and `shard_batch(...,
mesh)`): the counterpart of JAX's step over a (data, model) mesh.
  * The batch is this rank's shard along 'data'; the forward runs with
    the data group as `axis_name` where that axis has more than one rank
    (a data axis of 1 shards nothing, and the loss is the plain one).
  * The tensor-parallel layers run on the rank's shards over its model
    group (`parallel.sharding`, `nn/layers.py`), and every rank of a model
    group computes the same loss: its gradients of the replicated
    parameters are whole, those of the sharded ones its shards' whole
    gradients. So the gradients are summed over the data group only,
    one flat all-reduce a dtype, as above.
  * The global norm of the clip is `optax.global_norm` over JAX's global
    arrays: the squared norms of the sharded gradients summed over the
    model group, those of the replicated ones counted once
    (`AdamW.model_group`), the same on every rank.
  * The ranks of a model group draw the same patch keep indices, dropout
    masks and objective draws: the step gives them the state of the
    generator of its first rank before the forward.
  * The AdamW update runs on the local shards; the moments are the
    shards' (`shard_state`).
For the contrastive objectives this is JAX's GSPMD step. The MLM and
visual SSL losses keep the port's `axis_name` semantics above where the
data axis has more than one rank (each shard's loss, averaged), which
differs from GSPMD's global batch statistics; with one data rank, tensor
parallelism does not touch the batch and the two agree.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.collectives import (all_reduce_sum_, axis_index, axis_size,
                                    check_device, psum)
from ..parallel.mesh import Mesh, data_sharding
from ..parallel.sharding import (is_sharded, model_group,
                                 opt_state_shardings, shard_params,
                                 shard_tensor)
from ..utils import cast_tuple


def warmup_cosine_lr(step: int, learning_rate: float, warmup_steps: int = 0,
                     total_steps: Optional[int] = None) -> float:
    """The learning rate at optimizer step `step` (0-based), as
    `default_optimizer`'s schedule."""
    if not (warmup_steps and total_steps):
        return learning_rate
    warmup = min(warmup_steps, max(total_steps - 1, 1))
    if step < warmup:  # linear 0 → lr (optax linear_schedule)
        return learning_rate * min(step, warmup) / warmup
    decay = total_steps - warmup
    t = min(step - warmup, decay)
    return learning_rate * 0.5 * (1 + math.cos(math.pi * t / decay))


class AdamW(torch.optim.Optimizer):
    """optax `clip_by_global_norm` + `adamw`, see the module docstring.
    `step()` returns the global gradient norm before the clip.
    `model_group` (set by `shard_state` where the model axis shards
    anything) makes the norm that of the whole parameters: the sharded
    gradients' squared norms summed over it."""

    def __init__(self, params, learning_rate=3e-4, weight_decay=0.2,
                 b1=0.9, b2=0.98, eps=1e-8, max_grad_norm=1.0,
                 warmup_steps=0, total_steps=None):
        super().__init__(params, dict(
            learning_rate=learning_rate, weight_decay=weight_decay, b1=b1,
            b2=b2, eps=eps, warmup_steps=warmup_steps,
            total_steps=total_steps))
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.model_group = None

    def lr(self, group) -> float:
        return warmup_cosine_lr(self.count, group["learning_rate"],
                                group["warmup_steps"], group["total_steps"])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        # the global norm, taken in fp32 from the per-tensor norms, the fp32
        # tensors' first: an fp32 tensor's norm accumulated in fp64 (in fp32
        # on the CPU its squares are summed one by one, 7.5e-4 low at 16.7M
        # elements), the others' in their dtype
        wide = [g.dtype == torch.float32 for g in grads]
        order = [i for w in (True, False) for i in range(len(grads))
                 if wide[i] == w]
        norms = torch.cat([
            torch.stack(torch._foreach_norm(ts, 2, dtype=dt)).float()
            for ts, dt in (([g for g, w in zip(grads, wide) if w],
                            torch.float64),
                           ([g for g, w in zip(grads, wide) if not w], None))
            if ts])
        if self.model_group is None:
            norm = torch.linalg.vector_norm(norms)
        else:
            sharded = torch.tensor([is_sharded(params[i]) for i in order],
                                   device=norms.device)
            sq = norms * norms
            norm = torch.sqrt(psum(sq[sharded].sum(), self.model_group)
                              + sq[~sharded].sum())
        if self.max_grad_norm is not None:
            factor = torch.where(norm < self.max_grad_norm, 1.0,
                                 self.max_grad_norm / norm)
            grads = torch._foreach_mul(grads, factor)
        t = self.count + 1
        start = 0
        for group in self.param_groups:
            ps = group["params"]
            gs = grads[start:start + len(ps)]
            start += len(ps)
            self._update(group, ps, gs, t)
        self.count = t
        return norm

    def state_dict(self):
        """`torch.optim.Optimizer.state_dict()` and the step count."""
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = state_dict.pop("count")
        super().load_state_dict(state_dict)
        # the moments keep their own dtype, which `Optimizer` would cast to
        # the parameter's: a 0-d bf16 parameter's are fp32, as its clipped
        # gradient is (times the fp32 0-d clip factor)
        params = [p for g in self.param_groups for p in g["params"]]
        for i, saved in state_dict["state"].items():
            for k, v in saved.items():
                self.state[params[i]][k] = v.to(params[i].device, copy=True)

    def _update(self, group, ps, gs, t):
        """One AdamW update of `ps` in place, in optax's operation order;
        multi-tensor (`torch._foreach_*`) so a step costs a few launches,
        not a few per parameter."""
        b1, b2 = group["b1"], group["b2"]
        for p in ps:
            if not self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p)
                self.state[p]["nu"] = torch.zeros_like(p)
        mu = torch._foreach_mul(gs, 1 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(
            [self.state[p]["mu"] for p in ps], b1))
        nu = torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            [self.state[p]["nu"] for p in ps], b2))
        for p, m, v in zip(ps, mu, nu):
            self.state[p]["mu"], self.state[p]["nu"] = m, v
        # bias corrections 1 - b^t, rounded to fp32 as optax computes them
        bc1, bc2 = (float(torch.tensor(1 - b ** t, dtype=torch.float32))
                    for b in (b1, b2))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, group["eps"])
        u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_add_(u, torch._foreach_mul(ps, group["weight_decay"]))
        torch._foreach_mul_(u, -self.lr(group))
        torch._foreach_add_(ps, u)


def default_optimizer(params, learning_rate: float = 3e-4,
                      weight_decay: float = 0.2, b1: float = 0.9,
                      b2: float = 0.98, max_grad_norm: Optional[float] = 1.0,
                      warmup_steps: int = 0,
                      total_steps: Optional[int] = None) -> AdamW:
    """CLIP-style AdamW (decoupled weight decay, β2 = 0.98) with optional
    global-norm clipping and warmup-cosine schedule, over `params`."""
    return AdamW(params, learning_rate=learning_rate,
                 weight_decay=weight_decay, b1=b1, b2=b2,
                 max_grad_norm=max_grad_norm, warmup_steps=warmup_steps,
                 total_steps=total_steps)


def shard_state(model, optimizer, mesh: Mesh):
    """Place `model`'s parameters AND `optimizer`'s state (an `AdamW`) on
    `mesh` by the TP/DP rules (`parallel.sharding`), in place
    (`trainer.py:160-171`): each rank keeps its shard of every
    tensor-parallel parameter and of both of its moments, and whole copies
    of the rest; the step count stays as it is on every rank. Moments made
    before (a restored optimizer) are sharded as their parameters; a fresh
    optimizer makes them in the shards' shapes at its first step. Returns
    (model, optimizer)."""
    names = {id(p): n for n, p in model.named_parameters()}
    placement = opt_state_shardings(optimizer, model, mesh)["state"]
    shard_params(model, mesh)
    with torch.no_grad():
        for group in optimizer.param_groups:
            for p in group["params"]:
                for k, v in optimizer.state.get(p, {}).items():
                    s = placement[names[id(p)]][k]
                    if v.shape != p.shape:
                        optimizer.state[p][k] = shard_tensor(
                            v, s).contiguous()
    optimizer.model_group = model_group(mesh)
    return model, optimizer


def shard_batch(batch_arrays, mesh):
    """This rank's contiguous rows of each array's leading (batch) dim
    (`trainer.py:174-197`): its shard along the 'data' axis of `mesh`, a
    `parallel.create_mesh` mesh, or, `mesh` a `ProcessGroup`, its rows
    among the group's ranks. A global batch that does not divide into
    equal shards raises JAX's `ValueError`: the sharded loss locates
    positives by row offset."""
    on_mesh = isinstance(mesh, Mesh)
    n_data = mesh.axis_size("data") if on_mesh else axis_size(mesh)
    out = []
    for a in batch_arrays:
        if a.shape[0] % n_data != 0:
            raise ValueError(
                f"global batch {a.shape[0]} is not divisible by the 'data' "
                f"mesh axis ({n_data}): the sharded contrastive loss "
                "requires equal per-device batches (positives are located "
                "by row offset). Pad or truncate the batch to a multiple — "
                "the TextImageLoader does this automatically.")
        if on_mesh:
            out.append(shard_tensor(a, data_sharding(mesh, a.ndim)))
        else:
            rows = a.shape[0] // n_data
            rank = axis_index(mesh)
            out.append(a[rank * rows:(rank + 1) * rows])
    return tuple(out)


def _share_draws(generator, group, device):
    """Give every rank of `group` the state of its first rank's generator
    (`generator`, or PyTorch's default one on `device`), so that they draw
    alike."""
    if generator is None:
        generator = (torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
            if device.type == "cuda" else torch.default_generator)
    state = generator.get_state()
    on = state.to(device) if str(dist.get_backend(group)) == "nccl" \
        else state
    check_device(on, group)
    dist.broadcast(on, src=dist.get_global_rank(group, 0), group=group)
    generator.set_state(on.cpu())


def make_train_step(model, optimizer, *, grad_accum: int = 1,
                    axis_name=None, mesh: Mesh = None):
    """Returns `step(text, image, generator=None, keep_idx=None, valid=None,
    *, aug_text=None, aug_image=None, mlm_draws=None, ssl_draws=None) ->
    metrics`: the forward with the model's loss and its backward (once, or
    once a microbatch), one optimizer update of `model` (a `CLIP` or a
    `CLIPModel`) in place, and the fold of its SSL heads' BatchNorm
    statistics. `generator` feeds every draw of the forward (default: the
    `CLIP`'s call generator; a microbatch draws after the one before it);
    `keep_idx` injects the patch indices (a microbatch takes its rows);
    `valid` (b,) bool marks the rows of a padded short batch that count.
    `aug_text` / `aug_image` are the augmented views (a microbatch takes
    its rows of each); `mlm_draws` / `ssl_draws` inject the MLM's and the
    visual SSL's draws (`CLIPModel.forward`), under `grad_accum > 1` as a
    list of one a microbatch. With `axis_name` (a `ProcessGroup`) the
    step is data-parallel: the batch is this rank's shard; with `mesh` (a
    `parallel.create_mesh` mesh, the state placed by `shard_state`) it is
    the (data, model) step (see the module docstring)."""
    reduce_over, share = axis_name, None
    if mesh is not None:
        if axis_name is not None:
            raise ValueError("make_train_step takes axis_name or mesh, not "
                             "both")
        if "data" in mesh.shape:
            reduce_over = mesh.group("data")
            if mesh.axis_size("data") > 1:
                axis_name = reduce_over
        share = model_group(mesh)
    if grad_accum > 1:
        # the contrastive objective is NOT invariant to this split
        warnings.warn(
            f"grad_accum={grad_accum}: each microbatch sees only its OWN "
            f"1/{grad_accum} of the batch as contrastive negatives. This "
            "is a materially different (easier) InfoNCE objective than one "
            "full-batch step — if you wanted more negatives, raise the "
            "batch size or shard the loss over more chips instead. "
            "(See the make_train_step docstring.)",
            stacklevel=2)

    def forward_backward(text, image, generator, keep_idx, valid, **kw):
        loss, metrics = model(text, image, return_loss=True,
                              return_metrics=True, generator=generator,
                              keep_idx=keep_idx, row_valid=valid,
                              axis_name=axis_name, **kw)
        loss.backward()
        bn = metrics.pop("bn_updates", None)
        return {k: v.detach() for k, v in metrics.items()}, bn

    def step(text, image, generator=None, keep_idx=None, valid=None, *,
             aug_text=None, aug_image=None, mlm_draws=None, ssl_draws=None):
        optimizer.zero_grad(set_to_none=True)
        if share is not None:
            _share_draws(generator if generator is not None else getattr(
                model, "call_generator", None), share, text.device)
        if grad_accum == 1:
            metrics, bn = forward_backward(
                text, image, generator, keep_idx, valid, aug_text=aug_text,
                aug_image=aug_image, mlm_draws=mlm_draws,
                ssl_draws=ssl_draws)
        else:   # JAX's assertions, in its words
            if valid is not None:
                raise AssertionError(
                    "pad-and-mask (valid=) is not supported with grad_accum "
                    "> 1: a microbatch could end up fully padded (0/0 loss)."
                    " Drop the final short batch instead.")
            if text.shape[0] % grad_accum:
                raise AssertionError(
                    f"batch size {text.shape[0]} must divide evenly into "
                    f"grad_accum={grad_accum} microbatches (no silent drops)")
            mb = text.shape[0] // grad_accum
            metrics = None
            for i in range(grad_accum):
                rows = slice(i * mb, (i + 1) * mb)

                def part(views):
                    return None if views is None else tuple(
                        v[rows] for v in cast_tuple(views))

                # the last microbatch's BatchNorm statistics are kept
                m, bn = forward_backward(
                    text[rows], image[rows], generator,
                    None if keep_idx is None else keep_idx[rows], None,
                    aug_text=part(aug_text), aug_image=part(aug_image),
                    mlm_draws=None if mlm_draws is None else mlm_draws[i],
                    ssl_draws=None if ssl_draws is None else ssl_draws[i])
                metrics = m if metrics is None else {
                    k: metrics[k] + v for k, v in m.items()}
        grads = [p.grad for g in optimizer.param_groups
                 for p in g["params"] if p.grad is not None]
        if reduce_over is not None:
            all_reduce_sum_(grads, reduce_over)
        if grad_accum > 1:
            torch._foreach_div_(grads, grad_accum)
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        metrics["grad_norm"] = optimizer.step()
        if bn is not None:
            getattr(model, "model", model).fold_bn_updates(bn)
        return metrics

    return step
