"""The train step — the counterpart of `xclip_tpu/train/trainer.py`'s
`make_train_step` and `default_optimizer`.

`default_optimizer` is optax's chain `clip_by_global_norm(max_grad_norm)`
→ `adamw(schedule, b1, b2, eps=1e-8, weight_decay)` written out in
PyTorch, operation for operation:
  * the global norm is sqrt(Σ_leaves Σ g²) (here in fp32, from the
    per-tensor norms), and the clip scales by max_norm / norm only when
    norm ≥ max_norm (`clip_by_global_norm`; `torch.nn.utils.
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
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import torch


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
    `step()` returns the global gradient norm before the clip."""

    def __init__(self, params, learning_rate=3e-4, weight_decay=0.2,
                 b1=0.9, b2=0.98, eps=1e-8, max_grad_norm=1.0,
                 warmup_steps=0, total_steps=None):
        super().__init__(params, dict(
            learning_rate=learning_rate, weight_decay=weight_decay, b1=b1,
            b2=b2, eps=eps, warmup_steps=warmup_steps,
            total_steps=total_steps))
        self.max_grad_norm = max_grad_norm
        self.count = 0

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
        # the global norm, taken in fp32 from the per-tensor norms
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)).float())
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


def make_train_step(model, optimizer, *, grad_accum: int = 1):
    """Returns `step(text, image, generator=None, keep_idx=None, valid=None)
    -> metrics`: the forward with the contrastive loss and its backward
    (once, or once a microbatch), and one optimizer update of `model` (a
    `CLIP` or a `CLIPModel`) in place. `generator` feeds the patch dropout
    and any encoder dropout (default: the `CLIP`'s call generator; a
    microbatch draws after the one before it), `keep_idx` injects the
    patch indices (a microbatch takes its rows); `valid` (b,) bool marks
    the rows of a padded short batch that count."""
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

    def forward_backward(text, image, generator, keep_idx, valid):
        loss, metrics = model(text, image, return_loss=True,
                              return_metrics=True, generator=generator,
                              keep_idx=keep_idx, row_valid=valid)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def step(text, image, generator=None, keep_idx=None, valid=None):
        optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            metrics = forward_backward(text, image, generator, keep_idx,
                                       valid)
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
                m = forward_backward(
                    text[rows], image[rows], generator,
                    None if keep_idx is None else keep_idx[rows], None)
                metrics = m if metrics is None else {
                    k: metrics[k] + v for k, v in m.items()}
            grads = [p.grad for g in optimizer.param_groups
                     for p in g["params"] if p.grad is not None]
            torch._foreach_div_(grads, grad_accum)
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        metrics["grad_norm"] = optimizer.step()
        return metrics

    return step
