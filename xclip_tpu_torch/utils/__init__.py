"""Small numeric helpers and the debugging and profiling hooks — the
counterparts of `xclip_tpu/utils/`."""

from __future__ import annotations

import torch

from .debug import assert_finite, debug_nans  # noqa: F401
from .profiling import annotate, step_timer, trace  # noqa: F401


def cast_tuple(t):
    return t if isinstance(t, (tuple, list)) else (t,)


def masked_mean(t, mask, dim: int = 1, eps: float = 1e-6):
    """Mean over `dim` counting only positions where `mask` is True; the
    denominator is clamped to `eps`."""
    t = torch.where(mask, t, 0.0)
    return t.sum(dim=dim) / mask.sum(dim=dim).clamp(min=eps)


def l2norm(t):
    """L2-normalise the last axis; the norm is clamped to 1e-12."""
    norm = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    return t / norm.clamp(min=1e-12)
