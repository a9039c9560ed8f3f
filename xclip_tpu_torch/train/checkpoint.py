"""Checkpoint and resume of a training run — the counterpart of
`xclip_tpu/train/checkpoint.py`, through `torch.save` / `torch.load`.

A checkpoint holds what JAX's `TrainState` holds: the parameters (the
model's `state_dict()`, with the SSL heads' BatchNorm running statistics,
which JAX keeps among its parameters), the optimizer's state (`AdamW.state_dict()`, its
step count included) and the step. It holds no generator state, as JAX's
holds no key. A save is atomic, as Orbax's is: the file is written under a
temporary name and moved into place with `os.replace`, so a kill during a
save leaves the previous checkpoint as it was.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def save_checkpoint(path: str, model, optimizer=None,
                    step: Optional[int] = None) -> None:
    """Write `model`'s parameters, `optimizer`'s state and `step` to
    `path`."""
    state = {"model": model.state_dict(), "step": step,
             "optimizer": (None if optimizer is None
                           else optimizer.state_dict())}
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, model, optimizer=None) -> Optional[int]:
    """Load a checkpoint written by `save_checkpoint` into `model` (and
    `optimizer`) in place, its tensors mapped to the model's device; returns
    the saved step."""
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return state["step"]
