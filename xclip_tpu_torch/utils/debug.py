"""Numerics-debugging hooks — the counterparts of `xclip_tpu/utils/debug.py`:

  * `debug_nans(enable=True)` — a context manager turning on autograd's
    anomaly mode (`torch.autograd.set_detect_anomaly`): a backward that
    produces a NaN raises, naming the forward operation it came from.
  * `assert_finite(tree, name)` — checks every floating tensor of a module
    (its parameters and buffers) or of a nested dict of tensors (gradients,
    metrics) on the host; raises listing each non-finite one by its path.
"""

from __future__ import annotations

import torch
from torch import nn


def debug_nans(enable: bool = True):
    return torch.autograd.set_detect_anomaly(enable)


def _leaves(tree, prefix=""):
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    for key, value in tree.items():
        path = f"{prefix}{key}".replace(".", "/")
        if isinstance(value, dict):
            yield from _leaves(value, path + "/")
        else:
            yield path, value


def assert_finite(tree, name: str = "tree") -> None:
    bad = [path for path, x in _leaves(tree)
           if torch.is_tensor(x) and x.is_floating_point()
           and not bool(torch.isfinite(x).all())]
    if bad:
        raise FloatingPointError(
            f"{name} contains non-finite values at: {', '.join(bad)}")
