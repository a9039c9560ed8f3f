"""Training metrics to a JSON-lines file and the console — the counterpart
of `xclip_tpu/train/logging.py`. The train step returns its metrics as
0-d tensors on the device; `MetricsLogger` stages them and fetches a whole
window of steps with one host sync per flush (every `flush_every` steps),
so logging does not stall the device queue each step.
"""

from __future__ import annotations

import json
import numbers
import sys
import time
from typing import IO, Optional

import torch


def _is_scalar(v) -> bool:
    return (isinstance(v, numbers.Number)
            or (torch.is_tensor(v) and v.ndim == 0))


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, *, flush_every: int = 20,
                 print_to: Optional[IO] = sys.stderr):
        self._file = open(path, "a") if path else None
        self._flush_every = max(1, flush_every)
        self._print_to = print_to
        self._staged: list = []
        self._started = False
        self._t0 = time.perf_counter()

    def log(self, step: int, metrics: dict, batch_size: Optional[int] = None):
        """Stage one step's scalar metrics (tensors are not fetched here)."""
        scalars = {k: v for k, v in metrics.items() if _is_scalar(v)}
        if not self._started:
            self._started = True
            self._t0 = time.perf_counter()   # exclude build and set-up time
        self._staged.append((step, scalars, batch_size))
        if len(self._staged) >= self._flush_every:
            self.flush()

    def flush(self):
        if not self._staged:
            return
        staged, self._staged = self._staged, []
        values = [v for _, scalars, _ in staged for v in scalars.values()]
        device = next((v.device for v in values if torch.is_tensor(v)),
                      torch.device("cpu"))
        # one copy to the host for the whole window
        fetched = iter(torch.stack([
            torch.as_tensor(v, device=device).float() for v in values
        ]).tolist() if values else [])
        records = [(step, {k: next(fetched) for k in scalars}, b)
                   for step, scalars, b in staged]
        now = time.perf_counter()
        elapsed, self._t0 = now - self._t0, now
        pairs = sum(b for _, _, b in records if b)
        if self._file:
            for step, scalars, _ in records:
                self._file.write(json.dumps({"step": step, **scalars}) + "\n")
            self._file.flush()
        if self._print_to is not None:
            step, scalars, _ = records[-1]
            line = (f"step {step:6d}  "
                    + "  ".join(f"{k} {v:.4f}"
                                for k, v in sorted(scalars.items())
                                if k in ("loss", "cl_loss", "grad_norm")))
            if pairs and elapsed > 0:
                line += f"  [{pairs / elapsed:.0f} pairs/s]"
            print(line, file=self._print_to)

    def close(self):
        self.flush()
        if self._file:
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
