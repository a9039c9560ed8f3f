"""Tracing and timing hooks — the counterparts of
`xclip_tpu/utils/profiling.py`:

  * `trace(logdir)` — a context manager around `torch.profiler.profile`
    (the host, and the card when there is one) that writes a Chrome trace
    of everything run inside to `<logdir>/trace.json` (chrome://tracing,
    Perfetto).
  * `annotate(name)` — `torch.profiler.record_function`: the operations
    inside group under `name` in a trace.
  * `step_timer(fn)` — wraps a step function to return (result, seconds),
    the card synchronised before the clock is read; one sync a call, so
    for quick checks, not for a tight loop.

Nothing here runs unless asked for.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def annotate(name: str):
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _synchronize():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def step_timer(fn):
    def timed(*args, **kwargs):
        _synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _synchronize()
        return out, time.perf_counter() - t0
    return timed
