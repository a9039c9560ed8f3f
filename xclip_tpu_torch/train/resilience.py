"""Failure detection and checkpoint-and-restart recovery — the counterpart
of `xclip_tpu/train/resilience.py`:

  * `CheckpointManager` — step-numbered checkpoints `<dir>/step_<N>`
    (`checkpoint.save_checkpoint`) with retention, a loader-state JSON
    sidecar, and the cleanup of what an interrupted save leaves.
  * `run_with_recovery(train_chunk, ...)` — in-process recovery from
    transient device failures: restore the latest checkpoint and replay.
  * `supervise(argv)` — relaunch a training command on a nonzero exit,
    with backoff: the recovery for a lost device, where the fresh process
    starts the runtime anew and resumes with `restore_latest`.

The model and optimizer are restored in place, as PyTorch keeps its state
in them.
"""

from __future__ import annotations

import copy
import json
import os
import re
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

import torch

from .checkpoint import restore_checkpoint, save_checkpoint


class CheckpointManager:
    """Step-numbered checkpoints under one directory: `<dir>/step_<N>`.

    Keeps the newest `keep`. A save is atomic (a temporary file moved into
    place), so `restore_latest` only ever sees complete checkpoints; a
    temporary file left by an interrupted save is removed by the next save
    of another step.
    """

    def __init__(self, directory: str, *, keep: int = 3):
        if keep < 1:
            # keep=0 would mean "delete everything just saved"; the slice
            # [:-0] == [:0] would instead silently keep everything
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_files(self) -> List[tuple]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        files = self._step_files()
        return files[-1][0] if files else None

    def save(self, step: int, model, optimizer=None, *,
             loader_state: Optional[dict] = None) -> str:
        """`loader_state`: the `'loader_state'` dict of the last batch
        consumed, kept as a JSON sidecar so that a restart resumes the data
        order where it left off (`loader_state()` reads it back)."""
        path = os.path.join(self.directory, f"step_{step}")
        save_checkpoint(path, model, optimizer, step)
        if loader_state is not None:
            tmp = path + ".loader.json.tmp"
            with open(tmp, "w") as f:
                json.dump(loader_state, f)
            os.replace(tmp, path + ".loader.json")   # atomic like the save
        for _, old in self._step_files()[: -self.keep]:
            for stale in (old, old + ".loader.json"):
                try:
                    os.remove(stale)
                except FileNotFoundError:
                    pass
        # what interrupted saves of other steps left behind
        for name in os.listdir(self.directory):
            if (name.startswith("step_") and name.endswith(".tmp")
                    and not name.startswith(f"step_{step}.")):
                try:
                    os.remove(os.path.join(self.directory, name))
                except FileNotFoundError:
                    pass
        return path

    def restore_latest(self, model, optimizer=None) -> Optional[int]:
        """Restore the newest checkpoint into `model` (and `optimizer`) in
        place and return its step; None, touching nothing, when there is
        none yet."""
        files = self._step_files()
        if not files:
            return None
        restore_checkpoint(files[-1][1], model, optimizer)
        return files[-1][0]

    def loader_state(self, step: Optional[int] = None) -> Optional[dict]:
        """The data-order state saved with `step` (the latest when None);
        None when that checkpoint carried none."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        sidecar = os.path.join(self.directory, f"step_{step}.loader.json")
        if not os.path.exists(sidecar):
            return None
        with open(sidecar) as f:
            return json.load(f)


def _default_is_transient(e: Exception) -> bool:
    """Failures worth an in-process retry: the device runtime's errors
    (`torch.AcceleratorError`, out of device memory), never a Python
    bug."""
    return isinstance(e, (torch.AcceleratorError,
                          torch.cuda.OutOfMemoryError))


def run_with_recovery(train_chunk: Callable[[int, int], None],
                      manager: CheckpointManager, model, optimizer=None, *,
                      total_steps: int, checkpoint_every: int,
                      max_restarts: int = 3,
                      is_transient: Callable[[Exception], bool] = None):
    """Drive `train_chunk(start_step, end_step)`, which trains `model` and
    `optimizer` in place over those steps, in checkpointed chunks; on a
    transient device failure, restore the latest checkpoint (or the state
    this call started from) and replay from there, at most `max_restarts`
    times. The chunk bounds are explicit so that the last, possibly short,
    chunk runs exactly its steps and each saved step number is the steps
    taken. For an exact replay `train_chunk` must be deterministic given
    its bounds: seed its generators from the step."""
    is_transient = is_transient or _default_is_transient
    step = manager.restore_latest(model, optimizer)
    initial = None
    if step is None:
        step = 0
        initial = copy.deepcopy(
            (model.state_dict(),
             None if optimizer is None else optimizer.state_dict()))
    restarts = 0
    while step < total_steps:
        chunk_end = min(step + checkpoint_every, total_steps)
        try:
            train_chunk(step, chunk_end)
        except Exception as e:
            if restarts >= max_restarts or not is_transient(e):
                raise
            restarts += 1
            step = manager.restore_latest(model, optimizer)
            if step is None:
                step = 0
                model.load_state_dict(initial[0])
                if optimizer is not None:
                    optimizer.load_state_dict(initial[1])
            continue
        step = chunk_end
        manager.save(step, model, optimizer)


def supervise(argv: Sequence[str], *, max_restarts: int = 3,
              backoff_seconds: float = 1.0) -> int:
    """Run `argv`; relaunch it on a nonzero exit with exponential backoff,
    at most `max_restarts` times. Returns the last exit code."""
    attempt = 0
    while True:
        code = subprocess.call(list(argv))
        if code == 0 or attempt >= max_restarts:
            return code
        attempt += 1
        delay = backoff_seconds * (2 ** (attempt - 1))
        print(f"[resilience] training exited {code}; restart {attempt}/"
              f"{max_restarts} in {delay:.1f}s", file=sys.stderr)
        time.sleep(delay)
