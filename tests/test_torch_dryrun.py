"""The port's `dryrun_multichip` (`xclip_tpu_torch/dryrun.py`) on four gloo
CPU ranks, as `python -m xclip_tpu_torch.dryrun 4 --device cpu` runs it:
JAX's nine stages in order under JAX's names (`__graft_entry__.py`), each
with a finite loss, and JAX's last line with JAX's mesh; the parent
imports no JAX. On the card it refuses more ranks than devices."""

import math
import re
import subprocess
import sys

import jax
import pytest
import torch

from xclip_tpu.parallel import create_mesh

from xclip_tpu_torch.dryrun import dryrun_multichip
import torch_one_thread  # noqa: F401

# `__graft_entry__.py:242-292`, on a (2, 2) mesh
STAGES = ["full_train_step(dp2xtp2)", "aux_train_step(dp2)",
          "grad_accum2_train_step", "shard_map_replicated_loss",
          "filip_sharded_loss", "fused_loss_sharded",
          "rotary_causal_sharded", "pallas_kernels_train_step(tp2)",
          "memory_lean_train_step"]
CODE = ("import sys; from xclip_tpu_torch.dryrun import main; main(); "
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'xclip_tpu')]")


@pytest.fixture(scope="module")
def dryrun():
    return subprocess.run(
        [sys.executable, "-c", CODE, "4", "--device", "cpu",
         "--timeout", "400"], capture_output=True, text=True, timeout=450)


def test_dryrun_runs_jax_s_nine_stages(dryrun):
    assert dryrun.returncode == 0, dryrun.stderr[-3000:]
    lines = dryrun.stdout.strip().splitlines()
    progress = [re.fullmatch(r"\[dryrun \+ *[\d.]+s\] (\S+): loss=(\S+)", ln)
                for ln in lines[:-1]]
    assert all(progress), lines
    assert [m.group(1) for m in progress] == STAGES
    losses = [float(m.group(2)) for m in progress]
    assert all(math.isfinite(v) for v in losses)
    mesh = create_mesh((2, 2), devices=jax.devices()[:4])
    summary = " ".join(f"{k}={v:.4f}" for k, v in zip(STAGES, losses))
    assert lines[-1] == (f"dryrun_multichip(4) ok: mesh={mesh.shape} "
                         f"{summary}")


def test_dryrun_refuses_more_ranks_than_cards():
    with pytest.raises(ValueError, match="CUDA devices"):
        dryrun_multichip(torch.cuda.device_count() + 1, device="cuda")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        dryrun_multichip(1, device="tpu")
