"""The multi-rank dry run — the counterpart of `__graft_entry__.py`'s
`dryrun_multichip`: one training step (optimizer included) of tiny models
over a real (data, model) mesh of ranks, one stage per risky
configuration, each printing a line as it passes.

`dryrun_multichip(n, device="cuda")` starts `n` rank processes (this
module with `--rank`): NCCL on the card, one rank a device (`n` past
`torch.cuda.device_count()` raises `ValueError`; nothing falls back to
the CPU), or gloo CPU ranks with `device="cpu"`. They join through a file
store in a temporary directory (no TCP port); a rank still running after
`timeout` seconds is killed, and any rank's failure raises. It builds
JAX's meshes (the dp × tp mesh, (n/2, 2) when n is even, else (n, 1); the
data mesh; the 2-rank dp and tp submeshes) and runs JAX's nine stages in
order under JAX's names:

  1. the full train step on the dp × tp mesh;
  2. MLM + SimCLR through a train step on the dp submesh;
  3. the same with `grad_accum=2`;
  4. that model's loss, row-sharded over the data mesh (`axis_name`);
  5. FILIP with the extra heads and DCL, row-sharded;
  6. K5's loss (`loss_impl='fused'`), row-sharded;
  7. the rotary causal-EOS text tower, row-sharded;
  8. the stored kernels (`attn_impl='fused'`, `ff_impl='block_stored'`:
     K2, K1) through a train step on the tp submesh;
  9. the memory-lean kernels (`'fused_recompute'`, `'block'`, K5's loss:
     K3, K-FF-s, K5) through a train step on the dp submesh.
Each stage's loss must be finite; the last line is JAX's
`dryrun_multichip(n) ok: mesh=... <stage>=<loss> ...`. A rank outside a
submesh skips its stage. On the card each rank counts its kernels'
launches in each stage; `dryrun_multichip` returns rank 0's losses and
counts. On the CPU every route runs its plain version.

    python -m xclip_tpu_torch.dryrun N [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

# the smallest config that still exercises real attention / FF / pooling
# shapes (4 patches + CLS, 16 text tokens, 2 heads), JAX's `_TINY`
TINY = dict(
    dim_text=64, dim_image=64, dim_latent=64, num_text_tokens=128,
    text_enc_depth=1, text_seq_len=16, text_heads=2, text_dim_head=16,
    visual_enc_depth=1, visual_heads=2, visual_dim_head=16,
    visual_image_size=16, visual_patch_size=8)
COLLECTIVE_TIMEOUT = 300


def _kernel_counters():
    """{kernel: [its wrappers' launch counters]} of the kernels the stages
    run on the card."""
    from .kernels import attention_megablock as mega
    from .kernels import fused_ff_block as ffb
    from .kernels import fused_infonce as lse5
    return {
        "K5": [lse5.streaming_lse_fwd, lse5.streaming_lse_bwd],
        "K2": [mega.attention_block_fwd_stored, mega.attention_block_bwd],
        "K1": [ffb.ff_block_fwd_stored, ffb.ff_block_bwd_p1,
               ffb.ff_block_bwd_p2],
        "K3": [mega.attention_block_fwd_stats,
               mega.attention_block_bwd_recompute],
        "K-FF-s": [ffb.ff_block_fwd_stats, ffb.ff_block_bwd_recompute]}


def _stages(n, device):
    """This rank's run of the nine stages → {"mesh": repr of the dp × tp
    mesh's shape, "losses": {stage: loss}, "launches": {stage: {kernel:
    launches}}} (losses of the stages this rank took part in)."""
    from . import CLIP
    from .parallel import create_mesh
    from .train import (default_optimizer, make_train_step, shard_batch,
                        shard_state)
    rank = dist.get_rank()
    counters = _kernel_counters()
    if n % 2 == 0 and n > 1:
        mesh = create_mesh((n // 2, 2))
    else:
        mesh = create_mesh((n, 1))
    data_mesh = create_mesh((n,), axis_names=("data",))
    n_sub = 2 if n >= 2 else 1
    dp_sub = create_mesh((n_sub, 1), devices=range(n_sub))
    tp_sub = create_mesh((1, 2), devices=range(2)) if n >= 2 else dp_sub

    per_host_batch = max(n, 4)
    npr = np.random.RandomState(0)
    text_g = torch.from_numpy(npr.randint(1, 128, (per_host_batch, 16)))
    image_g = torch.from_numpy(
        npr.randn(per_host_batch, 3, 16, 16).astype(np.float32))
    t0 = time.time()
    out = {"mesh": repr(mesh.shape), "losses": {}, "launches": {}}

    def stage(name, run):
        for kernels in counters.values():
            for c in kernels:
                c.launches = 0
        loss = run()
        if loss is not None:
            loss = float(loss)
            if not math.isfinite(loss):
                raise AssertionError(f"non-finite {name} loss: {loss}")
            out["losses"][name] = loss
            out["launches"][name] = {
                k: sum(c.launches for c in cs) for k, cs in counters.items()
                if any(c.launches for c in cs)}
        dist.barrier()
        if rank == 0:
            launched = " ".join(f"{k}={v}" for k, v in
                                out["launches"][name].items())
            print(f"[dryrun +{time.time() - t0:5.1f}s] {name}: "
                  f"loss={loss:.4f}" + (f" launches {launched}"
                                        if launched else ""), flush=True)

    def run_step(config, seed, step_mesh, **step_kw):
        """init → shard over `step_mesh` → one full train step."""
        if not step_mesh.member:
            return None
        clip = CLIP(**config, device=device, seed=seed)
        optimizer = default_optimizer(clip.parameters(), learning_rate=1e-3)
        shard_state(clip, optimizer, step_mesh)
        text, image = shard_batch((text_g.to(device), image_g.to(device)),
                                  step_mesh)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # grad_accum's warning
            step = make_train_step(clip, optimizer, mesh=step_mesh,
                                   **step_kw)
        metrics = step(text, image)
        if optimizer.count != 1:
            raise AssertionError(f"{optimizer.count} optimizer steps")
        return metrics["loss"]

    def sharded_loss(config, seed, eos_id=None):
        """The row-sharded loss with gathered columns over the data mesh
        (the 32k-global-batch mode)."""
        rs = np.random.RandomState(seed)
        text = rs.randint(1, 127, (n * 2, 16))
        if eos_id is not None:   # the causal-text EOS contract
            text[:, -2] = eos_id
        image = rs.randn(n * 2, 3, 16, 16).astype(np.float32)
        clip = CLIP(**config, device=device, seed=seed)
        text, image = shard_batch((torch.from_numpy(text).to(device),
                                   torch.from_numpy(image).to(device)),
                                  data_mesh)
        with torch.no_grad():
            return clip(text, image, return_loss=True,
                        axis_name=data_mesh.group("data"))

    data, model = mesh.shape["data"], mesh.shape["model"]
    aux = dict(TINY, visual_patch_dropout=0.5, use_mlm=True,
               use_visual_ssl=True, visual_ssl_type="simclr")
    stage(f"full_train_step(dp{data}xtp{model})", lambda: run_step(
        dict(TINY, visual_patch_dropout=0.5), 0, mesh))
    stage("aux_train_step(dp2)", lambda: run_step(aux, 2, dp_sub))
    stage("grad_accum2_train_step", lambda: run_step(aux, 4, dp_sub,
                                                     grad_accum=2))
    stage("shard_map_replicated_loss", lambda: sharded_loss(aux, 6))
    stage("filip_sharded_loss", lambda: sharded_loss(dict(
        TINY, visual_patch_dropout=0.0, use_all_token_embeds=True,
        extra_latent_projection=True, decoupled_contrastive_learning=True),
        7))
    stage("fused_loss_sharded", lambda: sharded_loss(dict(
        TINY, visual_patch_dropout=0.0, loss_impl="fused"), 8))
    stage("rotary_causal_sharded", lambda: sharded_loss(dict(
        TINY, visual_patch_dropout=0.0, text_rotary_pos_emb=True,
        text_causal_mask=True, text_eos_id=127), 9, eos_id=127))
    stage("pallas_kernels_train_step(tp2)", lambda: run_step(dict(
        TINY, visual_patch_dropout=0.5, attn_impl="fused",
        ff_impl="block_stored"), 10, tp_sub))
    stage("memory_lean_train_step", lambda: run_step(dict(
        TINY, visual_patch_dropout=0.5, attn_impl="fused_recompute",
        ff_impl="block", loss_impl="fused"), 12, dp_sub))
    return out


def _rank_main(rank, n, device, work_dir):
    """One rank: join the group, run the stages, leave its result (or its
    traceback) in `work_dir`."""
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=f"file://{os.path.join(work_dir, 'store')}",
        rank=rank, world_size=n,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT))
    try:
        result = _stages(n, f"cuda:{rank}" if device == "cuda" else "cpu")
    except Exception:
        result = {"error": traceback.format_exc()}
    path = os.path.join(work_dir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)   # whole, or not there
    if "error" not in result:
        dist.destroy_process_group()


def _result(work_dir, rank, returncode):
    """What an exited rank left: its result, or {"error": why}."""
    path = os.path.join(work_dir, f"rank{rank}.pkl")
    if not os.path.exists(path):
        return {"error": f"exit code {returncode}, no result"}
    with open(path, "rb") as f:
        return pickle.load(f)


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 600.0) -> dict:
    """Run the nine stages on `n_devices` ranks (see the module docstring)
    and print JAX's last line; returns rank 0's {"mesh", "losses",
    "launches"}."""
    if device == "cuda":
        have = torch.cuda.device_count()
        if n_devices > have:
            raise ValueError(
                f"dryrun_multichip({n_devices}) needs {n_devices} CUDA "
                f"devices, one a rank (NCCL), and this machine has {have}; "
                "pass device='cpu' for gloo CPU ranks")
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    work_dir = tempfile.mkdtemp(prefix="xclip_dryrun_")
    # the ranks import this package from where this process found it
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])]))
    procs = []
    try:
        for r in range(n_devices):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "xclip_tpu_torch.dryrun",
                 str(n_devices), "--device", device, "--rank", str(r),
                 "--work-dir", work_dir], env=env))
        results = {}
        deadline = time.monotonic() + timeout
        # until every rank is done, or one has failed (the others would
        # wait for it in a collective), or the time is up
        while len(results) < n_devices and time.monotonic() < deadline:
            for r, p in enumerate(procs):
                if r not in results and p.poll() is not None:
                    results[r] = _result(work_dir, r, p.returncode)
            if any("error" in res for res in results.values()):
                break
            time.sleep(0.1)
        for r, res in sorted(results.items()):
            if "error" in res:
                raise RuntimeError(f"dryrun rank {r} failed:\n{res['error']}")
        if len(results) < n_devices:
            raise RuntimeError(
                f"dryrun ranks {sorted(set(range(n_devices)) - set(results))}"
                f" were still running after {timeout:.0f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work_dir, ignore_errors=True)
    out = results[0]
    summary = " ".join(f"{k}={v:.4f}" for k, v in out["losses"].items())
    print(f"dryrun_multichip({n_devices}) ok: mesh={out['mesh']} "
          f"{summary}", flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="one train step of tiny models over a mesh of ranks, "
                    "stage by stage (JAX's dryrun_multichip)")
    parser.add_argument("n", type=int, nargs="?", default=8)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--timeout", type=float, default=600.0)
    # a rank process, as dryrun_multichip starts it
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--work-dir", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.n, args.device, args.work_dir)
    else:
        dryrun_multichip(args.n, device=args.device, timeout=args.timeout)


if __name__ == "__main__":
    main()
