"""Checkpoints and recovery on the CPU: `train.checkpoint`, `CLIP.save` /
`load`, and `train.resilience` (`CheckpointManager`, `run_with_recovery`,
`supervise`), mirroring `tests/test_resilience.py`.

A resumed run is held bit for bit to the uninterrupted one: save → load →
step gives the same parameters, Adam moments, step count and metrics; the
optimizer's step count rides the checkpoint, so the warmup schedule goes
on where it was. A JAX param tree carried across by `convert`'s numpy maps
and saved comes back as it went in.
"""

import os
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import xclip_tpu_torch
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree
from xclip_tpu_torch.train import (CheckpointManager, default_optimizer,
                                   make_train_step, restore_checkpoint,
                                   run_with_recovery, save_checkpoint,
                                   supervise, warmup_cosine_lr)

from test_torch_train import TINY, _inputs

SCHED = dict(learning_rate=1e-3, warmup_steps=3, total_steps=8)


def _model(seed=0, **flags):
    return xclip_tpu_torch.CLIP(**TINY, device="cpu", seed=seed, **flags)


def _batch(i):
    text, image = map(torch.from_numpy, _inputs(b=2, seed=i))
    return text, image, torch.Generator().manual_seed(100 + i)


def _state(model, opt):
    return ({k: v.clone() for k, v in model.state_dict().items()},
            opt.state_dict())


def _assert_same(a, b):
    (pa, oa), (pb, ob) = a, b
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert oa["count"] == ob["count"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for m in ("mu", "nu"):
            assert oa["state"][i][m].dtype == ob["state"][i][m].dtype, (i, m)
            assert torch.equal(oa["state"][i][m], ob["state"][i][m]), (i, m)


@pytest.mark.parametrize("flags", [
    {}, dict(param_dtype=torch.bfloat16, compute_dtype="bfloat16")],
    ids=["fp32", "bf16"])
def test_resume_is_bit_equal_to_the_uninterrupted_run(tmp_path, flags):
    """bf16: the 0-d temperature's moments are fp32 (its clipped gradient
    is) and come back fp32."""
    model = _model(**flags)
    opt = default_optimizer(model.parameters(), **SCHED)
    step = make_train_step(model, opt)
    for i in range(2):
        step(*_batch(i)[:2], generator=_batch(i)[2])
    save_checkpoint(str(tmp_path / "ck"), model, opt, step=2)
    want = step(*_batch(2)[:2], generator=_batch(2)[2])
    want_state = _state(model, opt)

    fresh = _model(seed=1, **flags)
    fresh_opt = default_optimizer(fresh.parameters(), **SCHED)
    assert restore_checkpoint(str(tmp_path / "ck"), fresh, fresh_opt) == 2
    assert fresh_opt.count == 2
    got = make_train_step(fresh, fresh_opt)(*_batch(2)[:2],
                                            generator=_batch(2)[2])
    _assert_same(_state(fresh, fresh_opt), want_state)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_adamw_count_rides_the_state_dict():
    """The step count is in `state_dict()`; a restored optimizer's learning
    rate is the warmup schedule's at that count, not its start."""
    model = _model()
    opt = default_optimizer(model.parameters(), **SCHED)
    step = make_train_step(model, opt)
    for i in range(2):
        step(*_batch(i)[:2], generator=_batch(i)[2])
    sd = opt.state_dict()
    assert sd["count"] == 2
    fresh = default_optimizer(_model(1).parameters(), **SCHED)
    assert fresh.lr(fresh.param_groups[0]) == 0.0
    fresh.load_state_dict(sd)
    assert fresh.count == 2
    assert fresh.lr(fresh.param_groups[0]) == warmup_cosine_lr(2, **SCHED)
    assert fresh.lr(fresh.param_groups[0]) == opt.lr(opt.param_groups[0]) > 0


def test_jax_tree_saved_and_loaded_is_unchanged(tmp_path):
    """A JAX param tree (`numpy_params`, the layout of `xclip_tpu`'s
    `CLIP.params`) loaded into the port, kept by `CLIP.save` and brought
    back by `CLIP.load` into another model is the tree that went in."""
    tree = numpy_params(TINY, 3)
    model = _model()
    load_jax_params(model, tree)
    model.save(str(tmp_path / "params"))
    other = _model(seed=2)
    other.load(str(tmp_path / "params"))
    got = jax.tree_util.tree_leaves_with_path(to_jax_tree(other))
    want = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(leaf, want[path], err_msg=str(path))


def _tiny_step(model, opt):
    step = make_train_step(model, opt)

    def chunk(start, end):
        for s in range(start, end):
            text, image, _ = _batch(s % 3)
            step(text, image, generator=torch.Generator().manual_seed(s))
    return chunk


def test_checkpoint_manager_retention_and_sidecar(tmp_path):
    model = _model()
    opt = default_optimizer(model.parameters())
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    assert mgr.latest_step() is None and mgr.loader_state() is None
    # what an interrupted save of another step leaves is ignored, then
    # cleaned by the next save
    (tmp_path / "ck" / "step_3.tmp").write_bytes(b"partial")
    assert mgr.latest_step() is None
    for s in (5, 10, 15):
        with torch.no_grad():
            model.temperature.fill_(float(s))
        mgr.save(s, model, opt,
                 loader_state={"epoch": s // 10, "batch_index": s})
    assert sorted(os.listdir(mgr.directory)) == [
        "step_10", "step_10.loader.json", "step_15", "step_15.loader.json"]
    assert mgr.loader_state() == {"epoch": 1, "batch_index": 15}
    assert mgr.loader_state(10) == {"epoch": 1, "batch_index": 10}
    fresh = _model(seed=1)
    assert mgr.restore_latest(fresh) == 15
    assert fresh.temperature.item() == 15.0
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path / "ck2"), keep=0)


def test_run_with_recovery_replays_a_transient_failure(tmp_path):
    """A chunk that dies with a device error (twice, one of them before the
    first checkpoint) is replayed from the last checkpoint, or from the
    start, and ends in the uninterrupted run's state; the last short chunk
    runs exactly its steps."""
    clean = _model()
    clean_opt = default_optimizer(clean.parameters(), **SCHED)
    run_with_recovery(_tiny_step(clean, clean_opt),
                      CheckpointManager(str(tmp_path / "clean")), clean,
                      clean_opt, total_steps=7, checkpoint_every=3)

    model = _model()
    opt = default_optimizer(model.parameters(), **SCHED)
    chunk = _tiny_step(model, opt)
    failures = {1: 1, 4: 1}

    def flaky(start, end):
        for s in range(start, end):
            chunk(s, s + 1)
            if failures.get(s):
                failures[s] -= 1
                raise torch.AcceleratorError("fake device failure")

    mgr = CheckpointManager(str(tmp_path / "ck"))
    run_with_recovery(flaky, mgr, model, opt, total_steps=7,
                      checkpoint_every=3, max_restarts=2)
    assert mgr.latest_step() == 7 and opt.count == 7
    _assert_same(_state(model, opt), _state(clean, clean_opt))


def test_run_with_recovery_reraises_a_python_bug(tmp_path):
    model = _model()

    def chunk(start, end):
        raise ValueError("a Python bug, not a device failure")

    with pytest.raises(ValueError):
        run_with_recovery(chunk, CheckpointManager(str(tmp_path / "ck")),
                          model, total_steps=5, checkpoint_every=5)


_CRASHY_TRAINER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import torch
    from xclip_tpu_torch import CLIP
    from xclip_tpu_torch.train import (CheckpointManager, default_optimizer,
                                       make_train_step)

    ckpt_dir, crash_flag = sys.argv[1], sys.argv[2]
    model = CLIP(dim_text=32, dim_image=32, dim_latent=32,
                 num_text_tokens=50, text_enc_depth=1, text_seq_len=8,
                 text_heads=1, visual_enc_depth=1, visual_heads=1,
                 visual_image_size=16, visual_patch_size=8, device="cpu")
    opt = default_optimizer(model.parameters(), learning_rate=1e-2)
    step_fn = make_train_step(model, opt)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    step = mgr.restore_latest(model, opt) or 0
    g = torch.Generator().manual_seed(0)
    text = torch.randint(1, 50, (2, 8), generator=g)
    image = torch.randn(2, 3, 16, 16, generator=g)
    TOTAL, EVERY = 6, 2
    while step < TOTAL:
        for s in range(step, step + EVERY):
            step_fn(text, image, generator=torch.Generator().manual_seed(s))
            if s == 3 and os.path.exists(crash_flag):
                os.remove(crash_flag)     # crash exactly once
                print("simulated crash at step", s, flush=True)
                os._exit(1)
        step += EVERY
        mgr.save(step, model, opt)
    with open(ckpt_dir + ".final", "w") as f:
        print("final", repr(model.temperature.item()), opt.count,
              repr(sum(p.double().sum().item() for p in model.parameters())),
              file=f)
""")


def test_supervised_process_crash_and_resume(tmp_path):
    """A training process that exits 1 mid-run is relaunched by `supervise`
    and resumes from its last checkpoint to the uninterrupted run's final
    state."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "trainer.py"
    script.write_text(_CRASHY_TRAINER.format(repo=repo))

    def run_to_completion(name, crash):
        ckpt_dir, flag = str(tmp_path / name), tmp_path / f"crash_{name}"
        if crash:
            flag.write_text("1")
        code = supervise([sys.executable, str(script), ckpt_dir, str(flag)],
                         max_restarts=2, backoff_seconds=0.05)
        assert code == 0
        assert not flag.exists()
        with open(ckpt_dir + ".final") as f:
            return f.read()

    clean = run_to_completion("clean", crash=False)
    crashed = run_to_completion("crashed", crash=True)
    assert clean.startswith("final")
    assert clean == crashed
