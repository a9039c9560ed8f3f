"""Checkpoints of a sharded state across four gloo ranks on the CPU: the
port's collective `save_checkpoint` writes whole tensors in JAX's layout,
and `restore_checkpoint` places them on any mesh, as JAX's Orbax
checkpoint does (`xclip_tpu/train/checkpoint.py`).

A CLIP of `test_torch_tp.WIDE`'s widths (four heads, so four model ranks
divide them) with DCL, the extra heads and patch dropout takes two
`make_train_step(mesh=)` steps on a 2 × 2 mesh, with JAX's draws of each
step replayed, and is saved; the run then takes a third step. The file is
held to the run's state gathered to JAX's layout (bit for bit) and to
JAX's `make_train_step` after the same two steps on its (2, 2) GSPMD mesh
of the fake CPU devices. The file restored on (4, 1), on (1, 4) and with
no mesh gives each rank the `shard_tensor` of the whole, bit for bit, and
AdamW's count, and its third step is the uninterrupted run's. Then a save
with no mesh restored onto (2, 2), `CheckpointManager` under the mesh, and
a mismatched file.

One module fixture spawns the world once (`torch_dist_worker.spawn`; the
ranks import no JAX) while JAX's two steps run here.

Tolerances (`tests/test_torch_tp.py`): metrics 1e-5 absolute and relative;
parameters and moments 2e-6 absolute (its `check_state` rule).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xclip_tpu
from xclip_tpu.parallel import create_mesh
from xclip_tpu.train import trainer as jtrainer
import xclip_tpu_torch
from xclip_tpu_torch.convert import _restack, numpy_params

from test_torch_distributed import global_batch, rank_results
from test_torch_tp import METRICS, WIDE, _adam, _check, check_state
from torch_dist_worker import flat_tree, spawn
from torch_objectives_draws import jax_draws
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

WORLD = 4
B = 8
TIMEOUT = 240
CONFIG = dict(WIDE, decoupled_contrastive_learning=True,
              extra_latent_projection=True, visual_patch_dropout=0.5)
OPTIMIZER = dict(learning_rate=1e-4, max_grad_norm=1.0)
KEYS = [jax.random.PRNGKey(40 + s) for s in range(3)]   # steps 1, 2, 3
RESTORES = {"4x1": (4, 1), "1x4": (1, 4), "no_mesh": None}
MISMATCHED = "model.text.transformer.layers.0.attn.to_qkv.w"


def _cases(work):
    tree = numpy_params(CONFIG, 40)
    text, image = global_batch(b=B, seed=40)
    keep = [np.asarray(jax_draws(k, b=B, num_patches=4, prob=0.5, seq=8,
                                 num_tokens=50)["keep_idx"]) for k in KEYS]
    base = dict(config=CONFIG, tree=tree, fresh_tree=numpy_params(CONFIG, 41),
                batch=dict(text=text, image=image), keep_idx=keep,
                optimizer=OPTIMIZER)
    run = f"{work}/run.ckpt"
    return [dict(base, name="run", kind="ckpt_run", path=run),
            *(dict(base, name=f"restore_{k}", kind="ckpt_restore", path=run,
                   mesh=m) for k, m in RESTORES.items()),
            dict(base, name="into_mesh", kind="ckpt_into_mesh",
                 path=f"{work}/flat.ckpt"),
            dict(base, name="manager", kind="ckpt_manager",
                 path=f"{work}/steps"),
            dict(base, name="mismatch", kind="ckpt_mismatch", source=run,
                 path=f"{work}/bad.ckpt", leaf=MISMATCHED)]


def _jax_two_steps(case):
    """JAX's GSPMD step twice on its (2, 2) mesh, KEYS[0] and KEYS[1]:
    (params, mu, nu) as flat numpy trees."""
    jclip = xclip_tpu.CLIP(**CONFIG)
    params = jax.tree.map(jnp.asarray, case["tree"])
    mesh = create_mesh((2, 2), devices=jax.devices()[:4])
    opt = jtrainer.default_optimizer(**OPTIMIZER)
    state = jtrainer.shard_state(jtrainer.TrainState(
        params=params, opt_state=opt.init(params),
        step=jnp.zeros((), jnp.int32)), mesh)
    text, image = jtrainer.shard_batch(
        tuple(jnp.asarray(case["batch"][k]) for k in ("text", "image")),
        mesh)
    step = jtrainer.make_train_step(jclip.model, opt, donate=False)
    for key in KEYS[:2]:
        state, _ = step(state, text, image, key)
    adam = _adam(state.opt_state)
    return (flat_tree(state.params), flat_tree(adam.mu), flat_tree(adam.nu))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("gloo")
    cases = _cases(str(work))
    box = {}

    def run():
        t0 = time.monotonic()
        box["ranks"] = spawn(cases, WORLD, str(work), timeout=TIMEOUT)
        box["seconds"] = time.monotonic() - t0
    ranks = threading.Thread(target=run)
    ranks.start()
    want = _jax_two_steps(cases[0])
    ranks.join()
    return dict(ranks=box["ranks"], seconds=box["seconds"], jax=want,
                cases={c["name"]: c for c in cases})


def _file_tree(path):
    """The checkpoint file as flat JAX-layout trees: ({"param:<leaf>": ...,
    "mu:<leaf>": ..., "nu:<leaf>": ...}, AdamW's count, the step)."""
    state = torch.load(path, weights_only=True)
    names = [n for n, _ in xclip_tpu_torch.CLIP(
        **CONFIG, device="cpu").named_parameters()]
    out = {}
    params = {k[len("model."):]: v.float().numpy()
              for k, v in state["model"].items()}
    out.update({f"param:{k}": v for k, v in _restack(params).items()})
    for m in ("mu", "nu"):
        flat = {names[i][len("model."):]: s[m].float().numpy()
                for i, s in state["optimizer"]["state"].items()}
        out.update({f"{m}:{k}": v for k, v in _restack(flat).items()})
    return out, state["optimizer"]["count"], state["step"]


def _state_of(res, tag=""):
    """(params, mu, nu) flat trees of a rank's `_ckpt_state` keys."""
    return tuple({k[len(tag) + len(m) + 1:]: v for k, v in res.items()
                  if k.startswith(f"{tag}{m}:")}
                 for m in ("param", "mu", "nu"))


def _uninterrupted(world):
    res = rank_results(world["ranks"], "run")
    metrics = {k: float(res[0][f"metric:{k}"]) for k in METRICS}
    return res, (metrics, *_state_of(res[0]))


def test_only_rank_0_writes_the_whole_state(world):
    """The 2 × 2 save: one `torch.save` on rank 0, none elsewhere; the
    file's tensors are every rank's state gathered to JAX's layout, bit
    for bit, with the same keys and shapes as the model's `state_dict()`
    with no mesh."""
    res, _ = _uninterrupted(world)
    assert [int(r["saves"]) for r in res] == [1, 0, 0, 0]
    got, count, step = _file_tree(world["cases"]["run"]["path"])
    assert count == 2 and step == 2
    for r, rank in enumerate(res):
        saved = {k[len("saved:"):]: v for k, v in rank.items()
                 if k.startswith("saved:") and k != "saved:count"}
        assert saved.keys() == got.keys()
        for k, v in saved.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {r} {k}")
    whole = xclip_tpu_torch.CLIP(**CONFIG, device="cpu").state_dict()
    state = torch.load(world["cases"]["run"]["path"], weights_only=True)
    assert {k: tuple(v.shape) for k, v in state["model"].items()} == \
        {k: tuple(v.shape) for k, v in whole.items()}


def test_file_is_jax_s_gspmd_state(world):
    """The file's parameters and both moments against JAX's
    `make_train_step` after the same two steps on its (2, 2) mesh."""
    got, _, _ = _file_tree(world["cases"]["run"]["path"])
    check_state(got, *world["jax"], "file")


@pytest.mark.parametrize("name", list(RESTORES))
def test_restore_on_another_mesh_resumes_the_run(world, name):
    """Restored on (4, 1), (1, 4) or with no mesh: the saved step and
    AdamW's count; each rank's shards `shard_tensor` of the file's whole
    tensors bit for bit (on (1, 4) the ten TP-sharded leaves, none on
    (4, 1)); the third step the uninterrupted run's (metrics, parameters
    and moments)."""
    results = rank_results(world["ranks"], f"restore_{name}")
    assert len(results) == WORLD
    sharded = {"4x1": 0, "1x4": 10, "no_mesh": 0}[name]
    for res in results:
        assert int(res["step"]) == 2 and int(res["restored_count"]) == 2
        assert int(res["count"]) == 3
        assert bool(res["shards_match"])
        assert int(res["sharded"]) == sharded
    _, want = _uninterrupted(world)
    _check(results, want)


def test_uninterrupted_run_is_consistent_across_ranks(world):
    """The uninterrupted 2 × 2 run's third step is the same on every rank
    (the reference the restores are held to)."""
    res, want = _uninterrupted(world)
    _check(res, want)


def test_unsharded_save_restores_into_a_sharded_model(world):
    """A save with no mesh (collective all the same: rank 0 writes)
    restored into a model placed by `shard_state` on (2, 2): its shards
    are the file's, and its state gathers back to the saved one."""
    results = rank_results(world["ranks"], "into_mesh")
    assert [int(r["saves"]) for r in results] == [1, 0, 0, 0]
    for res in results:
        assert int(res["step"]) == 1
        assert bool(res["shards_match"]) and int(res["sharded"]) == 10
        assert bool(res["same_tree"])


def test_checkpoint_manager_under_the_mesh(world):
    """`CheckpointManager(keep=1)` on a 2 × 2 mesh: rank 0 alone writes
    (two saves), step 1 is gone, step 2 and its sidecar stay, and
    `restore_latest` on a (4, 1) mesh gives every rank step 2's state."""
    results = rank_results(world["ranks"], "manager")
    assert [int(r["saves"]) for r in results] == [2, 0, 0, 0]
    for res in results:
        assert list(res["files"]) == ["step_2", "step_2.loader.json"]
        assert int(res["step"]) == 2 and int(res["loader_batch"]) == 2
        assert bool(res["same_tree"])


def test_mismatched_file_raises_on_every_rank(world):
    """A leaf one column wider than the model's raises `ValueError` naming
    it on every rank, and the world ends inside the spawn's time limit."""
    results = rank_results(world["ranks"], "mismatch")
    for res in results:
        assert str(res["type"]) == "ValueError"
        assert MISMATCHED in str(res["message"])
        assert "(32, 97)" in str(res["message"])
    assert world["seconds"] < TIMEOUT
