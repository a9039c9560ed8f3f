"""The ranks of the port's data-parallel tests: `spawn(cases, world, dir)`
starts `world` processes (multiprocessing 'spawn'; this module is their
target, so it imports torch and `xclip_tpu_torch` only, never JAX), joins
them within a time limit and kills them past it, and returns each rank's
results.

Each rank joins a gloo group through a file store in `dir` (no TCP port),
with a 60 s collective timeout and one thread, runs every case in order,
and writes its results to `dir/rank{r}.npz`: for case `name`, the arrays
`name/<key>`, or `name/error` with the traceback when the case raised.
A case is a dict with `kind` (a function of this module), and what that
function reads: the port's CLIP config and weights (`numpy_params` trees),
the global batch as numpy, and keyword arguments.
"""

from __future__ import annotations

import os
import pickle
import sys
import time
import traceback
import warnings
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT = 60


def spawn(cases, world, work_dir, timeout=300):
    """Run `cases` on `world` gloo ranks; returns [rank's results dict]
    ({case name: {key: array}}); a rank that did not finish in `timeout`
    seconds is killed and its results are missing ({})."""
    path = os.path.join(work_dir, "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump(cases, f)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=main, args=(r, world, work_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    out = []
    for r in range(world):
        f = os.path.join(work_dir, f"rank{r}.npz")
        results = {}
        if os.path.exists(f):
            with np.load(f) as z:
                for key in z.files:
                    name, item = key.split("/", 1)
                    results.setdefault(name, {})[item] = z[key]
        out.append(results)
    return out


def main(rank, world, work_dir):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(work_dir, 'store')}",
        rank=rank, world_size=world,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT))
    group = dist.group.WORLD
    with open(os.path.join(work_dir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    flat = {}
    try:
        for case in cases:
            try:
                res = globals()[case["kind"]](case, group)
            except Exception:
                res = {"error": np.array(traceback.format_exc())}
            for k, v in res.items():
                flat[f"{case['name']}/{k}"] = np.asarray(v)
            dist.barrier(group)
    finally:
        np.savez(os.path.join(work_dir, f"rank{rank}.npz"), **flat)
        dist.destroy_process_group()


# ----------------------------------------------------------------- helpers

def _clip(case):
    import xclip_tpu_torch
    from xclip_tpu_torch.convert import load_jax_params
    ssl = case.get("ssl")
    if ssl is not None:
        from xclip_tpu_torch.objectives import ssl as tssl
        kind, kw = ssl
        ssl = (tssl.SimSiam if kind == "simsiam" else tssl.SimCLR)(**kw)
    clip = xclip_tpu_torch.CLIP(**case["config"], visual_ssl=ssl,
                                device="cpu")
    load_jax_params(clip, case["tree"])
    return clip


def flat_tree(tree, prefix=""):
    """A nested dict of arrays as {"a.b.c": fp32 numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _grads(clip):
    from xclip_tpu_torch.convert import to_jax_tree
    return {f"grad:{k}": v for k, v in
            flat_tree(to_jax_tree(clip, grads=True)).items()}


def _shard(group, arrays):
    """This rank's rows of each numpy array (None stays None), as torch
    tensors, through the port's `shard_batch`."""
    from xclip_tpu_torch.train import shard_batch
    present = [torch.from_numpy(np.asarray(a)) for a in arrays
               if a is not None]
    shards = iter(shard_batch(present, group))
    return [None if a is None else next(shards) for a in arrays]


def _draws(case, rank):
    """The injected draws of this rank (numpy → torch), if any."""
    draws = case.get("draws")
    if draws is None:
        return {}
    draws = draws[rank] if isinstance(draws, list) else draws

    def conv(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x)
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x
    return conv(draws)


# ------------------------------------------------------------------- cases

def loss(case, group):
    """One training forward on this rank's shard with `axis_name=group`:
    the loss, the metrics and this rank's parameter gradients."""
    clip = _clip(case)
    b = case["batch"]
    text, image, aug_text, aug_image, valid = _shard(group, [
        b["text"], b["image"], b.get("aug_text"), b.get("aug_image"),
        b.get("valid")])
    kw = dict(case.get("kwargs", {}))
    loss, metrics = clip(text, image, return_loss=True, return_metrics=True,
                         aug_text=aug_text, aug_image=aug_image,
                         row_valid=valid, axis_name=group,
                         **_draws(case, dist.get_rank(group)), **kw)
    loss.backward()
    out = {"loss": loss.item()}
    out.update({f"metric:{k}": v.item() for k, v in metrics.items()
                if k != "bn_updates"})
    out.update(_grads(clip))
    return out


def raises(case, group):
    """The type and message of what a forward with `axis_name=group`
    raises (nothing: type '')."""
    clip = _clip(case)
    b = case["batch"]
    text, image, valid = _shard(group, [b["text"], b["image"],
                                        b.get("valid")])
    try:
        clip(text, image, return_loss=True, row_valid=valid,
             axis_name=group)
    except Exception as e:   # what is raised is the result
        return {"type": type(e).__name__, "message": str(e)}
    return {"type": "", "message": ""}


def shard_rows(case, group):
    """`shard_batch`'s rows for this rank, and its refusal of a batch that
    does not divide."""
    from xclip_tpu_torch.train import shard_batch
    text, image = (torch.from_numpy(case["batch"][k])
                   for k in ("text", "image"))
    st, si = shard_batch((text, image), group)
    try:
        shard_batch((text[:case["indivisible"]],), group)
        message = ""
    except ValueError as e:
        message = str(e)
    return {"text": st.numpy(), "image": si.numpy(), "message": message}


def collectives(case, group):
    """The collectives and their backward on rank-dependent inputs."""
    from xclip_tpu_torch.parallel.collectives import (
        all_gather, all_reduce_sum_, axis_index, axis_size, pmean, psum,
        replicated)
    rank, world = axis_index(group), axis_size(group)
    out = {"rank": rank, "world": world, "jax_imported": any(
        m.split(".")[0] in ("jax", "xclip_tpu") for m in sys.modules)}
    # (m, b, d) views gathered on dim 1; each rank's loss weighs the
    # gathered tensor by its own weights, so the backward must sum the
    # ranks' gradients of this rank's slice
    gen = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(2, 3, 5, generator=gen, requires_grad=True)
    w = torch.randn(2, 3 * world, 5, generator=gen)
    y = all_gather(x, group, dim=1)
    (y * w).sum().backward()
    out.update(x=x.detach(), w=w, gathered=y.detach(), gather_grad=x.grad)
    # psum of a replicated sum: backward the identity, not world ×
    v = torch.tensor(float(rank + 1), requires_grad=True)
    total = psum(v * v, group)
    total.backward()
    out.update(psum=total.detach(), psum_grad=v.grad)
    # the trap: torch.distributed.nn's all_reduce all-reduces the gradient
    import torch.distributed.nn.functional as dnn
    v2 = torch.tensor(float(rank + 1), requires_grad=True)
    dnn.all_reduce(v2 * v2, group=group).backward()
    out.update(dnn_grad=v2.grad)
    # pmean: forward psum / world, backward / world
    v3 = torch.tensor(float(rank + 1), requires_grad=True)
    mean = pmean(v3 * v3, group)
    mean.backward()
    out.update(pmean=mean.detach(), pmean_grad=v3.grad)
    # a replicated value: the identity forward, / world backward
    v4 = torch.tensor(3.0, requires_grad=True)
    rep = replicated(v4 * v4, group)
    rep.backward()
    out.update(replicated=rep.detach(), replicated_grad=v4.grad)
    # masks gather as they are
    mask = torch.arange(4) % (rank + 2) == 0
    out.update(mask=mask, gathered_mask=all_gather(mask, group, dim=0))
    # the flat all-reduce, two dtypes
    ts = [torch.full((2, 3), float(rank)), torch.arange(4.0) * (rank + 1),
          torch.full((3,), rank + 1, dtype=torch.float64)]
    all_reduce_sum_(ts, group)
    out.update({f"flat{i}": t for i, t in enumerate(ts)})
    return out


def step(case, group):
    """One (or `steps`) data-parallel `make_train_step` on this rank's
    shard: the metrics, the warnings and the parameters after it."""
    from xclip_tpu_torch.convert import to_jax_tree
    from xclip_tpu_torch.train import default_optimizer, make_train_step
    clip = _clip(case)
    b = case["batch"]
    text, image = _shard(group, [b["text"], b["image"]])
    opt = default_optimizer(clip.parameters(), **case["optimizer"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn = make_train_step(clip, opt, axis_name=group,
                             **case.get("step", {}))
    metrics = fn(text, image)
    out = {f"metric:{k}": v.item() for k, v in metrics.items()}
    out["warnings"] = np.array([str(w.message) for w in caught] or [""])
    out.update({f"param:{k}": v for k, v in
                flat_tree(to_jax_tree(clip)).items()})
    return out


# ------------------------------------------------- the (data, model) mesh

def _moments(clip, opt):
    """AdamW's moments gathered to JAX's layout, as {"mu:<leaf>": array,
    "nu:<leaf>": ...} with the depth axis restacked (`to_jax_tree`'s
    names)."""
    from xclip_tpu_torch.convert import _restack
    from xclip_tpu_torch.parallel.sharding import gather_tensor
    out = {}
    for k in ("mu", "nu"):
        flat = {}
        for name, p in clip.model.named_parameters():
            t = opt.state[p][k].detach()
            if getattr(p, "sharding", None) is not None:
                t = gather_tensor(t, p.sharding)
            flat[name] = t.float().numpy()
        out.update({f"{k}:{n}": v for n, v in _restack(flat).items()})
    return out


def _placement(clip, opt, tag):
    """Each TP-sharded parameter's shape and its moments' (when made) on
    this rank: {"<tag>:<name>": (param shape, mu shape, nu shape)}."""
    out = {}
    for name, p in clip.model.named_parameters():
        if p.sharding.is_fully_replicated:
            continue
        st = opt.state.get(p, {})
        out[f"{tag}:{name}"] = np.array(
            [list(p.shape), list(st["mu"].shape) if st else [-1] * p.ndim,
             list(st["nu"].shape) if st else [-1] * p.ndim])
    return out


def tp_step(case, group):
    """One (data, model) mesh step (`shard_state`, `shard_batch(mesh)`,
    `make_train_step(mesh=)`) on the ranks of `case["devices"]`: the
    metrics, the parameters and moments after it gathered to JAX's
    layout, and the TP-sharded tensors' local shapes before and after."""
    from xclip_tpu_torch.convert import to_jax_tree
    from xclip_tpu_torch.parallel import create_mesh
    from xclip_tpu_torch.train import (default_optimizer, make_train_step,
                                       shard_batch, shard_state)
    mesh = create_mesh(case["mesh"], devices=case.get("devices"))
    if not mesh.member:
        return {"member": False}
    clip = _clip(case)
    opt = default_optimizer(clip.parameters(), **case["optimizer"])
    shard_state(clip, opt, mesh)
    out = {"member": True, **_placement(clip, opt, "before")}
    b = case["batch"]
    text, image = shard_batch((torch.from_numpy(b["text"]),
                               torch.from_numpy(b["image"])), mesh)
    kw = _draws(case, dist.get_rank())
    if case.get("seed_by_rank"):
        kw["generator"] = torch.Generator().manual_seed(dist.get_rank())
    metrics = make_train_step(clip, opt, mesh=mesh,
                              **case.get("step", {}))(text, image, **kw)
    out.update({f"metric:{k}": v.item() for k, v in metrics.items()})
    out.update(_placement(clip, opt, "after"))
    out.update({f"param:{k}": v for k, v in
                flat_tree(to_jax_tree(clip)).items()})
    out.update(_moments(clip, opt))
    return out


def tp_layout(case, group):
    """A whole JAX tree loaded into a model sharded on a (1, world) mesh:
    layer 0's local `to_qkv.w` and `w_in.w` of each tower, the tree
    gathered back; `shard_state` of an optimizer holding whole moments;
    and the errors of an indivisible batch and of a grid that does not
    cover the world."""
    from xclip_tpu_torch.convert import load_jax_params, to_jax_tree
    from xclip_tpu_torch.parallel import create_mesh, shard_params
    from xclip_tpu_torch.train import shard_batch
    import xclip_tpu_torch
    world = dist.get_world_size()
    mesh = create_mesh((1, world))
    clip = xclip_tpu_torch.CLIP(**case["config"], device="cpu")
    shard_params(clip, mesh)
    load_jax_params(clip, case["tree"])
    out = {f"param:{k}": v for k, v in flat_tree(to_jax_tree(clip)).items()}
    for tower in ("text", "visual"):
        layer = getattr(clip.model, tower).transformer.layers[0]
        out[f"local:{tower}.to_qkv"] = layer.attn.to_qkv.w.detach().numpy()
        out[f"local:{tower}.w_in"] = layer.ff.w_in.w.detach().numpy()
    # moments made before (a restored optimizer) are sharded as their
    # parameters
    from xclip_tpu_torch.train import default_optimizer, shard_state
    clip = xclip_tpu_torch.CLIP(**case["config"], device="cpu")
    load_jax_params(clip, case["tree"])
    opt = default_optimizer(clip.parameters())
    for p in clip.parameters():
        opt.state[p] = {"mu": p.detach().clone(), "nu": 2 * p.detach()}
    shard_state(clip, opt, mesh)
    out["moments_follow"] = opt.model_group is not None and all(
        torch.equal(opt.state[p]["mu"], p) and torch.equal(
            opt.state[p]["nu"], 2 * p) for p in clip.parameters())
    dp = create_mesh((world, 1))
    try:
        shard_batch((torch.zeros(world + 2, 3),), dp)
        out["indivisible"] = ""
    except ValueError as e:
        out["indivisible"] = str(e)
    try:
        create_mesh((world - 1, 1))
        out["uncovered"] = ""
    except AssertionError as e:
        out["uncovered"] = str(e)
    return out


def tp_unsharded(case, group):
    """On rank 0 alone, a (1, 1) mesh: the mesh step against the step
    without a mesh from the same weights, bit for bit."""
    import xclip_tpu_torch  # noqa: F401
    from xclip_tpu_torch.parallel import create_mesh
    from xclip_tpu_torch.train import (default_optimizer, make_train_step,
                                       shard_batch, shard_state)
    mesh = create_mesh((1, 1), devices=[0])
    if not mesh.member:
        return {"member": False}
    b = case["batch"]
    text, image = (torch.from_numpy(b[k]) for k in ("text", "image"))
    runs = []
    for on_mesh in (False, True):
        clip = _clip(case)
        opt = default_optimizer(clip.parameters(), **case["optimizer"])
        kw = {}
        if on_mesh:
            shard_state(clip, opt, mesh)
            text, image = shard_batch((text, image), mesh)
            kw["mesh"] = mesh
        m = make_train_step(clip, opt, **kw)(
            text, image, generator=torch.Generator().manual_seed(3))
        runs.append((m, [p.detach().clone() for p in clip.parameters()],
                     [opt.state[p]["mu"] for p in clip.parameters()]))
    (m0, p0, mu0), (m1, p1, mu1) = runs
    return {"member": True,
            "metrics_equal": all(torch.equal(m0[k], m1[k]) for k in m0),
            "params_equal": all(map(torch.equal, p0, p1)),
            "moments_equal": all(map(torch.equal, mu0, mu1))}


def tp_stack(case, group):
    """A transformer stack sharded over a (1, world) mesh against the same
    stack whole, in training on the plain route with injected dropout
    masks (whole-shaped; each rank takes its heads' and its inner slice's
    block): the output and every gradient, gathered (JAX's layout)."""
    from xclip_tpu_torch.nn.layers import Transformer, rotary_freqs
    from xclip_tpu_torch.parallel import create_mesh, shard_params
    from xclip_tpu_torch.parallel.sharding import gather_tensor
    mesh = create_mesh((1, dist.get_world_size()))
    c = case["stack"]
    x = torch.from_numpy(case["x"])
    mask = torch.from_numpy(case["mask"])
    keep = [[torch.from_numpy(m) for m in layer] for layer in case["keep"]]
    rotary = (rotary_freqs(x.shape[1], c["dim_head"])
              if case.get("rotary") else None)
    out = {}
    for tag in ("whole", "sharded"):
        stack = Transformer(c["dim"], depth=c["depth"], heads=c["heads"],
                            dim_head=c["dim_head"],
                            generator=torch.Generator().manual_seed(0))
        if tag == "sharded":
            shard_params(stack, mesh)
        xx = x.clone().requires_grad_()
        y = stack(xx, mask, causal=bool(case.get("rotary")), rotary=rotary,
                  training=True, attn_dropout=0.25, ff_dropout=0.25,
                  dropout_keep=keep, **case.get("flags", {}))
        (y * torch.from_numpy(case["cot"])).sum().backward()
        out[f"{tag}:out"] = y.detach().numpy()
        out[f"{tag}:dx"] = xx.grad.numpy()
        for name, p in stack.named_parameters():
            g = p.grad
            if getattr(p, "sharding", None) is not None:
                g = gather_tensor(g, p.sharding)
            out[f"{tag}:grad:{name}"] = g.numpy()
    return out


# ------------------------------------------- checkpoints of a sharded state

def _ckpt_model(case, mesh_shape):
    """The case's CLIP and AdamW, placed by `shard_state` on a mesh of
    `mesh_shape` over every rank (None: no mesh); (clip, opt, mesh)."""
    from xclip_tpu_torch.parallel import create_mesh
    from xclip_tpu_torch.train import default_optimizer, shard_state
    clip = _clip(case)
    opt = default_optimizer(clip.parameters(), **case["optimizer"])
    mesh = None
    if mesh_shape is not None:
        mesh = create_mesh(tuple(mesh_shape))
        shard_state(clip, opt, mesh)
    return clip, opt, mesh


def _ckpt_step(case, clip, opt, mesh, step):
    """Step `step` (1-based) of the case's run, JAX's draws of that step
    replayed: this rank's rows of the batch and of the patch indices."""
    from xclip_tpu_torch.train import make_train_step, shard_batch
    b = case["batch"]
    text, image = (torch.from_numpy(b[k]) for k in ("text", "image"))
    keep = torch.from_numpy(case["keep_idx"][step - 1])
    if mesh is not None:
        text, image, keep = shard_batch((text, image, keep), mesh)
    kw = {} if mesh is None else {"mesh": mesh}
    return make_train_step(clip, opt, **kw)(text, image, keep_idx=keep)


def _ckpt_state(clip, opt, tag=""):
    """The metrics-free state in JAX's layout: {"<tag>param:<leaf>": ...,
    "<tag>mu:<leaf>": ..., "<tag>nu:<leaf>": ...} and AdamW's count."""
    from xclip_tpu_torch.convert import to_jax_tree
    # copies: an fp32 CPU parameter's numpy view follows later steps
    out = {f"{tag}param:{k}": v.copy() for k, v in
           flat_tree(to_jax_tree(clip)).items()}
    out.update({f"{tag}{k}": v.copy() for k, v in
                _moments(clip, opt).items()})
    out[f"{tag}count"] = opt.count
    return out


def _counting_saves():
    """A patch of `torch.save` that counts this process's calls."""
    from unittest import mock
    calls = []
    real = torch.save

    def save(obj, f, *a, **kw):
        calls.append(str(f))
        return real(obj, f, *a, **kw)
    return mock.patch.object(torch, "save", save), calls


def _shards_match(clip, opt, path):
    """Whether each sharded parameter and both its moments on this rank are
    `shard_tensor` of the file's whole tensor, bit for bit; and how many
    parameters are sharded."""
    from xclip_tpu_torch.parallel.sharding import is_sharded, shard_tensor
    state = torch.load(path, weights_only=True)
    index = {id(p): i for i, p in enumerate(clip.parameters())}
    ok, sharded = True, 0
    for name, p in clip.named_parameters():
        if not is_sharded(p):
            ok &= torch.equal(p.detach(), state["model"][name])
            continue
        sharded += 1
        ok &= torch.equal(p.detach(),
                          shard_tensor(state["model"][name], p.sharding))
        saved = state["optimizer"]["state"][index[id(p)]]
        for k in ("mu", "nu"):
            ok &= torch.equal(opt.state[p][k],
                              shard_tensor(saved[k], p.sharding))
    return bool(ok), sharded


def ckpt_run(case, group):
    """The uninterrupted run on a 2 × 2 mesh: two steps, a collective save
    (the `torch.save` calls of this rank counted), the state the save saw,
    then the third step."""
    from xclip_tpu_torch.train import save_checkpoint
    clip, opt, mesh = _ckpt_model(case, (2, 2))
    for s in (1, 2):
        _ckpt_step(case, clip, opt, mesh, s)
    patch, calls = _counting_saves()
    with patch:
        save_checkpoint(case["path"], clip, opt, step=2)
    out = _ckpt_state(clip, opt, "saved:")
    out["saves"] = len(calls)
    metrics = _ckpt_step(case, clip, opt, mesh, 3)
    out.update({f"metric:{k}": v.item() for k, v in metrics.items()})
    out.update(_ckpt_state(clip, opt))
    return out


def ckpt_restore(case, group):
    """A fresh CLIP and AdamW (other weights) on `case["mesh"]` (None: no
    mesh) restored from the 2 × 2 run's file: the step and count it gave,
    whether each rank's shards are the file's, then the third step."""
    from xclip_tpu_torch.train import restore_checkpoint
    clip, opt, mesh = _ckpt_model(dict(case, tree=case["fresh_tree"]),
                                  case["mesh"])
    saved_step = restore_checkpoint(case["path"], clip, opt)
    ok, sharded = _shards_match(clip, opt, case["path"])
    out = {"step": saved_step, "restored_count": opt.count,
           "shards_match": ok,
           "sharded": sharded}
    metrics = _ckpt_step(case, clip, opt, mesh, 3)
    out.update({f"metric:{k}": v.item() for k, v in metrics.items()})
    out.update(_ckpt_state(clip, opt))
    return out


def ckpt_into_mesh(case, group):
    """A model with no mesh saved (collective: rank 0 writes), restored
    into a model placed by `shard_state` on a 2 × 2 mesh: its shards, and
    the tree gathered back."""
    from xclip_tpu_torch.train import restore_checkpoint, save_checkpoint
    clip, opt, _ = _ckpt_model(case, None)
    _ckpt_step(case, clip, opt, None, 1)
    patch, calls = _counting_saves()
    with patch:
        save_checkpoint(case["path"], clip, opt, step=1)
    want = _ckpt_state(clip, opt)
    sharded, sopt, _ = _ckpt_model(dict(case, tree=case["fresh_tree"]),
                                   (2, 2))
    step = restore_checkpoint(case["path"], sharded, sopt)
    ok, n = _shards_match(sharded, sopt, case["path"])
    got = _ckpt_state(sharded, sopt)
    return {"step": step, "saves": len(calls), "shards_match": ok,
            "sharded": n,
            "same_tree": got.keys() == want.keys() and all(
                np.array_equal(got[k], want[k]) for k in want)}


def ckpt_manager(case, group):
    """`CheckpointManager(keep=1)` under a 2 × 2 mesh: two steps each
    saved with a loader sidecar (this rank's `torch.save` calls counted),
    the files left, then `restore_latest` into a fresh model on (4, 1)."""
    from xclip_tpu_torch.train import CheckpointManager
    clip, opt, mesh = _ckpt_model(case, (2, 2))
    manager = CheckpointManager(case["path"], keep=1)
    patch, calls = _counting_saves()
    with patch:
        for s in (1, 2):
            _ckpt_step(case, clip, opt, mesh, s)
            manager.save(s, clip, opt, loader_state={"epoch": 0,
                                                     "batch_index": s})
    files = sorted(os.listdir(case["path"]))
    want = _ckpt_state(clip, opt)
    fresh, fopt, _ = _ckpt_model(dict(case, tree=case["fresh_tree"]),
                                 (4, 1))
    step = manager.restore_latest(fresh, fopt)
    got = _ckpt_state(fresh, fopt)
    return {"saves": len(calls), "files": np.array(files), "step": step,
            "loader_batch": manager.loader_state()["batch_index"],
            "same_tree": got.keys() == want.keys() and all(
                np.array_equal(got[k], want[k]) for k in want)}


def ckpt_mismatch(case, group):
    """A file whose `case["leaf"]` has one column too many, restored into
    a model on a 2 × 2 mesh: what every rank raises."""
    from xclip_tpu_torch.train import restore_checkpoint
    if dist.get_rank() == 0:
        state = torch.load(case["source"], weights_only=True)
        w = state["model"][case["leaf"]]
        state["model"][case["leaf"]] = torch.cat([w, w[:, :1]], dim=1)
        torch.save(state, case["path"])
    dist.barrier()
    clip, opt, _ = _ckpt_model(case, (2, 2))
    try:
        restore_checkpoint(case["path"], clip, opt)
    except Exception as e:   # what is raised is the result
        return {"type": type(e).__name__, "message": str(e)}
    return {"type": "", "message": ""}
