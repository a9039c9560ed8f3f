"""Checkpoint and resume of a training run — the counterpart of
`xclip_tpu/train/checkpoint.py`, through `torch.save` / `torch.load`.

A checkpoint holds what JAX's `TrainState` holds: the parameters (the
model's `state_dict()`, with the SSL heads' BatchNorm running statistics,
which JAX keeps among its parameters), the optimizer's state (`AdamW.state_dict()`, its
step count included) and the step. It holds no generator state, as JAX's
holds no key. A save is atomic, as Orbax's is: the file is written under a
temporary name and moved into place with `os.replace`, so a kill during a
save leaves the previous checkpoint as it was.

The file holds whole tensors in JAX's layout, as Orbax's holds global
arrays: a parameter that `shard_state` (`parallel.sharding`) has sharded
over a mesh, and both of its AdamW moments, are gathered from the ranks'
shards (`gather_tensor`: [q | k | v] for `to_qkv.w`, [value | gate] for
`w_in.w`); the replicated parameters, the BatchNorm buffers and AdamW's
`count` go in as they are. So the file has the keys and shapes of the
`state_dict()` of the same model with no mesh, and restores on any mesh or
on none: each sharded parameter, and its moments, take this rank's shard
of the whole tensor (`shard_tensor`).

Collective. Where `torch.distributed` is initialised with more than one
rank, `save_checkpoint` is called by every rank: each gathers its model
group's shards, global rank 0 alone writes, and every rank waits at a
barrier of the default group, so none returns before the file is whole.
This holds for a data-parallel run with nothing sharded too.
`restore_checkpoint` is not collective: every rank reads the file, and a
shape that differs from the model's raises `ValueError` on every rank
before anything is loaded. With no process group both act on the one
process alone.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.sharding import (gather_tensor, is_sharded,
                                 opt_state_shardings, shard_tensor)


def _world() -> int:
    """The default process group's size; 1 where there is none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _opt_params(optimizer):
    """The optimizer's parameters in `state_dict()`'s index order."""
    return [p for g in optimizer.param_groups for p in g["params"]]


def _moment_shardings(model, optimizer):
    """{id(parameter): {moment: NamedSharding}} of the sharded parameters'
    AdamW moments (`opt_state_shardings`); {} when nothing is sharded."""
    mesh = next((p.sharding.mesh for p in model.parameters()
                 if is_sharded(p)), None)
    if mesh is None:
        return {}
    names = {n: p for n, p in model.named_parameters()}
    placement = opt_state_shardings(optimizer, model, mesh)["state"]
    return {id(names[n]): s for n, s in placement.items()
            if is_sharded(names[n])}


def _global_shape(p) -> tuple:
    """The whole tensor's shape of parameter `p`, sharded or not."""
    shape = list(p.shape)
    if is_sharded(p):
        mesh = p.sharding.mesh
        for dim, axis in enumerate(tuple(p.sharding.spec)):
            if axis is not None:
                shape[dim] *= mesh.axis_size(axis)
    return tuple(shape)


@torch.no_grad()
def save_checkpoint(path: str, model, optimizer=None,
                    step: Optional[int] = None) -> None:
    """Write `model`'s parameters, `optimizer`'s state and `step` to
    `path`, sharded tensors whole (see the module docstring; collective
    under a process group of more than one rank)."""
    params = dict(model.named_parameters())
    weights = model.state_dict()
    for name, p in params.items():
        if is_sharded(p):
            weights[name] = gather_tensor(p.detach(), p.sharding)
    opt_state = None
    if optimizer is not None:
        opt_state = optimizer.state_dict()
        moments = _moment_shardings(model, optimizer)
        order = _opt_params(optimizer)
        # state_dict() shares the optimizer's own per-parameter dicts
        opt_state["state"] = {i: dict(s) for i, s in
                               opt_state["state"].items()}
        for i, s in opt_state["state"].items():
            for k, sharding in moments.get(id(order[i]), {}).items():
                if k in s:
                    s[k] = gather_tensor(s[k], sharding)
    state = {"model": weights, "step": step, "optimizer": opt_state}
    world = _world()
    if world == 1 or dist.get_rank() == 0:
        tmp = f"{path}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
    if world > 1:
        dist.barrier()


def _check_shape(name, whole, want):
    if tuple(whole.shape) != tuple(want):
        raise ValueError(f"{name}: shape {tuple(whole.shape)} in the "
                         f"checkpoint, {tuple(want)} in the model")


def restore_checkpoint(path: str, model, optimizer=None) -> Optional[int]:
    """Load a checkpoint written by `save_checkpoint` into `model` (and
    `optimizer`) in place, its tensors mapped to the model's device and
    sharded as the model's parameters are; returns the saved step. Raises
    `ValueError` naming the first tensor whose shape is not the model's,
    before anything is loaded."""
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    params = dict(model.named_parameters())
    weights = dict(state["model"])
    for name, t in model.state_dict().items():
        if name not in weights:
            continue    # load_state_dict names what is missing
        p = params.get(name)
        _check_shape(name, weights[name],
                     t.shape if p is None else _global_shape(p))
        if p is not None and is_sharded(p):
            weights[name] = shard_tensor(weights[name],
                                         p.sharding).contiguous()
    opt_state = None
    if optimizer is not None:
        opt_state = dict(state["optimizer"])
        names = {id(p): n for n, p in params.items()}
        moments = _moment_shardings(model, optimizer)
        order = _opt_params(optimizer)
        opt_state["state"] = {i: dict(s) for i, s in
                              opt_state["state"].items()}
        for i, s in opt_state["state"].items():
            p = order[i]
            for k, v in s.items():    # AdamW's moments, shaped as p
                if not torch.is_tensor(v):
                    continue
                _check_shape(f"{names.get(id(p), i)} ({k})", v,
                             _global_shape(p))
                if k in moments.get(id(p), {}):
                    s[k] = shard_tensor(v, moments[id(p)][k]).contiguous()
    model.load_state_dict(weights)
    if optimizer is not None:
        optimizer.load_state_dict(opt_state)
    return state["step"]
