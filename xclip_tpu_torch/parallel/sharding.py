"""Parameter sharding rules — the counterpart of
`xclip_tpu/parallel/sharding.py`: data parallelism plus Megatron-style
tensor parallelism (TP) for the transformer stacks.

JAX stacks each per-layer leaf along a leading depth axis; the port keeps
`layers.<i>.<leaf>` (`convert.py`), so JAX's 3-D rules are 2-D rules on each
layer's matrices here:

  * attention `to_qkv.w`  (dim, 3·inner)  → column-parallel (heads split
    over 'model')
  * attention `to_out.w`  (inner, dim)    → row-parallel (the input, head
    dim); the layer sums the ranks' outputs (`collectives.psum`)
  * FF `w_in.w`           (dim, 2·inner)  → column-parallel
  * FF `inner_norm.g`     (inner,)        → follows the inner shards
  * FF `w_out.w`          (inner, dim)    → row-parallel
  * everything else (embeddings, LayerNorm gains, latent, MLM and SSL
    heads, the temperature) → replicated.

Layout. JAX shards the fused dimension of `to_qkv.w` ([q | k | v]) and of
`w_in.w` ([value | gate]) in contiguous blocks, so at model size 2 its
rank 0 holds all of q and half of k, or every value column, and GSPMD
reshards where the layer splits them. The port shards each third of
`to_qkv.w` and each half of `w_in.w` on its own (`NamedSharding.parts` 3
and 2): rank r holds q, k and v of its heads, or the value and gate
columns of its inner slice, so attention and GEGLU run on the rank's own
columns. `gather_tensor` rebuilds JAX's tensor from the ranks' shards and
`shard_tensor` is its inverse; `convert.load_jax_params` and
`convert.to_jax_tree` go through them, so JAX's param tree loads into a
sharded model and comes back out in JAX's layout.

A sharded model (`shard_params`) runs its layers on its shards: on the
plain ('xla') route, attention on the rank's heads and the FF on its inner
slice, with the inner LayerNorm's statistics summed over the model group;
on a kernel route the layer gathers its weights over the model group
(`gather_tensor`) and runs the kernel on the whole layer, as GSPMD runs an
opaque kernel on replicated operands (`nn/layers.py`). A model axis of
size 1 shards nothing, and the layers run as without a mesh.

`shard_params` and `shard_state` (`train.trainer`) act in place: the
parameters' data become this rank's shards, each parameter keeps its
placement as `.sharding` (`param_shardings`), and each `Transformer` of
the model its model group. `opt_state_shardings` places `AdamW`'s moments
as their parameters and its step count replicated, as JAX's `place` does.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist

from .collectives import check_device
from .mesh import Mesh, NamedSharding, PartitionSpec as P, replicated

_LAYER_LEAF = re.compile(r"(^|\.)layers\.\d+\.")


def param_spec(path: str, x) -> P:
    """PartitionSpec for one parameter, by its name in the model."""
    if _LAYER_LEAF.search(path):
        if x.ndim == 2:   # a layer's matrices (in, out)
            if "to_qkv" in path or "w_in" in path:
                return P(None, "model")     # column parallel
            if "to_out" in path or "w_out" in path:
                return P("model", None)     # row parallel
        if x.ndim == 1 and "inner_norm" in path:
            return P("model")
    return P()


def param_parts(path: str) -> int:
    """How many fused pieces the sharded dimension of a parameter holds,
    each sharded on its own: 3 for `to_qkv.w`, 2 for `w_in.w`, else 1."""
    if "to_qkv" in path:
        return 3
    if "w_in" in path:
        return 2
    return 1


def param_sharding(mesh: Mesh, path: str, x) -> NamedSharding:
    spec = param_spec(path, x)
    return NamedSharding(mesh, spec, param_parts(path) if spec else 1)


def param_shardings(model, mesh: Mesh) -> dict:
    """{parameter name: NamedSharding} of `model`'s parameters."""
    return {name: param_sharding(mesh, name, p)
            for name, p in model.named_parameters()}


def opt_state_shardings(optimizer, model, mesh: Mesh) -> dict:
    """The placement of an `AdamW`'s state: {"count": replicated, "state":
    {parameter name: {"mu": its sharding, "nu": its sharding}}}. The
    moments follow their parameter (3× the parameter bytes stay sharded);
    the step count is replicated."""
    names = {id(p): n for n, p in model.named_parameters()}
    shardings = param_shardings(model, mesh)
    state = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            state[name] = {"mu": shardings[name], "nu": shardings[name]}
    return {"count": replicated(mesh), "state": state}


def _full_spec(sharding, ndim):
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


def shard_tensor(x, sharding: NamedSharding):
    """This rank's shard of the whole tensor `x`: along each dimension split
    over a mesh axis, block i of each of its `parts` pieces (i this rank's
    index along the axis), the pieces concatenated in order."""
    for dim, axis in enumerate(_full_spec(sharding, x.ndim)):
        size = sharding.mesh.axis_size(axis) if axis else 1
        if size == 1:
            continue
        i = sharding.mesh.index(axis)
        pieces = x.chunk(sharding.parts, dim=dim)
        x = torch.cat([p.chunk(size, dim=dim)[i] for p in pieces], dim=dim)
    return x


def _gather(x, sharding):
    for dim, axis in enumerate(_full_spec(sharding, x.ndim)):
        size = sharding.mesh.axis_size(axis) if axis else 1
        if size == 1:
            continue
        group = sharding.mesh.group(axis)
        check_device(x, group)
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        # rank by rank, each rank's pieces in order → piece by piece
        pieces = [p.chunk(sharding.parts, dim=dim) for p in parts]
        x = torch.cat([pieces[r][k] for k in range(sharding.parts)
                       for r in range(size)], dim=dim)
    return x


class _GatherTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sharding):
        ctx.sharding = sharding
        return _gather(x, sharding)

    @staticmethod
    def backward(ctx, g):
        # every rank of the group computes the same whole-tensor gradient
        # (the layer runs whole on each of them): this rank's shard of it,
        # as GSPMD turns a replicated value into a sharded one
        return shard_tensor(g, ctx.sharding), None


def gather_tensor(x, sharding: NamedSharding):
    """The whole tensor in JAX's layout from the ranks' shards (`x` this
    rank's) — collective over the sharded axes' groups. Backward: this
    rank's shard of the gradient (see `_GatherTensor`)."""
    if sharding.is_fully_replicated:
        return x
    return _GatherTensor.apply(x, sharding)


def is_sharded(p) -> bool:
    """Whether parameter `p` holds only this rank's shard."""
    s = getattr(p, "sharding", None)
    return s is not None and not s.is_fully_replicated


def whole(p):
    """Parameter `p` whole: gathered when it is sharded (a layer's weight
    on a kernel route), else as it is."""
    return gather_tensor(p, p.sharding) if is_sharded(p) else p


def model_group(mesh: Mesh):
    """The mesh's model group where the model axis shards anything, else
    None."""
    return mesh.group("model") if mesh.axis_size("model") > 1 else None


def shard_params(model, mesh: Mesh):
    """Shard `model`'s parameters in place by the rules above: each
    TP-sharded parameter's data becomes this rank's shard (JAX's
    `device_put` of the whole array to its `NamedSharding`), every
    parameter records its placement as `.sharding`, and every transformer
    stack its model group (None where the model axis has size 1). Returns
    `model`."""
    group = model_group(mesh)
    tp = mesh.axis_size("model")
    for m in model.modules():
        if hasattr(m, "model_group"):
            if tp > 1 and (m.heads % tp or any(
                    layer.ff.inner % tp for layer in m.layers)):
                raise ValueError(f"a model axis of {tp} does not divide "
                                 f"{m.heads} heads and the FF inner width")
            m.model_group = group
    with torch.no_grad():
        for name, p in model.named_parameters():
            if getattr(p, "sharding", None) is not None:
                raise ValueError(f"{name} is placed already")
            s = param_sharding(mesh, name, p)
            if not s.is_fully_replicated:
                p.data = shard_tensor(p.data, s).contiguous()
            p.sharding = s
    return model
