"""The collectives of the data-parallel loss — the counterparts of the
`jax.lax` collectives that `xclip_tpu/objectives/contrastive.py` and
`xclip_tpu/model.py` use under `axis_name`, over a `torch.distributed`
`ProcessGroup` (`group`) in place of a mesh axis name.

Each differentiable collective is a `torch.autograd.Function` whose
backward is JAX's transpose. Together they keep one invariant: every rank
computes the same (replicated) global loss from its own rows, and after
the train step's all-reduce (sum) of the parameter gradients every rank
holds d(global loss)/dθ, the single-device gradient on the global batch.

  * `all_gather(x, group, dim)` — `all_gather(x, axis, axis=dim,
    tiled=True)`: the ranks' tensors concatenated along `dim` in rank
    order. Backward: a reduce-scatter (sum) of the incoming gradient along
    `dim`, this rank's slice (JAX's transpose, `psum_scatter`): each
    rank's rows contribute to every rank's columns, so taking only the own
    slice of one rank's gradient would drop the others' contributions.
  * `psum(x, group)` — all-reduce (sum). Backward: the identity, as the
    sum is replicated and each rank differentiates its own copy
    (`torch.distributed.nn.functional.all_reduce` all-reduces the gradient
    again, which gives world × the gradient of a replicated loss; it is not
    used).
  * `pmean(x, group)` — psum / world. Backward: the gradient / world.
  * `pvary(x, group)` — `jax.lax.pvary`: a value that every rank of the
    group holds whole, fed into each rank's own share of the work (the
    input of a column-parallel product; Megatron's *f*). The identity
    forward; backward an all-reduce (sum), as each rank's gradient holds
    only its share's part. `psum` is Megatron's *g* (the row-parallel
    product's output), and `pvary(psum(x))` sums a statistic that each
    rank then uses on its own share (a LayerNorm over a sharded width).
  * `replicated(x, group)` — marks a value that every rank computes whole
    from gathered inputs (the replicated loss; a shard_map output with
    out_specs P()): the identity forward, the gradient / world backward,
    as shard_map divides such an output's cotangent by the axis size, so
    that the gathers' reduce-scatter and the ranks' gradient sum count it
    once.
  * `axis_index(group)`, `axis_size(group)` — this rank and the world size.
  * `all_reduce_sum_(tensors, group)` — the train step's gradient sum, in
    place, one flat all-reduce a dtype (no autograd).

The tensors must lie where the group's backend works: a CUDA tensor under
a gloo group, or a CPU tensor under NCCL, raises `ValueError`; nothing is
staged through the host. Collectives of a gather or a reduce-scatter run
on a contiguous buffer with the gathered dimension first, moved back to
`dim` after (a `(m, b, d)` view gathers on dim 1).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the single-tensor collectives under the name the installed torch gives
# them without a deprecation warning
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def axis_index(group) -> int:
    """This process's rank in `group` (`jax.lax.axis_index`)."""
    return dist.get_rank(group)


def axis_size(group) -> int:
    """The number of ranks in `group` (`jax.lax.psum(1, axis)`)."""
    return dist.get_world_size(group)


def check_device(x, group):
    """Raise `ValueError` when `x` lies where `group`'s backend does not
    work (CUDA under gloo, the CPU under NCCL)."""
    backend = str(dist.get_backend(group))
    if backend == "gloo" and x.is_cuda:
        raise ValueError("a gloo group carries CPU tensors only; this one "
                         f"lies on {x.device} (use an NCCL group on the "
                         "card)")
    if backend == "nccl" and not x.is_cuda:
        raise ValueError("an NCCL group carries CUDA tensors only; this one "
                         f"lies on {x.device} (use a gloo group on the CPU)")


def _gather(x, group, dim):
    check_device(x, group)
    world = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((world * src.shape[0], *src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _all_gather(out, src, group=group)
    return out.movedim(0, dim)


def _scatter_sum(g, group, dim):
    check_device(g, group)
    world = dist.get_world_size(group)
    src = g.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // world, *src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _reduce_scatter(out, src, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def _all_reduce(x, group):
    check_device(x, group)
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim), None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.world = dist.get_world_size(group)
        return _all_reduce(x, group) / ctx.world

    @staticmethod
    def backward(ctx, g):
        return g / ctx.world, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.world = dist.get_world_size(group)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.world, None


def all_gather(x, group, dim: int = 0):
    """The ranks' `x` concatenated along `dim` in rank order; backward a
    reduce-scatter (sum). A bool mask travels as uint8."""
    dim = dim % x.ndim
    if x.dtype == torch.bool:
        return _gather(x.to(torch.uint8), group, dim).bool()
    return _AllGather.apply(x, group, dim)


def psum(x, group):
    """All-reduce (sum) of `x` over `group`; backward the identity."""
    return _PSum.apply(x, group)


def pvary(x, group):
    """`x` as it is; backward the all-reduce (sum) of its gradient over
    `group`."""
    return _PVary.apply(x, group)


def replicated(x, group):
    """`x`, computed whole on every rank of `group`; backward the gradient
    over the world size."""
    return _Replicated.apply(x, group)


def pmean(x, group):
    """All-reduce mean of `x` over `group`; backward the gradient over the
    world size."""
    return _PMean.apply(x, group)


def all_reduce_sum_(tensors, group):
    """Sum each of `tensors` over `group` in place, through one flat buffer
    a dtype (one all-reduce a dtype); returns `tensors`."""
    by_dtype = {}
    for t in tensors:
        check_device(t, group)
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view_as(t))
    return tensors
