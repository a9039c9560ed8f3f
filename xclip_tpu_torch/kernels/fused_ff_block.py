"""The FF block,

    out = x + LN_gin(a · gelu(b)) @ w_out,   [a, b] = LN_gpre(x) @ w_in:

* K-FF, the inference forward `ff_block`, the counterpart of
  `xclip_tpu.kernels.fused_ff_block.ff_block` at inference
  (`_ff_block_fwd_call` → Pallas `_fwd_kernel`);
* K1, the training route `ff_block_train` (`FFBlock`, an autograd
  Function), the counterpart of `ff_block(..., store_h='geglu')`: the
  forward `ff_block_fwd_stored` (Pallas `_fwd_kernel_store_geglu`) keeps
  the GEGLU triple (prod, gelu(b), a·gelu'(b)) in the storage dtype and
  four fp32 row statistics; the backward runs pass 1 `ff_block_bwd_p1`
  (Pallas `_bwd_dx_kernel_geglu`: dx, dprod, dg_pre, dg_inner) and pass 2
  `ff_block_bwd_p2` (Pallas `_bwd_dw_kernel_geglu`: dW_in, dW_out).

The CUDA kernels are `csrc/fused_ff_block.cu`; its source notes give the
designs, what bounds them on the card and which intermediates cross HBM.
Every wrapper takes its kernel for CUDA tensors and its plain version
(`*_plain`, the kernel's cast order in PyTorch) for CPU tensors; it never
falls back from one to the other. The row flatten/pad to 256-row tiles, the
fp32 tile halving, the halved backward tile and the transposed stats
layout of the Pallas version are TPU artefacts: the kernels mask their own
ragged last tile, and the statistics are (4, rows) fp32 rows mean_pre,
inv_pre, mean_in, inv_in.

Pass 1 also hands pass 2 the operands of its dW products (xn, dh2 =
[T(dprod)·gelu(b), T(dprod)·a·gelu'(b)], y2 = T(xhat_in·g_inner)), built as
`_p2_geglu_core` builds them, so pass 2 is its three products alone.
"""

from __future__ import annotations

import math

import torch

from . import _build
from ._common import (check_kernel_args, dot32, dtype_code, eps_for, ln_bwd,
                      ln_stats_fp32, refuse_grad, route, stream_ptr)

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def ff_block_plain(x, g_pre, w_in, g_inner, w_out):
    """Plain PyTorch version, in the kernel's cast order: K1's forward
    without its residuals (the two kernels share every launch)."""
    out, _ = _forward_plain(x.reshape(-1, x.shape[-1]), g_pre, w_in, g_inner,
                            w_out, keep=False)
    return out.reshape(x.shape)


def _check(name, tensors):
    x, g_pre, w_in, g_inner, w_out = tensors
    dim = x.shape[-1]
    inner = w_in.shape[-1] // 2
    check_kernel_args(name, tensors, x.dtype)
    if (g_pre.shape != (dim,) or w_in.shape != (dim, 2 * inner)
            or g_inner.shape != (inner,) or w_out.shape != (inner, dim)):
        raise ValueError(f"{name}: inconsistent shapes {[t.shape for t in tensors]}")
    if dim % 64 or inner % 64:
        raise ValueError(f"{name}: dim {dim} and inner {inner} must be "
                         "multiples of 64 for the kernel")
    return x.numel() // dim, dim, inner


def _fwd_kernel(name, tensors, stored):
    """Launch the forward kernel on (rows, dim) x → (out, residuals or
    None); with `stored`, the K1 residuals as the plain version returns."""
    x = tensors[0]
    rows, dim, inner = _check(name, tensors)
    dev, dt = x.device, x.dtype
    out = torch.empty_like(x)
    xn = torch.empty((rows, dim), dtype=dt, device=dev)
    prod = torch.empty((rows, inner), dtype=torch.float32, device=dev)
    y = torch.empty((rows, inner), dtype=dt, device=dev)
    residuals, residual_ptrs = None, [None] * 4    # None: a null pointer
    if stored:
        residuals = (*(torch.empty((rows, inner), dtype=dt, device=dev)
                       for _ in range(3)),
                     torch.empty((4, rows), dtype=torch.float32, device=dev))
        residual_ptrs = [t.data_ptr() for t in residuals]
    with torch.cuda.device(dev):  # launch on the tensors' card
        err = _build.library().xclip_ff_block_fwd(
            dtype_code(dt),
            *(t.data_ptr() for t in (*tensors, out, xn, prod, y)),
            *residual_ptrs, rows, dim, inner, eps_for(dt), stream_ptr(dev))
    _build.check(err, "xclip_ff_block_fwd")
    return out, residuals


def ff_block(x, g_pre, w_in, g_inner, w_out):
    """x: (..., dim); g_pre: (dim,); w_in: (dim, 2·inner); g_inner: (inner,);
    w_out: (inner, dim). Returns x + FF(LN(x)) in x.dtype. Forward only:
    training goes through `ff_block_train`."""
    tensors = (x, g_pre, w_in, g_inner, w_out)
    refuse_grad("ff_block", tensors, "ff_block_train")
    if not route("ff_block", tensors):
        return ff_block_plain(*tensors)
    out, _ = _fwd_kernel("ff_block", tensors, stored=False)
    ff_block.launches += 1
    return out


ff_block.launches = 0  # kernel launches by ff_block (plain calls not counted)


# ------------------------------------------------------------ K1 forward

def ff_block_fwd_stored_plain(x, g_pre, w_in, g_inner, w_out):
    """x: (rows, dim). Returns (out, (prod, gelu_b, agdb, stats)) in the
    cast order of `_fwd_store_geglu_core`: exact (erf) GELU as b·Φ(b), the
    triple rounded to x.dtype, stats (4, rows) fp32 with mean_in / inv_in
    from the fp32 prod."""
    return _forward_plain(x, g_pre, w_in, g_inner, w_out, keep=True)


def _forward_plain(x, g_pre, w_in, g_inner, w_out, keep):
    dtype = x.dtype
    eps = eps_for(dtype)
    x32 = x.float()
    mean_pre, inv_pre = ln_stats_fp32(x32, eps)
    xn = (((x32 - mean_pre) * inv_pre) * g_pre.float()).to(dtype)
    h = dot32(xn, w_in)
    inner = h.shape[-1] // 2
    a, b = h[:, :inner], h[:, inner:]
    phi = 0.5 * (1.0 + torch.erf(b * _INV_SQRT2))
    gelu_b = b * phi
    prod = a * gelu_b
    mean_in, inv_in = ln_stats_fp32(prod, eps)
    y = (((prod - mean_in) * inv_in) * g_inner.float()).to(dtype)
    out = dot32(y, w_out).to(dtype) + x
    if not keep:
        return out, None
    pdf = torch.exp(-0.5 * b * b) * 0.3989422804014327
    stats = torch.cat([mean_pre, inv_pre, mean_in, inv_in], dim=1).T
    return out, (prod.to(dtype), gelu_b.to(dtype),
                 (a * (phi + b * pdf)).to(dtype), stats.contiguous())


def ff_block_fwd_stored(x, g_pre, w_in, g_inner, w_out):
    """K1 forward on (rows, dim) x: (out, residuals) as the plain version."""
    tensors = (x, g_pre, w_in, g_inner, w_out)
    if not route("ff_block_fwd_stored", tensors):
        return ff_block_fwd_stored_plain(*tensors)
    result = _fwd_kernel("ff_block_fwd_stored", tensors, stored=True)
    ff_block_fwd_stored.launches += 1
    return result


ff_block_fwd_stored.launches = 0


# ------------------------------------------------------------ K1 backward

def ff_block_bwd_p1_plain(x, g_pre, w_in, g_inner, w_out, do, stored):
    """Pass 1 (`_p1_geglu_core`) on (rows, ·) tensors → (dx, dprod, dg_pre,
    dg_inner, (xn, dh2, y2)); pass 2's operands as `_p2_geglu_core` builds
    them. dg_* are cast to the storage dtype."""
    prod, gelu_b, agdb, stats = stored
    dtype = x.dtype
    mp, ip, mi, ii = (stats[i][:, None] for i in range(4))
    xhat_pre = (x.float() - mp) * ip
    xhat_in = (prod.float() - mi) * ii
    gb32, agdb32 = gelu_b.float(), agdb.float()
    dy = dot32(do, w_out.T)
    dprod, dg_inner = ln_bwd(dy, xhat_in, ii, g_inner.float())
    dh = torch.cat([dprod * gb32, dprod * agdb32], dim=-1).to(dtype)
    dxn = dot32(dh, w_in.T)
    dx_pre, dg_pre = ln_bwd(dxn, xhat_pre, ip, g_pre.float())
    dx = (dx_pre + do.float()).to(dtype)
    dprod = dprod.to(dtype)
    dpr = dprod.float()
    xn = (xhat_pre * g_pre.float()).to(dtype)
    dh2 = torch.cat([dpr * gb32, dpr * agdb32], dim=-1).to(dtype)
    y2 = (xhat_in * g_inner.float()).to(dtype)
    return dx, dprod, dg_pre.to(dtype), dg_inner.to(dtype), (xn, dh2, y2)


def ff_block_bwd_p2_plain(xn, dh2, y2, do):
    """Pass 2: (dW_in, dW_out), fp32 sums over every row, cast once."""
    return dot32(xn.T, dh2).to(xn.dtype), dot32(y2.T, do).to(xn.dtype)


def _bwd_workspace(x, inner):
    rows, dim = x.shape
    nbytes = _build.library().xclip_ff_block_bwd_workspace(
        dtype_code(x.dtype), rows, dim, inner)
    return torch.empty(nbytes, dtype=torch.uint8, device=x.device)


def ff_block_bwd_p1(x, g_pre, w_in, g_inner, w_out, do, stored):
    """K1 backward pass 1; returns as `ff_block_bwd_p1_plain`."""
    tensors = (x, g_pre, w_in, g_inner, w_out, do, *stored)
    if not route("ff_block_bwd_p1", tensors):
        return ff_block_bwd_p1_plain(x, g_pre, w_in, g_inner, w_out, do,
                                     stored)
    rows, dim, inner = _check("ff_block_bwd_p1",
                              (x, g_pre, w_in, g_inner, w_out))
    check_kernel_args("ff_block_bwd_p1", (do, *stored[:3]), x.dtype)
    dev, dt = x.device, x.dtype
    dx = torch.empty_like(x)
    dprod, y2 = (torch.empty((rows, inner), dtype=dt, device=dev)
                 for _ in range(2))
    dh2 = torch.empty((rows, 2 * inner), dtype=dt, device=dev)
    xn = torch.empty((rows, dim), dtype=dt, device=dev)
    dg_pre = torch.empty((dim,), dtype=dt, device=dev)
    dg_inner = torch.empty((inner,), dtype=dt, device=dev)
    ws = _bwd_workspace(x, inner)
    with torch.cuda.device(dev):
        err = _build.library().xclip_ff_block_bwd_p1(
            dtype_code(dt), *(t.data_ptr() for t in (
                x, g_pre, w_in, g_inner, w_out, do, *stored, dx, dprod,
                dg_pre, dg_inner, xn, dh2, y2, ws)),
            rows, dim, inner, stream_ptr(dev))
    _build.check(err, "xclip_ff_block_bwd_p1")
    ff_block_bwd_p1.launches += 1
    return dx, dprod, dg_pre, dg_inner, (xn, dh2, y2)


ff_block_bwd_p1.launches = 0


def ff_block_bwd_p2(xn, dh2, y2, do):
    """K1 backward pass 2; returns (dW_in, dW_out) as the plain version."""
    tensors = (xn, dh2, y2, do)
    if not route("ff_block_bwd_p2", tensors):
        return ff_block_bwd_p2_plain(*tensors)
    check_kernel_args("ff_block_bwd_p2", tensors, xn.dtype)
    (rows, dim), inner = xn.shape, y2.shape[1]
    dev, dt = xn.device, xn.dtype
    dw_in = torch.empty((dim, 2 * inner), dtype=dt, device=dev)
    dw_out = torch.empty((inner, dim), dtype=dt, device=dev)
    ws = _bwd_workspace(xn, inner)
    with torch.cuda.device(dev):
        err = _build.library().xclip_ff_block_bwd_p2(
            dtype_code(dt), *(t.data_ptr() for t in (
                xn, dh2, y2, do, dw_in, dw_out, ws)),
            rows, dim, inner, stream_ptr(dev))
    _build.check(err, "xclip_ff_block_bwd_p2")
    ff_block_bwd_p2.launches += 1
    return dw_in, dw_out


ff_block_bwd_p2.launches = 0


def ff_block_bwd_plain(x, g_pre, w_in, g_inner, w_out, do, stored):
    """The whole plain backward → (dx, dg_pre, dW_in, dg_inner, dW_out)."""
    dx, _, dg_pre, dg_inner, ops = ff_block_bwd_p1_plain(
        x, g_pre, w_in, g_inner, w_out, do, stored)
    dw_in, dw_out = ff_block_bwd_p2_plain(*ops, do)
    return dx, dg_pre, dw_in, dg_inner, dw_out


class FFBlock(torch.autograd.Function):
    """K1: the stored-GEGLU FF block, forward and backward kernels."""

    @staticmethod
    def forward(ctx, x, g_pre, w_in, g_inner, w_out):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        out, stored = ff_block_fwd_stored(x2, g_pre, w_in, g_inner, w_out)
        ctx.save_for_backward(x2, g_pre, w_in, g_inner, w_out, *stored)
        ctx.x_shape = x.shape
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dout):
        x2, g_pre, w_in, g_inner, w_out, *stored = ctx.saved_tensors
        do = dout.reshape(x2.shape).to(x2.dtype).contiguous()
        dx, _, dg_pre, dg_inner, ops = ff_block_bwd_p1(
            x2, g_pre, w_in, g_inner, w_out, do, stored)
        dw_in, dw_out = ff_block_bwd_p2(*ops, do)
        return dx.reshape(ctx.x_shape), dg_pre, dw_in, dg_inner, dw_out


def ff_block_train(x, g_pre, w_in, g_inner, w_out):
    """x + FF(LN(x)) with the stored-GEGLU backward; differentiable in all
    five tensors. Same argument layout as `ff_block`."""
    return FFBlock.apply(x, g_pre, w_in, g_inner, w_out)
