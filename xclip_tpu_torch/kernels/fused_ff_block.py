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
  `ff_block_bwd_p2` (Pallas `_bwd_dw_kernel_geglu`: dW_in, dW_out);
* K1-h, the stored-h training route `ff_block_train_stored_h`
  (`FFBlockStoredH`), the counterpart of `ff_block(..., store_h=True)`,
  which `XCLIP_FF_STORE=h` selects: the forward `ff_block_fwd_stored_h`
  (Pallas `_fwd_kernel_store`) keeps h = xn·W_in in the storage dtype and
  the four statistics; pass 1 `ff_block_bwd_p1_stored_h` (Pallas
  `_bwd_dx_kernel_stored`) rebuilds the GEGLU from the rounded h against
  statistics of the fp32 h, the reference's precision quirk
  (`xclip_tpu/kernels/fused_ff_block.py:54-64`), reproduced; pass 2 is
  K1's `ff_block_bwd_p2` on the operands pass 1 hands it (Pallas
  `_bwd_dw_kernel_stored` computes the same three products);
* the memory-lean training route `ff_block_train_recompute`
  (`FFBlockRecompute`), the counterpart of `ff_block(..., store_h=False)`:
  the forward K-FF-s `ff_block_fwd_stats` (Pallas `_fwd_kernel_stats`)
  keeps only the four fp32 row statistics; the backward
  `ff_block_bwd_recompute` recomputes h = xn·W_in in fp32 and gives dx,
  dg_pre, dW_in, dg_inner and dW_out (Pallas `_bwd_dx_kernel` +
  `_bwd_dw_kernel`, or K4's fed and row-chunked pair `_bwd_dx_kernel_fed`
  + `_bwd_dw_kernel_fed`, which compute the same gradients). Both kernels
  walk the rows in chunks under `_common.CHUNK_BYTES` of scratch, the
  backward summing the chunks' dW and dg in chunk order, in fp32, cast
  once; their plain versions take all rows at once.

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

import torch

from . import _build
from ._common import (CHUNK_BYTES, KERNEL_DTYPES, check_kernel_args,
                      chunk_spans, dot32, dtype_code, eps_for, geglu_parts,
                      gelu_grad, ln_bwd, ln_stats_fp32, refuse_grad, route,
                      stream_ptr)
from .rows import MAX_WIDTH

# The recompute backward's row chunks start at multiples of this many rows,
# and its weight gradients sum split-k partials of exactly this many rows in
# row order, so the gradients do not depend on the chunking.
ROW_BLOCK = 2048


def ff_block_plain(x, g_pre, w_in, g_inner, w_out):
    """Plain PyTorch version, in the kernel's cast order: K1's forward
    without its residuals (the two kernels share every launch)."""
    out, _ = _forward_plain(x.reshape(-1, x.shape[-1]), g_pre, w_in, g_inner,
                            w_out, keep=None)
    return out.reshape(x.shape)


def supported(dim: int, inner: int) -> bool:
    """Whether the JAX FF block takes inner width `inner`: its dW pass
    needs a column block of at least 8 that divides it, up to 512
    (`xclip_tpu/kernels/fused_ff_block.py` `pick_block_cols`, `supported`);
    the reference falls back to its plain route otherwise, and so does the
    port."""
    return any(inner % bc == 0 for bc in range(min(512, inner), 7, -1))


def why_not(dim, inner, dtype):
    """Why the CUDA kernels cannot take an FF block of width `dim` and
    inner width `inner` in `dtype` (None if they can): the product
    kernel's 64-wide tiles and the row kernels' widest row. The wrappers
    raise on it before any launch."""
    if dtype not in KERNEL_DTYPES:
        return f"the CUDA FF block takes float32 or bfloat16, not {dtype}"
    if dim % 64 or inner % 64 or max(dim, inner) > MAX_WIDTH:
        return (f"the CUDA FF block takes dim and inner width multiples of "
                f"64 up to {MAX_WIDTH}, not dim {dim}, inner {inner}")
    return None


def _check(name, tensors):
    x, g_pre, w_in, g_inner, w_out = tensors
    dim = x.shape[-1]
    inner = w_in.shape[-1] // 2
    check_kernel_args(name, tensors, x.dtype)
    if (g_pre.shape != (dim,) or w_in.shape != (dim, 2 * inner)
            or g_inner.shape != (inner,) or w_out.shape != (inner, dim)):
        raise ValueError(f"{name}: inconsistent shapes {[t.shape for t in tensors]}")
    reason = why_not(dim, inner, x.dtype)
    if reason:
        raise ValueError(f"{name}: {reason}")
    return x.numel() // dim, dim, inner


def _fwd_scratch(rows, dim, inner, dtype, device):
    """The forward launches' scratch for `rows` rows: xn, the fp32 prod, y."""
    return (torch.empty((rows, dim), dtype=dtype, device=device),
            torch.empty((rows, inner), dtype=torch.float32, device=device),
            torch.empty((rows, inner), dtype=dtype, device=device))


def _fwd_kernel(name, tensors, keep):
    """Launch the forward kernel on (rows, dim) x → (out, residuals or
    None); `keep` "geglu" (K1) or "h" (K1-h): the residuals as the plain
    version returns them."""
    x = tensors[0]
    rows, dim, inner = _check(name, tensors)
    dev, dt = x.device, x.dtype
    out = torch.empty_like(x)
    xn, prod, y = _fwd_scratch(rows, dim, inner, dt, dev)
    # the C entry point's prod_s, gb, agdb, h_s, stats (None: a null pointer)
    residuals, residual_ptrs = None, [None] * 5
    if keep is not None:
        stats = torch.empty((4, rows), dtype=torch.float32, device=dev)
        if keep == "geglu":
            residuals = (*(torch.empty((rows, inner), dtype=dt, device=dev)
                           for _ in range(3)), stats)
            residual_ptrs = [*(t.data_ptr() for t in residuals[:3]), None,
                             stats.data_ptr()]
        else:
            residuals = (torch.empty((rows, 2 * inner), dtype=dt,
                                     device=dev), stats)
            residual_ptrs = [None, None, None, residuals[0].data_ptr(),
                             stats.data_ptr()]
    with torch.cuda.device(dev):  # launch on the tensors' card
        err = _build.library().xclip_ff_block_fwd(
            dtype_code(dt),
            *(t.data_ptr() for t in (*tensors, out, xn, prod, y)),
            *residual_ptrs, rows, rows, dim, inner, eps_for(dt),
            stream_ptr(dev))
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
    out, _ = _fwd_kernel("ff_block", tensors, keep=None)
    ff_block.launches += 1
    return out


ff_block.launches = 0  # kernel launches by ff_block (plain calls not counted)


# ------------------------------------------------------------ K1 forward

def ff_block_fwd_stored_plain(x, g_pre, w_in, g_inner, w_out):
    """x: (rows, dim). Returns (out, (prod, gelu_b, agdb, stats)) in the
    cast order of `_fwd_store_geglu_core`: exact (erf) GELU as b·Φ(b), the
    triple rounded to x.dtype, stats (4, rows) fp32 with mean_in / inv_in
    from the fp32 prod."""
    return _forward_plain(x, g_pre, w_in, g_inner, w_out, keep="geglu")


def _forward_plain(x, g_pre, w_in, g_inner, w_out, keep):
    """keep None: (out, None); "stats": (out, stats); "geglu": (out,
    (prod, gelu_b, agdb, stats)); "h": (out, (h, stats))."""
    dtype = x.dtype
    eps = eps_for(dtype)
    x32 = x.float()
    mean_pre, inv_pre = ln_stats_fp32(x32, eps)
    xn = (((x32 - mean_pre) * inv_pre) * g_pre.float()).to(dtype)
    h = dot32(xn, w_in)
    a, b, phi, gelu_b = geglu_parts(h)
    prod = a * gelu_b
    mean_in, inv_in = ln_stats_fp32(prod, eps)
    y = (((prod - mean_in) * inv_in) * g_inner.float()).to(dtype)
    out = dot32(y, w_out).to(dtype) + x
    if keep is None:
        return out, None
    stats = torch.cat([mean_pre, inv_pre, mean_in, inv_in], dim=1).T
    if keep == "stats":
        return out, stats.contiguous()
    if keep == "h":
        return out, (h.to(dtype), stats.contiguous())
    return out, (prod.to(dtype), gelu_b.to(dtype),
                 (a * gelu_grad(b, phi)).to(dtype), stats.contiguous())


def ff_block_fwd_stored(x, g_pre, w_in, g_inner, w_out):
    """K1 forward on (rows, dim) x: (out, residuals) as the plain version."""
    tensors = (x, g_pre, w_in, g_inner, w_out)
    if not route("ff_block_fwd_stored", tensors):
        return ff_block_fwd_stored_plain(*tensors)
    result = _fwd_kernel("ff_block_fwd_stored", tensors, keep="geglu")
    ff_block_fwd_stored.launches += 1
    return result


ff_block_fwd_stored.launches = 0


# ------------------------------------------------------------ K1 backward

def ff_block_bwd_p1_plain(x, g_pre, w_in, g_inner, w_out, do, stored):
    """Pass 1 (`_p1_geglu_core`) on (rows, ·) tensors → (dx, dprod, dg_pre,
    dg_inner, (xn, dh2, y2)); pass 2's operands as `_p2_geglu_core` builds
    them. dg_* are cast to the storage dtype."""
    prod, gelu_b, agdb, stats = stored
    xhat_in = (prod.float() - stats[2][:, None]) * stats[3][:, None]
    return _p1_plain(x, g_pre, w_in, g_inner, w_out, do, stats, xhat_in,
                     gelu_b.float(), agdb.float())


def _p1_plain(x, g_pre, w_in, g_inner, w_out, do, stats, xhat_in, gb32,
              agdb32):
    """Pass 1 of both stored backwards from xhat_in, gelu(b) and
    a·gelu'(b) in fp32, however the caller rebuilt them."""
    dtype = x.dtype
    mp, ip, ii = stats[0][:, None], stats[1][:, None], stats[3][:, None]
    xhat_pre = (x.float() - mp) * ip
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
    dx, dprod, dg_pre, dg_inner, ops = _p1_outputs(rows, dim, inner,
                                                   x.dtype, x.device)
    ws = _bwd_workspace(x, inner)
    with torch.cuda.device(x.device):
        err = _build.library().xclip_ff_block_bwd_p1(
            dtype_code(x.dtype), *(t.data_ptr() for t in (
                x, g_pre, w_in, g_inner, w_out, do, *stored, dx, dprod,
                dg_pre, dg_inner, *ops, ws)),
            rows, dim, inner, stream_ptr(x.device))
    _build.check(err, "xclip_ff_block_bwd_p1")
    ff_block_bwd_p1.launches += 1
    return dx, dprod, dg_pre, dg_inner, ops


def _p1_outputs(rows, dim, inner, dt, dev):
    """Pass 1's outputs: dx, dprod, dg_pre, dg_inner, (xn, dh2, y2)."""
    def new(*shape):
        return torch.empty(shape, dtype=dt, device=dev)
    return (new(rows, dim), new(rows, inner), new(dim), new(inner),
            (new(rows, dim), new(rows, 2 * inner), new(rows, inner)))


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


# ------------------------------------------------------------ K1-h

def ff_block_fwd_stored_h_plain(x, g_pre, w_in, g_inner, w_out):
    """x: (rows, dim). Returns (out, (h, stats)) in the cast order of
    `_fwd_store_core`: h = xn·W_in rounded to x.dtype (rows, 2·inner),
    stats (4, rows) fp32 with mean_in / inv_in from the fp32 prod."""
    return _forward_plain(x, g_pre, w_in, g_inner, w_out, keep="h")


def ff_block_fwd_stored_h(x, g_pre, w_in, g_inner, w_out):
    """K1-h forward on (rows, dim) x: (out, (h, stats)) as the plain
    version."""
    tensors = (x, g_pre, w_in, g_inner, w_out)
    if not route("ff_block_fwd_stored_h", tensors):
        return ff_block_fwd_stored_h_plain(*tensors)
    result = _fwd_kernel("ff_block_fwd_stored_h", tensors, keep="h")
    ff_block_fwd_stored_h.launches += 1
    return result


ff_block_fwd_stored_h.launches = 0


def ff_block_bwd_p1_stored_h_plain(x, g_pre, w_in, g_inner, w_out, do,
                                   stored):
    """Pass 1 (`_p1_stored_core`) → as `ff_block_bwd_p1_plain`. prod,
    gelu(b) and a·gelu'(b) are rebuilt from the rounded h, xhat_in from the
    forward's statistics of the fp32 h (the reference's precision quirk);
    dh2 from T(dprod), as `_p2_stored_core` builds it."""
    h, stats = stored
    a, b, phi, gelu_b = geglu_parts(h.float())
    xhat_in = (a * gelu_b - stats[2][:, None]) * stats[3][:, None]
    return _p1_plain(x, g_pre, w_in, g_inner, w_out, do, stats, xhat_in,
                     gelu_b, a * gelu_grad(b, phi))


def ff_block_bwd_p1_stored_h(x, g_pre, w_in, g_inner, w_out, do, stored):
    """K1-h backward pass 1; returns as the plain version. Pass 2 is K1's
    `ff_block_bwd_p2` on the operands it returns."""
    tensors = (x, g_pre, w_in, g_inner, w_out, do, *stored)
    if not route("ff_block_bwd_p1_stored_h", tensors):
        return ff_block_bwd_p1_stored_h_plain(x, g_pre, w_in, g_inner,
                                              w_out, do, stored)
    rows, dim, inner = _check("ff_block_bwd_p1_stored_h",
                              (x, g_pre, w_in, g_inner, w_out))
    h, stats = stored
    check_kernel_args("ff_block_bwd_p1_stored_h", (do, h), x.dtype)
    check_kernel_args("ff_block_bwd_p1_stored_h", (stats,), torch.float32)
    if h.shape != (rows, 2 * inner) or stats.shape != (4, rows):
        raise ValueError("ff_block_bwd_p1_stored_h: h or stats of shape "
                         f"{tuple(h.shape)}, {tuple(stats.shape)}")
    dx, dprod, dg_pre, dg_inner, ops = _p1_outputs(rows, dim, inner,
                                                   x.dtype, x.device)
    ws = _bwd_workspace(x, inner)
    with torch.cuda.device(x.device):
        err = _build.library().xclip_ff_block_bwd_p1_h(
            dtype_code(x.dtype), *(t.data_ptr() for t in (
                x, g_pre, w_in, g_inner, w_out, do, h, stats, dx, dprod,
                dg_pre, dg_inner, *ops, ws)),
            rows, dim, inner, stream_ptr(x.device))
    _build.check(err, "xclip_ff_block_bwd_p1_h")
    ff_block_bwd_p1_stored_h.launches += 1
    return dx, dprod, dg_pre, dg_inner, ops


ff_block_bwd_p1_stored_h.launches = 0


class FFBlockStoredH(torch.autograd.Function):
    """K1-h: the stored-h FF block, forward and backward kernels."""

    @staticmethod
    def forward(ctx, x, g_pre, w_in, g_inner, w_out):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        out, stored = ff_block_fwd_stored_h(x2, g_pre, w_in, g_inner, w_out)
        ctx.save_for_backward(x2, g_pre, w_in, g_inner, w_out, *stored)
        ctx.x_shape = x.shape
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dout):
        x2, g_pre, w_in, g_inner, w_out, *stored = ctx.saved_tensors
        do = dout.reshape(x2.shape).to(x2.dtype).contiguous()
        dx, _, dg_pre, dg_inner, ops = ff_block_bwd_p1_stored_h(
            x2, g_pre, w_in, g_inner, w_out, do, stored)
        dw_in, dw_out = ff_block_bwd_p2(*ops, do)
        return dx.reshape(ctx.x_shape), dg_pre, dw_in, dg_inner, dw_out


def ff_block_train_stored_h(x, g_pre, w_in, g_inner, w_out):
    """x + FF(LN(x)) keeping h = xn·W_in (storage dtype) and the row
    statistics for the backward (`ff_block(..., store_h=True)`, which
    `XCLIP_FF_STORE=h` selects); differentiable in all five tensors. Same
    argument layout as `ff_block`."""
    return FFBlockStoredH.apply(x, g_pre, w_in, g_inner, w_out)


# ------------------------------------------- K-FF-s and the recompute backward

def fwd_stats_spans(rows, dim, inner, dtype):
    """K-FF-s's row chunks: [(start, stop), ...] whose scratch
    (`_fwd_scratch`) stays under CHUNK_BYTES."""
    return chunk_spans(rows, lambda k: sum(t.nbytes for t in _fwd_scratch(
        k, dim, inner, dtype, "meta")), CHUNK_BYTES)


def bwd_recompute_spans(rows, dim, inner, dtype):
    """The recompute backward's row chunks: [(start, stop), ...] starting
    at multiples of ROW_BLOCK whose workspace (the CUDA entry point's
    query) stays under CHUNK_BYTES. Needs the built library."""
    lib = _build.library()
    return chunk_spans(
        rows, lambda k: lib.xclip_ff_block_bwd_recompute_workspace(
            dtype_code(dtype), k, dim, inner, ROW_BLOCK), CHUNK_BYTES,
        ROW_BLOCK)


def ff_block_fwd_stats_plain(x, g_pre, w_in, g_inner, w_out):
    """x: (rows, dim) → (out, stats (4, rows) fp32: mean_pre, inv_pre,
    mean_in, inv_in), in the cast order of `_fwd_kernel_stats`."""
    return _forward_plain(x, g_pre, w_in, g_inner, w_out, keep="stats")


def ff_block_fwd_stats(x, g_pre, w_in, g_inner, w_out):
    """K-FF-s on (rows, dim) x: (out, stats) as the plain version. The
    kernel takes the rows in chunks (`fwd_stats_spans`), so its xn, fp32
    prod and y scratch stays under CHUNK_BYTES."""
    tensors = (x, g_pre, w_in, g_inner, w_out)
    if not route("ff_block_fwd_stats", tensors):
        return ff_block_fwd_stats_plain(*tensors)
    rows, dim, inner = _check("ff_block_fwd_stats", tensors)
    dev, dt = x.device, x.dtype
    out = torch.empty_like(x)
    stats = torch.empty((4, rows), dtype=torch.float32, device=dev)
    spans = fwd_stats_spans(rows, dim, inner, dt)
    xn, prod, y = _fwd_scratch(spans[0][1] if spans else 0, dim, inner, dt,
                               dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        for s, e in spans:
            err = lib.xclip_ff_block_fwd(
                dtype_code(dt), x[s:].data_ptr(),
                *(t.data_ptr() for t in tensors[1:]), out[s:].data_ptr(),
                xn.data_ptr(), prod.data_ptr(), y.data_ptr(), None, None,
                None, None, stats[0, s:].data_ptr(), rows, e - s, dim, inner,
                eps_for(dt), stream_ptr(dev))
            _build.check(err, "xclip_ff_block_fwd")
    ff_block_fwd_stats.launches += 1
    return out, stats


ff_block_fwd_stats.launches = 0


def ff_block_bwd_recompute_plain(x, g_pre, w_in, g_inner, w_out, do, stats):
    """`_p1_recompute_core` and the fed pass 2 on (rows, ·) rows, all rows
    at once; returns as `ff_block_bwd_recompute`, the sums over the rows
    in fp32 and cast once. h stays fp32; dh is rounded once and feeds both
    the dx product and dW_in."""
    dtype = x.dtype
    mp, ip, mi, ii = (stats[i][:, None] for i in range(4))
    xhat_pre = (x.float() - mp) * ip
    xn = (xhat_pre * g_pre.float()).to(dtype)
    a, b, phi, gelu_b = geglu_parts(dot32(xn, w_in))
    xhat_in = (a * gelu_b - mi) * ii
    dy = dot32(do, w_out.T)
    dprod, dg_inner = ln_bwd(dy, xhat_in, ii, g_inner.float())
    dh = torch.cat([dprod * gelu_b, dprod * a * gelu_grad(b, phi)],
                   dim=-1).to(dtype)
    y = (xhat_in * g_inner.float()).to(dtype)
    dx_pre, dg_pre = ln_bwd(dot32(dh, w_in.T), xhat_pre, ip, g_pre.float())
    dx = (dx_pre + do.float()).to(dtype)
    return (dx, *(t.to(dtype) for t in (dg_pre, dot32(xn.T, dh), dg_inner,
                                        dot32(y.T, do))))


def ff_block_bwd_recompute(x, g_pre, w_in, g_inner, w_out, do, stats):
    """The recompute backward from (rows, dim) x, do and K-FF-s's stats →
    (dx, dg_pre, dW_in, dg_inner, dW_out) in x.dtype. The kernel takes the
    rows in chunks (`bwd_recompute_spans`) whose workspace stays under
    CHUNK_BYTES; the chunks' fp32 sums are added in chunk order and cast
    once."""
    tensors = (x, g_pre, w_in, g_inner, w_out, do, stats)
    if not route("ff_block_bwd_recompute", tensors):
        return ff_block_bwd_recompute_plain(*tensors)
    rows, dim, inner = _check("ff_block_bwd_recompute", tensors[:5])
    check_kernel_args("ff_block_bwd_recompute", (do,), x.dtype)
    check_kernel_args("ff_block_bwd_recompute", (stats,), torch.float32)
    spans = bwd_recompute_spans(rows, dim, inner, x.dtype)
    dx = torch.empty_like(x)
    dev, dt = x.device, x.dtype
    sums = [torch.empty(shape, dtype=torch.float32, device=dev)
            for shape in ((dim,), (dim, 2 * inner), (inner,),
                          (inner, dim))]
    lib = _build.library()
    ws = torch.empty(lib.xclip_ff_block_bwd_recompute_workspace(
        dtype_code(dt), spans[0][1], dim, inner, ROW_BLOCK),
        dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        for k, (s, e) in enumerate(spans):
            err = lib.xclip_ff_block_bwd_recompute(
                dtype_code(dt), x[s:].data_ptr(),
                *(t.data_ptr() for t in tensors[1:5]), do[s:].data_ptr(),
                stats[0, s:].data_ptr(), rows, dx[s:].data_ptr(),
                *(t.data_ptr() for t in sums), ws.data_ptr(), e - s,
                dim, inner, ROW_BLOCK, eps_for(dt), 1 if k == 0 else 2,
                stream_ptr(dev))
            _build.check(err, "xclip_ff_block_bwd_recompute")
    ff_block_bwd_recompute.launches += 1
    return (dx, *(t.to(x.dtype) for t in sums))


ff_block_bwd_recompute.launches = 0


class FFBlockRecompute(torch.autograd.Function):
    """The memory-lean FF block: K-FF-s forward, recompute backward."""

    @staticmethod
    def forward(ctx, x, g_pre, w_in, g_inner, w_out):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        out, stats = ff_block_fwd_stats(x2, g_pre, w_in, g_inner, w_out)
        ctx.save_for_backward(x2, g_pre, w_in, g_inner, w_out, stats)
        ctx.x_shape = x.shape
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dout):
        x2, g_pre, w_in, g_inner, w_out, stats = ctx.saved_tensors
        do = dout.reshape(x2.shape).to(x2.dtype).contiguous()
        dx, *grads = ff_block_bwd_recompute(x2, g_pre, w_in, g_inner, w_out,
                                            do, stats)
        return (dx.reshape(ctx.x_shape), *grads)


def ff_block_train_recompute(x, g_pre, w_in, g_inner, w_out):
    """x + FF(LN(x)) keeping only the row statistics for the backward,
    which recomputes h; differentiable in all five tensors. Same argument
    layout as `ff_block`."""
    return FFBlockRecompute.apply(x, g_pre, w_in, g_inner, w_out)
