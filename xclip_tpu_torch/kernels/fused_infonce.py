"""K5, the streaming log-sum-exp of the InfoNCE loss — the counterpart of
`xclip_tpu.kernels.fused_infonce.streaming_lse`:

    lse[r] = log Σ_c exp(x[r]·y[c])   (with `decoupled`, c == r + row_offset
                                       is left out: decoupled contrastive
                                       learning's diagonal)

without the (R, C) score matrix in device memory. Callers pre-scale the
rows by the temperature, so d/d(temperature) flows through that product
by autograd and the kernels only need the two matrix cotangents:

    dx[r] = dlse[r]·Σ_c p[r, c]·y[c],   dy[c] = Σ_r p[r, c]·dlse[r]·x[r],
    p[r, c] = exp(x[r]·y[c] − lse[r])  (0 on a masked column).

`streaming_lse` (`StreamingLSE`, an autograd Function) casts both inputs
to fp32 as the Pallas version does, runs the forward `streaming_lse_fwd`
(Pallas `_lse_kernel`) and the backward `streaming_lse_bwd` (Pallas
`_dx_kernel` and `_dy_kernel`), and casts the gradients back to the input
dtypes. The CUDA kernels are `csrc/fused_infonce.cu`, register-tiled fp32
products: the forward computes each row's (m, l) over fixed ranges of
columns and merges the ranges in order (`fwd_plan`; a call launches the
product and the merge); the backward computes p once a chunk of columns
into a bounded scratch and takes dx and dy from it by products over fixed
ranges, summed in order (`bwd_plan`). Each wrapper takes its kernel for
CUDA tensors and its plain version (`*_plain`) for CPU tensors, and never
falls back from one to the other. `row_offset` is the global column of
row 0's diagonal, for a row shard of a gathered batch.
"""

from __future__ import annotations

import math

import torch

from . import _build
from ._common import route, stream_ptr

P_BYTES = 1 << 26  # the backward's scores scratch, R x (a chunk of columns)
SLICE = 8          # the backward products' k-slice (csrc GBK)
TILE = 128         # their output tile (csrc GBM, GBN)
SLOTS = 2 * 132    # their blocks in flight: two an SM on 132 SMs


def _fill(work: int) -> float:
    """The share of the card's SLOTS that `work` blocks keep busy over
    their waves."""
    return work / (math.ceil(work / SLOTS) * SLOTS)


def _ranges(tiles: int, length: int) -> int:
    """The k-range of a product with `tiles` output tiles over a reduction
    of `length`: the fewest ranges whose blocks fill the card's SLOTS to
    within 10 % in their last wave (else the fullest), ranges of at least
    256 and a multiple of SLICE."""
    most = max(1, length // 256)
    best, parts = 0.0, 1
    for p in range(1, most + 1):
        fill = _fill(tiles * p)
        if fill > best + 1e-9:
            best, parts = fill, p
        if fill >= 0.9:
            break
    return math.ceil(math.ceil(length / parts) / SLICE) * SLICE


def fwd_plan(R: int, C: int) -> int:
    """The columns each block of the forward walks: whole TILE-column
    tiles, in the fewest ranges whose (row tile, range) blocks fill the
    card's SLOTS to within 10 % (else the fullest), as `_ranges` fills the
    backward's products. 16 ranges of one tile at R = C = 2048."""
    row_tiles, col_tiles = math.ceil(R / TILE), math.ceil(C / TILE)
    best, span = 0.0, col_tiles
    for p in range(1, col_tiles + 1):
        per = math.ceil(col_tiles / p)
        if math.ceil(col_tiles / per) != p:
            continue  # no split into p ranges of whole tiles
        fill = _fill(row_tiles * p)
        if fill > best + 1e-9:
            best, span = fill, per
        if fill >= 0.9:
            break
    return span * TILE


def bwd_plan(R: int, C: int, d: int):
    """(cc, kx, ky) of the backward kernels: chunks of cc columns, whose
    R x cc scores stay under P_BYTES (all C when they fit); dx's product
    over a chunk in column ranges of kx, dy's over the rows in ranges of
    ky, each range an fp32 partial summed in order."""
    cc = C if R * C * 4 <= P_BYTES else max(
        TILE, P_BYTES // (4 * R) // TILE * TILE)
    cc = min(cc, C)
    d_tiles = math.ceil(d / TILE)
    kx = _ranges(math.ceil(R / TILE) * d_tiles, cc)
    ky = _ranges(math.ceil(cc / TILE) * d_tiles, R)
    return cc, kx, ky


def _scores_plain(x, y, row_offset, decoupled):
    """fp32 scores (R, C) and the validity mask (None: all valid)."""
    s = x @ y.T
    if not decoupled:
        return s, None
    cols = torch.arange(y.shape[0], device=x.device)
    rows = torch.arange(x.shape[0], device=x.device) + int(row_offset)
    valid = cols[None, :] != rows[:, None]
    return s.masked_fill(~valid, float("-inf")), valid


def streaming_lse_fwd_plain(x, y, row_offset=0, decoupled=False):
    """fp32 (R, d), (C, d) → lse (R,) fp32: m = 0 on a row whose every
    column is masked, and the sum clamped at 1e-30 (`_lse_kernel`)."""
    s, _ = _scores_plain(x, y, row_offset, decoupled)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m == float("-inf"), 0.0, m)
    l = torch.exp(s - m).sum(dim=-1, keepdim=True)
    return (m + torch.log(l.clamp_min(1e-30))).squeeze(-1)


def streaming_lse_bwd_plain(x, y, lse, dlse, row_offset=0, decoupled=False):
    """fp32 → (dx (R, d), dy (C, d)) fp32, p rebuilt from the stored lse."""
    s, valid = _scores_plain(x, y, row_offset, decoupled)
    p = torch.exp(s - lse[:, None])
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    return (p @ y) * dlse[:, None], p.T @ (x * dlse[:, None])


def _check(name, tensors):
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name}: the kernel takes contiguous float32")


def streaming_lse_fwd(x, y, row_offset=0, decoupled=False):
    """K5 forward on fp32 x (R, d), y (C, d) → lse (R,) fp32."""
    if not route("streaming_lse_fwd", (x, y)):
        return streaming_lse_fwd_plain(x, y, row_offset, decoupled)
    (R, d), C = x.shape, y.shape[0]
    _check("streaming_lse_fwd", (x, y))
    span = fwd_plan(R, C)
    lse = torch.empty(R, dtype=torch.float32, device=x.device)
    ml = torch.empty(2 * math.ceil(C / span) * R, dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().xclip_lse_fwd(
            x.data_ptr(), y.data_ptr(), lse.data_ptr(), ml.data_ptr(), R, C,
            d, span, int(row_offset), int(decoupled), stream_ptr(x.device))
    _build.check(err, "xclip_lse_fwd")
    streaming_lse_fwd.launches += 1
    return lse


streaming_lse_fwd.launches = 0  # calls on CUDA: each the product and merge


def streaming_lse_bwd(x, y, lse, dlse, row_offset=0, decoupled=False):
    """K5 backward (the dx and dy kernels) → (dx, dy) fp32."""
    tensors = (x, y, lse, dlse)
    if not route("streaming_lse_bwd", tensors):
        return streaming_lse_bwd_plain(x, y, lse, dlse, row_offset, decoupled)
    (R, d), C = x.shape, y.shape[0]
    _check("streaming_lse_bwd", tensors)
    cc, kx, ky = bwd_plan(R, C, d)
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    p = torch.empty(R * cc, dtype=torch.float32, device=x.device)
    part = torch.empty(max(-(-cc // kx) * R, -(-R // ky) * cc) * d,
                       dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().xclip_lse_bwd(
            *(t.data_ptr() for t in (*tensors, dx, dy, p, part)), R, C, d,
            cc, kx, ky, int(row_offset), int(decoupled),
            stream_ptr(x.device))
    _build.check(err, "xclip_lse_bwd")
    streaming_lse_bwd.launches += 1
    return dx, dy


streaming_lse_bwd.launches = 0


class StreamingLSE(torch.autograd.Function):
    """K5 forward and backward; the gradients in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, y, row_offset, decoupled):
        x32, y32 = x.float().contiguous(), y.float().contiguous()
        lse = streaming_lse_fwd(x32, y32, row_offset, decoupled)
        ctx.save_for_backward(x32, y32, lse)
        ctx.static = (row_offset, decoupled)
        ctx.dtypes = (x.dtype, y.dtype)
        return lse

    @staticmethod
    def backward(ctx, dlse):
        x32, y32, lse = ctx.saved_tensors
        dx, dy = streaming_lse_bwd(x32, y32, lse, dlse.float().contiguous(),
                                   *ctx.static)
        return dx.to(ctx.dtypes[0]), dy.to(ctx.dtypes[1]), None, None


def streaming_lse(x, y, row_offset=0, decoupled=False):
    """`lse[r] = logsumexp_c(x[r]·y[c])` without the (R, C) score matrix;
    `x` rows already carry the temperature. Differentiable in x and y."""
    return StreamingLSE.apply(x, y, row_offset, decoupled)
