"""The LayerNorm row kernels (forward and backward) and the GEGLU-backward
row kernel alone, mode by mode.

The FF blocks (K-FF, K1, K1-h, K-FF-s, the recompute backward), K8 and the
attention megablock launch these kernels inside their own entry points
(`csrc/row_kernels.cuh`); `ln_rows`, `geglu_bwd_rows` and `ln_bwd_rows`
call them alone, for tests and timing, through `csrc/rows.cu`.

`ln_rows(mode, x, g, resid=None, eps=None)`, the gain-only LayerNorm over
rows with two-pass fp32 statistics (`xclip_tpu/nn/core.py`
`layer_norm_apply`), out = T(LN_g(x)) in g's dtype T, x fp32 or of T:

* "plain": → (out,) (the recompute backwards' pre-LayerNorms, K-FF's);
* "stats": → (out, mean, inv), each row's fp32 mean and rsqrt(var + eps)
  (the training forwards' pre-LayerNorms and K-FF-s's inner one);
* "residual": out = T(LN_g(x)) + resid, the add in T, → (out, mean, inv)
  (the megablock's out LayerNorm, x its fp32 projection);
* "in_copy": → (out, mean, inv, T(x)) (K1's inner LayerNorm, keeping the
  rounded product);
* "geglu": x = [a, b] (rows, 2d) of T, the row a·gelu(b) (K8's forward)
  → (out,).

`geglu_bwd_rows(mode, dy, h, g, stats, eps)`, the GEGLU and inner-LayerNorm
backward from h = [a, b] (rows, 2d):

* "recompute" (`kGegluRecompute`; `_p1_recompute_core`): fp32 dy and h, the
  forward's stored (mean, inv) → (dh, y, dg_part);
* "k8" (`kGegluLn`; `fused_ff.py` `_bwd_kernel`): dy and h in the storage
  dtype, the statistics recomputed from h with `eps` → (dh, dg_part);
* "stored_h" (`kGegluStoredH`; `_p1_stored_core`): fp32 dy, h in the
  storage dtype, stored (mean, inv) → (dh, y, dprod, dh2, dg_part), dh2
  the same dh from the rounded dprod (in fp32 dh2 is dh itself).

`ln_bwd_rows(mode, dy, v, g, stats, ...)`, the gain-only LayerNorm vjp
from stored (mean, inv) (`_common.py` `ln_bwd`):

* "ln" (`kLnBwd`): dy fp32 or in the storage dtype, v in either →
  (out, xn, dg_part), out = T(vjp + resid) (resid optional), xn = T(xhat
  · g) when `xn_out` (else None);
* "geglu" (`kLnBwdGeglu`; `_p1_geglu_core`): fp32 dy, the stored product
  v and its gb = gelu(b), agdb = a·gelu'(b) → (dprod, dh, dh2, y, dg_part).

g, resid, gb, agdb and the outputs are of g's dtype. dg_part (fp32,
(ceil(rows / 64), d)) holds one column sum of dy·xhat per 64-row block,
its rows added in order; `matmul.ordered_sum` adds the blocks in order,
as the kernels' callers do (`reduce_parts`: the ordered sums of
`csrc/common.cuh` alone, every backward's dg and split-k sums; their
launches from every caller by regime and width: `sum_launches`).
Widths: any up to 8,192 (16-byte vectors where the width is a multiple
of 8 and every tensor 16-byte aligned, element by element otherwise); a
wider row raises.

Each wrapper takes its kernel for CUDA tensors and its plain version
(`*_plain`, the kernels' rounding points in PyTorch) for CPU tensors; on a
CUDA tensor it launches the kernel or raises. `.launches` counts a
wrapper's own launches; the kernels' launches from every caller are
counted in the library, mode by mode (`kernel_launches`).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._common import (KERNEL_DTYPES, dtype_code, eps_for, geglu_parts,
                      gelu_grad, ln_bwd, ln_stats_fp32, route, stream_ptr)
from .matmul import ordered_sum

GEGLU_MODES = {"recompute": 0, "k8": 1, "stored_h": 2}
LN_MODES = {"ln": 0, "geglu": 1}
LN_FWD_MODES = ("plain", "stats", "residual", "in_copy", "geglu")
# the library's launch counters (csrc/rows.cu xclip_rows_launches), in
# order: the backward kernels' modes (those with dg partials), then the
# LayerNorm forward's
COUNTERS = (("geglu", "recompute"), ("geglu", "k8"), ("geglu", "stored_h"),
            ("ln", "ln"), ("ln", "geglu"))
LN_FWD_COUNTERS = tuple(("ln_fwd", m) for m in LN_FWD_MODES)
ROW_BLOCK = 64     # rows of one dg partial (csrc/row_kernels.cuh kBwdRows)
MAX_WIDTH = 8192   # kRowMaxWidth


def blocks(rows: int) -> int:
    """dg partials of `rows` rows: one per 64-row block."""
    return -(-rows // ROW_BLOCK)


def partials(t):
    """(rows, d) fp32 → (blocks, d): each 64-row block's column sums, its
    rows added in row order (the kernels add them in another fixed order;
    a block's sum does not depend on the rows around it)."""
    rows, d = t.shape
    pad = blocks(rows) * ROW_BLOCK - rows
    if pad:
        t = torch.cat([t, t.new_zeros(pad, d)])
    t = t.view(-1, ROW_BLOCK, d)
    total = t[:, 0].clone()
    for i in range(1, ROW_BLOCK):
        total += t[:, i]
    return total


def ln_rows_plain(mode, x, g, resid=None, eps=None):
    """Plain PyTorch version of `ln_rows`; returns as it does."""
    dt = g.dtype
    if mode == "geglu":
        a, _, _, gelu_b = geglu_parts(x.float())
        v = a * gelu_b
    else:
        v = x.float()
    mean, inv = ln_stats_fp32(v, eps_for(dt) if eps is None else eps)
    out = (((v - mean) * inv) * g.float()).to(dt)
    if mode == "residual":
        out = (out.float() + resid.float()).to(dt)
    if mode in ("plain", "geglu"):
        return (out,)
    stats = (mean[:, 0], inv[:, 0])
    return (out, *stats, v.to(dt)) if mode == "in_copy" else (out, *stats)


def geglu_bwd_rows_plain(mode, dy, h, g, stats=None, eps=None):
    """Plain PyTorch version of `geglu_bwd_rows`; returns as it does."""
    dt = g.dtype
    a, b, phi, gelu_b = geglu_parts(h.float())
    prod = a * gelu_b
    if mode == "k8":
        mean, inv = ln_stats_fp32(prod, eps_for(dt) if eps is None else eps)
    else:
        mean, inv = stats[0][:, None], stats[1][:, None]
    xhat = (prod - mean) * inv
    dy32 = dy.float()
    dprod, _ = ln_bwd(dy32, xhat, inv, g.float())
    gdb = gelu_grad(b, phi)
    dh = torch.cat([dprod * gelu_b, dprod * a * gdb], dim=-1).to(dt)
    part = partials(dy32 * xhat)
    if mode == "k8":
        return dh, part
    y = (xhat * g.float()).to(dt)
    if mode == "recompute":
        return dh, y, part
    dprod = dprod.to(dt)
    pr = dprod.float()
    dh2 = torch.cat([pr * gelu_b, pr * a * gdb], dim=-1).to(dt)
    return dh, y, dprod, dh2, part


def ln_bwd_rows_plain(mode, dy, v, g, stats, resid=None, xn_out=False,
                      gb=None, agdb=None):
    """Plain PyTorch version of `ln_bwd_rows`; returns as it does."""
    dt = g.dtype
    mean, inv = stats[0][:, None], stats[1][:, None]
    xhat = (v.float() - mean) * inv
    dy32 = dy.float()
    val, _ = ln_bwd(dy32, xhat, inv, g.float())
    part = partials(dy32 * xhat)
    y = (xhat * g.float()).to(dt)
    if mode == "ln":
        out = (val if resid is None else val + resid.float()).to(dt)
        return out, (y if xn_out else None), part
    gb32, ag32 = gb.float(), agdb.float()
    dh = torch.cat([val * gb32, val * ag32], dim=-1).to(dt)
    pr = val.to(dt).float()
    dh2 = torch.cat([pr * gb32, pr * ag32], dim=-1).to(dt)
    return val.to(dt), dh, dh2, y, part


def _check(name, d, typed):
    """Raise unless the width is one the kernels take and every (tensor,
    dtype) pair matches and is contiguous."""
    if d <= 0 or d > MAX_WIDTH:
        raise ValueError(f"{name}: width {d} is not between 1 and "
                         f"{MAX_WIDTH}")
    for t, dtype in typed:
        if dtype not in KERNEL_DTYPES or t.dtype != dtype:
            raise TypeError(f"{name}: a tensor of {t.dtype} where the kernel "
                            f"takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _stats(name, stats, rows):
    if stats is None or len(stats) != 2 or any(
            s.shape != (rows,) for s in stats):
        raise ValueError(f"{name}: stats must be (mean, inv), each ({rows},)")
    return [(s, torch.float32) for s in stats]


def _ptr(t):
    return None if t is None else t.data_ptr()


def ln_rows(mode, x, g, resid=None, eps=None):
    """The LayerNorm forward rows in `mode` (LN_FWD_MODES); see the module."""
    if mode not in LN_FWD_MODES:
        raise ValueError(f"ln_rows: unknown mode {mode!r}")
    if (resid is not None) != (mode == "residual"):
        raise ValueError("ln_rows: resid is given in mode 'residual' only")
    tensors = (x, g, *(() if resid is None else (resid,)))
    if not route("ln_rows", tensors):
        return ln_rows_plain(mode, x, g, resid, eps)
    dt = g.dtype
    rows, width = x.shape
    d = width // 2 if mode == "geglu" else width
    if (g.shape != (d,) or (mode == "geglu" and width != 2 * d)
            or (resid is not None and resid.shape != (rows, d))):
        raise ValueError(f"ln_rows: x {tuple(x.shape)}, g {tuple(g.shape)} "
                         "and resid do not match")
    in_f32 = x.dtype == torch.float32
    if x.dtype not in (torch.float32, dt) or (mode == "geglu" and
                                               x.dtype != dt):
        raise TypeError(f"ln_rows: no kernel for mode {mode!r} with x "
                        f"{x.dtype}, storage {dt}")
    _check("ln_rows", d, [(x, x.dtype), (g, dt),
                          *(() if resid is None else ((resid, dt),))])
    dev = x.device
    out = torch.empty(rows, d, dtype=dt, device=dev)
    mean = inv = copy = None
    if mode in ("stats", "residual", "in_copy"):
        mean, inv = (torch.empty(rows, dtype=torch.float32, device=dev)
                     for _ in range(2))
    if mode == "in_copy":
        copy = torch.empty(rows, d, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().xclip_ln_fwd_rows(
            dtype_code(dt), int(in_f32 and dt != torch.float32),
            int(mode == "geglu"), x.data_ptr(), g.data_ptr(), _ptr(resid),
            out.data_ptr(), rows, d, eps_for(dt) if eps is None else eps,
            _ptr(mean), _ptr(inv), _ptr(copy), stream_ptr(dev))
    _build.check(err, "xclip_ln_fwd_rows")
    ln_rows.launches += 1
    if mode in ("plain", "geglu"):
        return (out,)
    return (out, mean, inv, copy) if mode == "in_copy" else (out, mean, inv)


ln_rows.launches = 0  # kernel launches (plain calls not counted)


def geglu_bwd_rows(mode, dy, h, g, stats=None, eps=None):
    """The GEGLU backward rows in `mode` (GEGLU_MODES); see the module."""
    if mode not in GEGLU_MODES:
        raise ValueError(f"geglu_bwd_rows: unknown mode {mode!r}")
    tensors = (dy, h, g, *(stats if mode != "k8" else ()))
    if not route("geglu_bwd_rows", tensors):
        return geglu_bwd_rows_plain(mode, dy, h, g, stats, eps)
    dt = g.dtype
    rows, d = dy.shape
    if h.shape != (rows, 2 * d) or g.shape != (d,):
        raise ValueError(f"geglu_bwd_rows: dy {tuple(dy.shape)}, h "
                         f"{tuple(h.shape)}, g {tuple(g.shape)} do not match")
    f32 = torch.float32
    typed = {"recompute": [(dy, f32), (h, f32)], "k8": [(dy, dt), (h, dt)],
             "stored_h": [(dy, f32), (h, dt)]}[mode] + [(g, dt)]
    if mode != "k8":
        typed += _stats("geglu_bwd_rows", stats, rows)
    _check("geglu_bwd_rows", d, typed)
    dev = dy.device

    def new(width, dtype=dt):
        return torch.empty(rows, width, dtype=dtype, device=dev)

    dh = new(2 * d)
    y = None if mode == "k8" else new(d)
    dprod = new(d) if mode == "stored_h" else None
    dh2 = None
    if mode == "stored_h":
        dh2 = dh if dt == f32 else new(2 * d)
    part = torch.empty(blocks(rows), d, dtype=f32, device=dev)
    mean, inv = (None, None) if mode == "k8" else stats
    with torch.cuda.device(dev):
        err = _build.library().xclip_geglu_bwd_rows(
            GEGLU_MODES[mode], dtype_code(dt), dy.data_ptr(), h.data_ptr(),
            _ptr(mean), _ptr(inv), g.data_ptr(), part.data_ptr(), rows, d,
            eps_for(dt) if eps is None else eps, dh.data_ptr(), _ptr(y),
            _ptr(dprod), _ptr(dh2), stream_ptr(dev))
    _build.check(err, "xclip_geglu_bwd_rows")
    geglu_bwd_rows.launches += 1
    return {"recompute": (dh, y, part), "k8": (dh, part),
            "stored_h": (dh, y, dprod, dh2, part)}[mode]


geglu_bwd_rows.launches = 0  # kernel launches (plain calls not counted)


def ln_bwd_rows(mode, dy, v, g, stats, resid=None, xn_out=False, gb=None,
                agdb=None):
    """The LayerNorm backward rows in `mode` (LN_MODES); see the module."""
    if mode not in LN_MODES:
        raise ValueError(f"ln_bwd_rows: unknown mode {mode!r}")
    extra = (resid,) if mode == "ln" else (gb, agdb)
    tensors = (dy, v, g, *stats, *(t for t in extra if t is not None))
    if not route("ln_bwd_rows", tensors):
        return ln_bwd_rows_plain(mode, dy, v, g, stats, resid, xn_out, gb,
                                 agdb)
    dt = g.dtype
    rows, d = dy.shape
    if (v.shape != (rows, d) or g.shape != (d,) or any(
            t is not None and t.shape != (rows, d) for t in extra)):
        raise ValueError("ln_bwd_rows: dy, v, g and the extra inputs do not "
                         "match")
    if mode == "geglu" and (gb is None or agdb is None):
        raise ValueError("ln_bwd_rows: 'geglu' takes gb and agdb")
    f32 = torch.float32
    dy_f32, v_f32 = dy.dtype == f32, v.dtype == f32
    if mode == "geglu" and (not dy_f32 or v.dtype != dt) or (
            mode == "ln" and dy_f32 and v_f32 and dt != f32):
        raise TypeError(f"ln_bwd_rows: no kernel for mode {mode!r} with dy "
                        f"{dy.dtype}, v {v.dtype}, storage {dt}")
    typed = [(dy, dy.dtype), (v, v.dtype), (g, dt),
             *_stats("ln_bwd_rows", stats, rows),
             *((t, dt) for t in extra if t is not None)]
    if any(t.dtype not in (f32, dt) for t in (dy, v)):
        raise TypeError("ln_bwd_rows: dy and v are fp32 or of g's dtype")
    _check("ln_bwd_rows", d, typed)
    dev = dy.device

    def new(width):
        return torch.empty(rows, width, dtype=dt, device=dev)

    out = new(d)
    xn = y2 = dh = dh2 = None
    if mode == "ln" and xn_out:
        xn = new(d)
    if mode == "geglu":
        dh, y2 = new(2 * d), new(d)
        dh2 = dh if dt == f32 else new(2 * d)
    part = torch.empty(blocks(rows), d, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().xclip_ln_bwd_rows(
            LN_MODES[mode], dtype_code(dt), int(dy_f32),
            int(v_f32 and dt != f32), dy.data_ptr(), v.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), g.data_ptr(),
            _ptr(resid), out.data_ptr(), part.data_ptr(), rows, d, _ptr(xn),
            _ptr(gb), _ptr(agdb), _ptr(dh), _ptr(dh2), _ptr(y2),
            stream_ptr(dev))
    _build.check(err, "xclip_ln_bwd_rows")
    ln_bwd_rows.launches += 1
    if mode == "ln":
        return out, xn, part
    return out, dh, dh2, y2, part


ln_bwd_rows.launches = 0  # kernel launches (plain calls not counted)


def reduce_parts(part, out=None, dtype=torch.float32):
    """The ordered sum of fp32 partials (parts, ...) that every backward's
    split-k and dg sums run (`csrc/common.cuh` launch_emit_sum), alone:
    part[0] + part[1] + ..., strictly in order in fp32
    (`matmul.ordered_sum`), rounded once to `dtype` (fp32 or bf16; the
    stored backwards' `acc` 0); with `out` (fp32, one partial's shape) the
    partials are added to it in place (the recompute backwards' running
    sums over row chunks, `acc` 2) → the sum."""
    tensors = (part,) if out is None else (part, out)
    if not route("reduce_parts", tensors):
        if out is None:
            return ordered_sum(part).to(dtype)
        for p in part:
            out += p
        return out
    if (part.dtype != torch.float32 or part.dim() < 2
            or any(not t.is_contiguous() for t in tensors)
            or (out is not None and (out.dtype != torch.float32
                                     or out.shape != part.shape[1:]))
            or dtype not in KERNEL_DTYPES):
        raise ValueError("reduce_parts: contiguous fp32 partials (parts, "
                         "...), an fp32 out of one partial's shape, and an "
                         "fp32 or bf16 sum")
    acc = 0 if out is None else 2
    if out is None:
        out = torch.empty(part.shape[1:], dtype=dtype, device=part.device)
    with torch.cuda.device(part.device):
        err = _build.library().xclip_reduce_parts(
            dtype_code(out.dtype), part.data_ptr(), out.data_ptr(),
            part.shape[0], out.numel(), acc, stream_ptr(part.device))
    _build.check(err, "xclip_reduce_parts")
    reduce_parts.launches += 1
    return out


reduce_parts.launches = 0  # kernel launches (plain calls not counted)


def sum_launches(reset: bool = False):
    """{(regime, width): launches of the ordered sums since the library was
    loaded or last reset}, from every caller (csrc/common.cuh
    g_sum_sites): regime "slab" (the narrow, deep dg sums) or "wide" (the
    split-k sums); `reset` empties the table after reading it. Raises
    RuntimeError when more widths were summed than the table holds (32)."""
    cap = 32
    n = (ctypes.c_longlong * cap)()
    wide = (ctypes.c_int * cap)()
    launches = (ctypes.c_longlong * cap)()
    k = _build.library().xclip_sum_launches(n, wide, launches, cap,
                                            int(reset))
    if k < 0:
        raise RuntimeError(f"sum_launches: more than {cap} widths were "
                           "summed since the last reset; some launches "
                           "went unrecorded")
    return {("wide" if wide[i] else "slab", n[i]): launches[i]
            for i in range(k)}


def kernel_launches(reset: bool = False):
    """{(kernel, mode): launches of the row kernel in that mode since the
    library was loaded or last reset} (COUNTERS, LN_FWD_COUNTERS), from
    every caller; `reset` sets them to 0 after reading them."""
    lib = _build.library()
    return {key: lib.xclip_rows_launches(i, int(reset))
            for i, key in enumerate((*COUNTERS, *LN_FWD_COUNTERS))}

