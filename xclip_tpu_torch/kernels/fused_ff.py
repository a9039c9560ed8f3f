"""K8, the GEGLU + inner-LayerNorm middle of the feed-forward,

    out = LN_g(a · gelu(b)),   [a, b] = h = LN(x) @ W_in   (..., 2·inner),

the counterpart of `xclip_tpu.kernels.fused_ff.geglu_layernorm`, which
`ff_impl='fused'` runs between the two plain products of the FF layer:

* `geglu_layernorm_fwd` (Pallas `_fwd_kernel` via `_forward_math`): out in
  h's dtype;
* `geglu_layernorm_bwd` (Pallas `_dg_out_kernel` → `_bwd_kernel`): dh and
  the gain's gradient dg, the row statistics recomputed from h as the
  forward took them;
* `GegluLayerNorm`, the autograd Function over the two, and
  `geglu_layernorm(h, g)`.

The CUDA kernels are `csrc/fused_ff.cu` (its source note gives the design
and what bounds it). Every wrapper takes its kernel for CUDA tensors and
its plain version (`*_plain`, the kernels' cast order in PyTorch) for CPU
tensors; it never falls back from one to the other. Cast order, as the
Pallas kernels: h widened to fp32; exact (erf) GELU as b·Φ(b); two-pass
fp32 statistics with the eps of h's dtype (1e-5 fp32, 1e-3 otherwise); out
rounded once. The backward casts the cotangent to h's dtype first
(`_geglu_ln_bwd`), rounds dh once and sums dg over every row in fp32, cast
once to g's dtype. The Pallas `_erf` is a polynomial (max error 1.5e-7);
the port takes `erff` / `torch.erf`, as K1 does. Its row padding to 256-row
blocks is a TPU artefact.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import (KERNEL_DTYPES, check_kernel_args, dtype_code, eps_for,
                      geglu_parts, gelu_grad, ln_bwd, ln_stats_fp32, route,
                      stream_ptr)
from .rows import MAX_WIDTH


def _parts(h):
    """(a, b, Φ(b), gelu(b), prod) of h in fp32, rows flattened."""
    a, b, phi, gelu_b = geglu_parts(h.reshape(-1, h.shape[-1]).float())
    return a, b, phi, gelu_b, a * gelu_b


def geglu_layernorm_plain(h, g):
    """Plain PyTorch version of the forward: (..., 2·inner) → (..., inner)
    in h.dtype."""
    *_, prod = _parts(h)
    mean, inv = ln_stats_fp32(prod, eps_for(h.dtype))
    out = ((prod - mean) * inv) * g.float()
    return out.to(h.dtype).reshape(*h.shape[:-1], prod.shape[-1])


def geglu_layernorm_bwd_plain(h, g, do):
    """Plain PyTorch version of the backward → (dh in h.dtype, dg in
    g.dtype)."""
    a, b, phi, gelu_b, prod = _parts(h)
    mean, inv = ln_stats_fp32(prod, eps_for(h.dtype))
    xhat = (prod - mean) * inv
    dy = do.to(h.dtype).reshape(prod.shape).float()
    dprod, dg = ln_bwd(dy, xhat, inv, g.float())
    dh = torch.cat([dprod * gelu_b, dprod * a * gelu_grad(b, phi)], dim=-1)
    return dh.to(h.dtype).reshape(h.shape), dg.to(g.dtype)


def why_not(inner, dtype):
    """Why the CUDA kernels cannot take an inner width `inner` in `dtype`
    (None if they can): the row kernels' widest row, forward and backward
    alike. The wrappers raise on it before any launch."""
    if dtype not in KERNEL_DTYPES:
        return f"the CUDA K8 kernels take float32 or bfloat16, not {dtype}"
    if inner > MAX_WIDTH:
        return f"the CUDA K8 kernels take inner up to {MAX_WIDTH}, not {inner}"
    return None


def _check(name, h, g, *more):
    check_kernel_args(name, (h, g, *more), h.dtype)
    inner = h.shape[-1] // 2
    if h.shape[-1] != 2 * inner or g.shape != (inner,) or inner == 0:
        raise ValueError(f"{name}: h of shape {tuple(h.shape)} and g of "
                         f"shape {tuple(g.shape)} do not match")
    reason = why_not(inner, h.dtype)
    if reason:
        raise ValueError(f"{name}: {reason}")
    return h.numel() // h.shape[-1], inner


def geglu_layernorm_fwd(h, g):
    """h: (..., 2·inner); g: (inner,). Returns LN_g(a·gelu(b)) (...,
    inner) in h.dtype."""
    if not route("geglu_layernorm_fwd", (h, g)):
        return geglu_layernorm_plain(h, g)
    rows, inner = _check("geglu_layernorm_fwd", h, g)
    out = torch.empty((*h.shape[:-1], inner), dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):  # launch on the tensors' card
        err = _build.library().xclip_geglu_ln_fwd(
            dtype_code(h.dtype), h.data_ptr(), g.data_ptr(), out.data_ptr(),
            rows, inner, eps_for(h.dtype), stream_ptr(h.device))
    _build.check(err, "xclip_geglu_ln_fwd")
    geglu_layernorm_fwd.launches += 1
    return out


geglu_layernorm_fwd.launches = 0  # kernel launches (plain calls not counted)


def geglu_layernorm_bwd(h, g, do):
    """The backward: do (..., inner) → (dh (..., 2·inner) in h.dtype, dg
    (inner,) in g.dtype); do is cast to h.dtype first."""
    if not route("geglu_layernorm_bwd", (h, g, do)):
        return geglu_layernorm_bwd_plain(h, g, do)
    do = do.to(h.dtype).contiguous()
    rows, inner = _check("geglu_layernorm_bwd", h, g, do)
    if do.shape != (*h.shape[:-1], inner):
        raise ValueError(f"geglu_layernorm_bwd: do of shape "
                         f"{tuple(do.shape)} for h of shape {tuple(h.shape)}")
    dh = torch.empty_like(h)
    dg = torch.empty_like(g)
    lib = _build.library()
    ws = torch.empty(lib.xclip_geglu_ln_bwd_workspace(rows, inner),
                     dtype=torch.uint8, device=h.device)
    with torch.cuda.device(h.device):
        err = lib.xclip_geglu_ln_bwd(
            dtype_code(h.dtype), *(t.data_ptr() for t in (h, g, do, dh, dg,
                                                           ws)),
            rows, inner, eps_for(h.dtype), stream_ptr(h.device))
    _build.check(err, "xclip_geglu_ln_bwd")
    geglu_layernorm_bwd.launches += 1
    return dh, dg


geglu_layernorm_bwd.launches = 0


class GegluLayerNorm(torch.autograd.Function):
    """K8: forward and backward kernels; only h and g are kept."""

    @staticmethod
    def forward(ctx, h, g):
        h = h.contiguous()
        ctx.save_for_backward(h, g)
        return geglu_layernorm_fwd(h, g)

    @staticmethod
    def backward(ctx, dout):
        h, g = ctx.saved_tensors
        return geglu_layernorm_bwd(h, g, dout)


def geglu_layernorm(h, g):
    """LN_g(a·gelu(b)) of h = [a, b] (..., 2·inner) → (..., inner) in
    h.dtype, differentiable in h and g."""
    return GegluLayerNorm.apply(h, g)
