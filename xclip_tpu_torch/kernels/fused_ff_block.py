"""K-FF: the whole FF block forward,

    out = x + LN_gin(a · gelu(b)) @ w_out,   [a, b] = LN_gpre(x) @ w_in,

the counterpart of `xclip_tpu.kernels.fused_ff_block.ff_block` at inference
(`_ff_block_fwd_call` → Pallas `_fwd_kernel`). The CUDA kernel is
`csrc/fused_ff_block.cu`; its source note gives the design, what bounds it
on the card and which intermediates still cross HBM.

`ff_block` takes the kernel for CUDA tensors and the plain version
`ff_block_plain` for CPU tensors; it never falls back from one to the other.
The row flatten/pad to 256-row tiles and the fp32 tile halving of the
Pallas version are TPU artefacts: the kernel masks its own ragged last tile.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._common import (check_kernel_args, dot32, dtype_code, eps_for, ln_fp32,
                      route, stream_ptr)


def ff_block_plain(x, g_pre, w_in, g_inner, w_out):
    """Plain PyTorch version, in the kernel's cast order."""
    dtype = x.dtype
    eps = eps_for(dtype)
    xn32, _, _ = ln_fp32(x.float(), g_pre.float(), eps)
    h = dot32(xn32.to(dtype), w_in)                 # fp32 accumulation
    inner = h.shape[-1] // 2
    a, b = h[..., :inner], h[..., inner:]
    prod = a * F.gelu(b)                            # exact (erf) GELU
    y32, _, _ = ln_fp32(prod, g_inner.float(), eps)
    return dot32(y32.to(dtype), w_out).to(dtype) + x


def ff_block(x, g_pre, w_in, g_inner, w_out):
    """x: (..., dim); g_pre: (dim,); w_in: (dim, 2·inner); g_inner: (inner,);
    w_out: (inner, dim). Returns x + FF(LN(x)) in x.dtype. Forward only."""
    tensors = (x, g_pre, w_in, g_inner, w_out)
    if not route("ff_block", tensors):
        return ff_block_plain(*tensors)
    dim = x.shape[-1]
    inner = w_in.shape[-1] // 2
    check_kernel_args("ff_block", tensors, x.dtype)
    if (g_pre.shape != (dim,) or w_in.shape != (dim, 2 * inner)
            or g_inner.shape != (inner,) or w_out.shape != (inner, dim)):
        raise ValueError(f"ff_block: inconsistent shapes {[t.shape for t in tensors]}")
    if dim % 64 or inner % 64:
        raise ValueError(f"ff_block: dim {dim} and inner {inner} must be "
                         "multiples of 64 for the kernel")
    rows = x.numel() // dim
    out = torch.empty_like(x)
    xn = torch.empty((rows, dim), dtype=x.dtype, device=x.device)
    prod = torch.empty((rows, inner), dtype=torch.float32, device=x.device)
    y = torch.empty((rows, inner), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):  # launch on the tensors' card
        err = _build.library().xclip_ff_block_fwd(
            dtype_code(x.dtype), x.data_ptr(), g_pre.data_ptr(),
            w_in.data_ptr(), g_inner.data_ptr(), w_out.data_ptr(),
            out.data_ptr(), xn.data_ptr(), prod.data_ptr(), y.data_ptr(),
            rows, dim, inner, eps_for(x.dtype), stream_ptr(x.device))
    _build.check(err, "xclip_ff_block_fwd")
    ff_block.launches += 1
    return out


ff_block.launches = 0  # kernel launches by ff_block (plain calls not counted)
