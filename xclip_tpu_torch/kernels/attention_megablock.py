"""K-MEGA: the whole attention block forward,

    out = x + LN_gout(attention(LN_gpre(x) @ w_qkv) @ w_out),

the counterpart of `xclip_tpu.kernels.attention_megablock.attention_block`
at inference (`_mega_fwd(..., need_residuals=False)` → Pallas `_fwd_kernel`
with `_fwd_common`). The CUDA kernel is `csrc/attention_megablock.cu`; its
source note gives the design, what bounds it on the card and which
intermediates still cross HBM.

`attention_block` takes the kernel for CUDA tensors and the plain version
`attention_block_plain` for CPU tensors; it never falls back from one to the
other. The Pallas version's 128/16-row alignment is a TPU artefact: the
kernel works on the true (b, n, ·) shapes.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import (check_kernel_args, dot32, dtype_code, eps_for, ln_fp32,
                      route, stream_ptr)

DIM_HEAD = 64  # the only head width the kernel takes


def attention_block_plain(x, g_pre, w_qkv, w_out, g_out, mask, heads,
                          dim_head, scale, causal=False, maybe_dead=True):
    """Plain PyTorch version, in the kernel's cast order: the scale
    multiplies fp32 scores (the XLA route pre-scales q instead), masked keys
    get -inf, and with `maybe_dead` a row with no valid key gets uniform
    weights over all n keys."""
    dtype = x.dtype
    b, n, _ = x.shape
    hd = heads * dim_head
    eps = eps_for(dtype)
    xn32, _, _ = ln_fp32(x.float(), g_pre.float(), eps)
    qkv = dot32(xn32.to(dtype), w_qkv).to(dtype)
    q, k, v = (qkv[..., i * hd:(i + 1) * hd]
               .reshape(b, n, heads, dim_head).transpose(1, 2)
               for i in range(3))
    s = (q.float() @ k.float().transpose(-1, -2)) * scale       # (b, h, n, n)
    valid = mask.bool()[:, None, None, :]
    if causal:
        valid = valid & torch.ones(n, n, dtype=torch.bool,
                                   device=x.device).tril()
    s = torch.where(valid, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    if maybe_dead:
        dead = ~valid.any(dim=-1, keepdim=True)
        m = torch.where(dead, 0.0, m)
        p = torch.where(dead, 1.0, torch.exp(s - m))
    else:
        p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = (p / l).to(dtype)
    o = dot32(p, v).to(dtype)                                    # (b, h, n, d)
    attnout = o.transpose(1, 2).reshape(b, n, hd)
    y32, _, _ = ln_fp32(dot32(attnout, w_out), g_out.float(), eps)
    return y32.to(dtype) + x


def max_seq_len(dtype) -> int:
    """Longest sequence the kernel takes in `dtype` (its 32 score rows of
    length n sit in one block's shared memory). Needs the built library."""
    return _build.library().xclip_attention_block_max_n(dtype_code(dtype))


def attention_block(x, g_pre, w_qkv, w_out, g_out, mask, heads, dim_head,
                    scale, causal=False, maybe_dead=True):
    """x: (b, n, dim); mask: (b, n) bool, True = valid key; w_qkv:
    (dim, 3·heads·dim_head); w_out: (heads·dim_head, dim); gains (dim,).
    Returns x + LN(W_out · attention(LN(x)·W_qkv)) in x.dtype. Forward only.
    `maybe_dead=False` may be passed when every row has a valid key."""
    tensors = (x, g_pre, w_qkv, w_out, g_out)
    if not route("attention_block", tensors + (mask,)):
        return attention_block_plain(x, g_pre, w_qkv, w_out, g_out, mask,
                                     heads, dim_head, scale, causal,
                                     maybe_dead)
    b, n, dim = x.shape
    hd = heads * dim_head
    check_kernel_args("attention_block", tensors, x.dtype)
    if dim_head != DIM_HEAD or dim % 64:
        raise ValueError(f"attention_block: the kernel takes dim_head "
                         f"{DIM_HEAD} and dim a multiple of 64, not "
                         f"dim_head {dim_head}, dim {dim}")
    if (g_pre.shape != (dim,) or g_out.shape != (dim,)
            or w_qkv.shape != (dim, 3 * hd) or w_out.shape != (hd, dim)
            or mask.shape != (b, n)):
        raise ValueError("attention_block: inconsistent shapes "
                         f"{[t.shape for t in tensors + (mask,)]}")
    if n > max_seq_len(x.dtype):
        raise ValueError(f"attention_block: n {n} exceeds the kernel's "
                         f"{max_seq_len(x.dtype)} in {x.dtype}")
    mask_u8 = mask.to(torch.uint8).contiguous()
    out = torch.empty_like(x)
    xn = torch.empty((b * n, dim), dtype=x.dtype, device=x.device)
    qkv = torch.empty((b * n, 3 * hd), dtype=x.dtype, device=x.device)
    attnout = torch.empty((b * n, hd), dtype=x.dtype, device=x.device)
    proj = torch.empty((b * n, dim), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # launch on the tensors' card
        err = _build.library().xclip_attention_block_fwd(
            dtype_code(x.dtype), x.data_ptr(), g_pre.data_ptr(),
            w_qkv.data_ptr(), w_out.data_ptr(), g_out.data_ptr(),
            mask_u8.data_ptr(), out.data_ptr(), xn.data_ptr(),
            qkv.data_ptr(), attnout.data_ptr(), proj.data_ptr(), b, n, dim,
            heads, float(scale), int(causal), int(maybe_dead),
            eps_for(x.dtype), stream_ptr(x.device))
    _build.check(err, "xclip_attention_block_fwd")
    attention_block.launches += 1
    return out


attention_block.launches = 0  # kernel launches (plain calls not counted)
