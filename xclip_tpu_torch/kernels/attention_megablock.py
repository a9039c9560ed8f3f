"""The attention megablock,

    out = x + LN_gout(attention(LN_gpre(x) @ w_qkv) @ w_out):

* K-MEGA, the inference forward `attention_block`, the counterpart of
  `xclip_tpu.kernels.attention_megablock.attention_block` at inference
  (`_mega_fwd(..., need_residuals=False)` → Pallas `_fwd_kernel`);
* K2, the training route `attention_block_train` (`AttentionBlock`, an
  autograd Function), the counterpart of `attention_block(...,
  store_qkv=True)`: the forward `attention_block_fwd_stored` (Pallas
  `_fwd_kernel_stored`) keeps qkv, attnout and proj in the storage dtype,
  each row's softmax max m and normaliser l per head (`sm`, (b·n, 2·heads)
  fp32, m then l) and the LayerNorm statistics (`ln_stats`, (4, b·n) fp32:
  mean_pre, inv_pre, mean_o, inv_o); the backward `attention_block_bwd`
  (Pallas `_bwd_kernel_stored`, plus `_mega_bwd_vjp`'s dW_qkv = xnᵀ·dqkv)
  gives dx, dqkv, dW_qkv, dW_out, dg_pre and dg_out.

The CUDA kernels are `csrc/attention_megablock.cu`; its source notes give
the designs, what bounds them on the card and which intermediates cross
HBM. Every wrapper takes its kernel for CUDA tensors and its plain version
for CPU tensors; it never falls back from one to the other. The Pallas
version's 128/16-row alignment and transposed stats layout are TPU
artefacts: the kernels work on the true (b, n, ·) shapes.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import (check_kernel_args, dot32, dtype_code, eps_for, ln_bwd,
                      ln_stats_fp32, refuse_grad, route, stream_ptr)

DIM_HEAD = 64  # the only head width the kernel takes


def _heads(t, b, n, heads, dim_head):
    """(b·n or b, n, heads·dim_head) → (b, heads, n, dim_head)."""
    return t.reshape(b, n, heads, dim_head).transpose(1, 2)


def _softmax_parts(q, k, mask, scale, causal, maybe_dead):
    """fp32 masked scores s (b, h, n, n) and, with `maybe_dead`, the rows
    with no valid key (b, h, n, 1); None otherwise."""
    n = q.shape[2]
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    valid = mask.bool()[:, None, None, :]
    if causal:
        valid = valid & torch.ones(n, n, dtype=torch.bool,
                                   device=q.device).tril()
    s = torch.where(valid, s, float("-inf"))
    dead = ~valid.any(dim=-1, keepdim=True) if maybe_dead else None
    return s, dead


def attention_block_fwd_stored_plain(x, g_pre, w_qkv, w_out, g_out, mask,
                                     heads, dim_head, scale, causal=False,
                                     maybe_dead=True):
    """Plain K2 forward → (out, (qkv, attnout, proj, sm, ln_stats)) in the
    cast order of `_fwd_kernel_stored`: proj rounded, mean_o / inv_o from
    the fp32 proj, m and l the exact softmax max (0 on a dead row) and
    normaliser."""
    dtype = x.dtype
    b, n, _ = x.shape
    hd = heads * dim_head
    eps = eps_for(dtype)
    x32 = x.float()
    mean_pre, inv_pre = ln_stats_fp32(x32, eps)
    xn = (((x32 - mean_pre) * inv_pre) * g_pre.float()).to(dtype)
    qkv = dot32(xn, w_qkv).to(dtype)
    q, k, v = (_heads(qkv[..., i * hd:(i + 1) * hd], b, n, heads, dim_head)
               for i in range(3))
    s, dead = _softmax_parts(q, k, mask, scale, causal, maybe_dead)
    m = s.amax(dim=-1, keepdim=True)
    if dead is not None:
        m = torch.where(dead, 0.0, m)
        p = torch.where(dead, 1.0, torch.exp(s - m))
    else:
        p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = dot32((p / l).to(dtype), v).to(dtype)                     # (b, h, n, d)
    attnout = o.transpose(1, 2).reshape(b, n, hd)
    proj = dot32(attnout, w_out)
    mean_o, inv_o = ln_stats_fp32(proj, eps)
    out = (((proj - mean_o) * inv_o) * g_out.float()).to(dtype) + x
    sm = torch.cat([m, l], dim=1).squeeze(-1).permute(0, 2, 1)   # (b, n, 2h)
    ln_stats = torch.stack([mean_pre, inv_pre, mean_o, inv_o]).reshape(4, -1)
    return out, (qkv.reshape(b * n, 3 * hd), attnout.reshape(b * n, hd),
                 proj.to(dtype).reshape(b * n, -1),
                 sm.reshape(b * n, 2 * heads).contiguous(), ln_stats)


def attention_block_plain(x, g_pre, w_qkv, w_out, g_out, mask, heads,
                          dim_head, scale, causal=False, maybe_dead=True):
    """Plain PyTorch version, in the kernel's cast order: the scale
    multiplies fp32 scores (the XLA route pre-scales q instead), masked keys
    get -inf, and with `maybe_dead` a row with no valid key gets uniform
    weights over all n keys."""
    return attention_block_fwd_stored_plain(
        x, g_pre, w_qkv, w_out, g_out, mask, heads, dim_head, scale, causal,
        maybe_dead)[0]


def max_seq_len(dtype) -> int:
    """Longest sequence the forward kernel takes in `dtype` (its 32 score
    rows of length n sit in one block's shared memory). Needs the built
    library."""
    return _build.library().xclip_attention_block_max_n(dtype_code(dtype))


def max_seq_len_bwd(dtype) -> int:
    """Longest sequence the backward kernels take in `dtype`."""
    return _build.library().xclip_attention_block_bwd_max_n(dtype_code(dtype))


def _check(name, tensors, mask, heads, dim_head, training=False):
    x, g_pre, w_qkv, w_out, g_out = tensors
    b, n, dim = x.shape
    hd = heads * dim_head
    check_kernel_args(name, tensors, x.dtype)
    if dim_head != DIM_HEAD or dim % 64:
        raise ValueError(f"{name}: the kernel takes dim_head {DIM_HEAD} and "
                         f"dim a multiple of 64, not dim_head {dim_head}, "
                         f"dim {dim}")
    if (g_pre.shape != (dim,) or g_out.shape != (dim,)
            or w_qkv.shape != (dim, 3 * hd) or w_out.shape != (hd, dim)
            or mask.shape != (b, n)):
        raise ValueError(f"{name}: inconsistent shapes "
                         f"{[t.shape for t in tensors + (mask,)]}")
    limit = min(max_seq_len(x.dtype), max_seq_len_bwd(x.dtype)) \
        if training else max_seq_len(x.dtype)
    if n > limit:
        raise ValueError(f"{name}: n {n} exceeds the kernel's {limit} in "
                         f"{x.dtype}")
    return b, n, dim, hd


def _fwd_kernel(name, tensors, mask, heads, dim_head, scale, causal,
                maybe_dead, stored):
    """Launch the forward kernel → (out, residuals or None); with `stored`,
    the K2 residuals as the plain version returns."""
    x = tensors[0]
    b, n, dim, hd = _check(name, tensors, mask, heads, dim_head,
                           training=stored)
    dev, dt = x.device, x.dtype
    rows = b * n
    mask_u8 = mask.to(torch.uint8).contiguous()
    out = torch.empty_like(x)
    xn = torch.empty((rows, dim), dtype=dt, device=dev)
    qkv = torch.empty((rows, 3 * hd), dtype=dt, device=dev)
    attnout = torch.empty((rows, hd), dtype=dt, device=dev)
    proj = torch.empty((rows, dim), dtype=torch.float32, device=dev)
    residuals, residual_ptrs = None, [None] * 3    # None: a null pointer
    if stored:
        extra = (torch.empty((rows, dim), dtype=dt, device=dev),
                 torch.empty((rows, 2 * heads), dtype=torch.float32,
                             device=dev),
                 torch.empty((4, rows), dtype=torch.float32, device=dev))
        residuals = (qkv, attnout, *extra)
        residual_ptrs = [t.data_ptr() for t in extra]
    with torch.cuda.device(dev):  # launch on the tensors' card
        err = _build.library().xclip_attention_block_fwd(
            dtype_code(dt), *(t.data_ptr() for t in (
                *tensors, mask_u8, out, xn, qkv, attnout, proj)),
            *residual_ptrs, b, n, dim, heads, float(scale), int(causal),
            int(maybe_dead), eps_for(dt), stream_ptr(dev))
    _build.check(err, "xclip_attention_block_fwd")
    return out, residuals


def attention_block(x, g_pre, w_qkv, w_out, g_out, mask, heads, dim_head,
                    scale, causal=False, maybe_dead=True):
    """x: (b, n, dim); mask: (b, n) bool, True = valid key; w_qkv:
    (dim, 3·heads·dim_head); w_out: (heads·dim_head, dim); gains (dim,).
    Returns x + LN(W_out · attention(LN(x)·W_qkv)) in x.dtype. Forward only:
    training goes through `attention_block_train`. `maybe_dead=False` may
    be passed when every row has a valid key."""
    tensors = (x, g_pre, w_qkv, w_out, g_out)
    refuse_grad("attention_block", tensors, "attention_block_train")
    if not route("attention_block", tensors + (mask,)):
        return attention_block_plain(x, g_pre, w_qkv, w_out, g_out, mask,
                                     heads, dim_head, scale, causal,
                                     maybe_dead)
    out, _ = _fwd_kernel("attention_block", tensors, mask, heads, dim_head,
                         scale, causal, maybe_dead, stored=False)
    attention_block.launches += 1
    return out


attention_block.launches = 0  # kernel launches (plain calls not counted)


# ------------------------------------------------------------ K2 forward

def attention_block_fwd_stored(x, g_pre, w_qkv, w_out, g_out, mask, heads,
                               dim_head, scale, causal=False,
                               maybe_dead=True):
    """K2 forward: (out, residuals) as the plain version."""
    tensors = (x, g_pre, w_qkv, w_out, g_out)
    if not route("attention_block_fwd_stored", tensors + (mask,)):
        return attention_block_fwd_stored_plain(
            x, g_pre, w_qkv, w_out, g_out, mask, heads, dim_head, scale,
            causal, maybe_dead)
    result = _fwd_kernel("attention_block_fwd_stored", tensors, mask, heads,
                         dim_head, scale, causal, maybe_dead, stored=True)
    attention_block_fwd_stored.launches += 1
    return result


attention_block_fwd_stored.launches = 0


# ------------------------------------------------------------ K2 backward

def attention_block_bwd_plain(x, g_pre, w_qkv, w_out, g_out, mask, dout,
                              stored, heads, dim_head, scale, causal=False,
                              maybe_dead=True):
    """`_bwd_kernel_stored` and `_mega_bwd_vjp`'s dW_qkv in PyTorch →
    (dx, dg_pre, dW_qkv, dW_out, dg_out, dqkv), all in x.dtype."""
    qkv, attnout, proj, sm, ln_stats = stored
    dtype = x.dtype
    b, n, dim = x.shape
    hd = heads * dim_head
    rows = b * n
    x2 = x.reshape(rows, dim)
    do = dout.reshape(rows, dim)
    mean_pre, inv_pre, mean_o, inv_o = (ln_stats[i][:, None] for i in range(4))
    xhat_o = (proj.float() - mean_o) * inv_o
    dproj, dg_out = ln_bwd(do.float(), xhat_o, inv_o, g_out.float())
    dproj = dproj.to(dtype)
    dattn = dot32(dproj, w_out.T)                                # (rows, hd)
    dw_out = dot32(attnout.T, dproj).to(dtype)

    q, k, v = (_heads(qkv[:, i * hd:(i + 1) * hd], b, n, heads, dim_head)
               for i in range(3))
    s, dead = _softmax_parts(q, k, mask, scale, causal, maybe_dead)
    m, l = (sm[:, i * heads:(i + 1) * heads].reshape(b, n, heads)
            .permute(0, 2, 1)[..., None] for i in range(2))
    p = torch.exp(s - m)
    if dead is not None:
        p = torch.where(dead, 1.0, p)
    p = p / l
    do_h = _heads(dattn, b, n, heads, dim_head)                  # fp32
    delta = (do_h * _heads(attnout, b, n, heads, dim_head).float() * scale
             ).sum(dim=-1, keepdim=True)
    dp = dot32((do_h * scale).to(dtype), v.transpose(-1, -2))
    ds = p * (dp - delta)
    if dead is not None:
        ds = torch.where(dead, 0.0, ds)
    ds = ds.to(dtype)
    parts = (dot32(ds, k), dot32(ds.transpose(-1, -2), q),
             dot32(p.to(dtype).transpose(-1, -2), do_h.to(dtype)))
    dqkv = torch.cat([t.transpose(1, 2).reshape(rows, hd) for t in parts],
                     dim=-1).to(dtype)

    dxn = dot32(dqkv, w_qkv.T)
    xhat_pre = (x2.float() - mean_pre) * inv_pre
    dx_pre, dg_pre = ln_bwd(dxn, xhat_pre, inv_pre, g_pre.float())
    dx = (dx_pre + do.float()).to(dtype).reshape(b, n, dim)
    xn = (xhat_pre * g_pre.float()).to(dtype)
    dw_qkv = dot32(xn.T, dqkv).to(dtype)
    return dx, dg_pre.to(dtype), dw_qkv, dw_out, dg_out.to(dtype), dqkv


def attention_block_bwd(x, g_pre, w_qkv, w_out, g_out, mask, dout, stored,
                        heads, dim_head, scale, causal=False, maybe_dead=True):
    """K2 backward; returns as `attention_block_bwd_plain`."""
    tensors = (x, g_pre, w_qkv, w_out, g_out)
    if not route("attention_block_bwd", tensors + (mask, dout, *stored)):
        return attention_block_bwd_plain(
            x, g_pre, w_qkv, w_out, g_out, mask, dout, stored, heads,
            dim_head, scale, causal, maybe_dead)
    b, n, dim, hd = _check("attention_block_bwd", tensors, mask, heads,
                           dim_head, training=True)
    check_kernel_args("attention_block_bwd", (dout, *stored[:3]), x.dtype)
    dev, dt = x.device, x.dtype
    lib = _build.library()
    mask_u8 = mask.to(torch.uint8).contiguous()
    dx = torch.empty_like(x)
    dqkv = torch.empty((b * n, 3 * hd), dtype=dt, device=dev)
    dw_qkv = torch.empty_like(w_qkv)
    dw_out = torch.empty_like(w_out)
    dg_pre = torch.empty_like(g_pre)
    dg_out = torch.empty_like(g_out)
    ws = torch.empty(lib.xclip_attention_block_bwd_workspace(
        dtype_code(dt), b, n, dim, heads), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.xclip_attention_block_bwd(
            dtype_code(dt), *(t.data_ptr() for t in (
                x, g_pre, w_qkv, w_out, g_out, mask_u8, dout, *stored, dx,
                dqkv, dw_qkv, dw_out, dg_pre, dg_out, ws)),
            b, n, dim, heads, float(scale), int(causal), int(maybe_dead),
            stream_ptr(dev))
    _build.check(err, "xclip_attention_block_bwd")
    attention_block_bwd.launches += 1
    return dx, dg_pre, dw_qkv, dw_out, dg_out, dqkv


attention_block_bwd.launches = 0


class AttentionBlock(torch.autograd.Function):
    """K2: the stored attention megablock, forward and backward kernels."""

    @staticmethod
    def forward(ctx, x, g_pre, w_qkv, w_out, g_out, mask, heads, dim_head,
                scale, causal, maybe_dead):
        x = x.contiguous()
        out, stored = attention_block_fwd_stored(
            x, g_pre, w_qkv, w_out, g_out, mask, heads, dim_head, scale,
            causal, maybe_dead)
        ctx.save_for_backward(x, g_pre, w_qkv, w_out, g_out, mask, *stored)
        ctx.static = (heads, dim_head, scale, causal, maybe_dead)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, g_pre, w_qkv, w_out, g_out, mask, *stored = ctx.saved_tensors
        dout = dout.to(x.dtype).contiguous()
        dx, dg_pre, dw_qkv, dw_out, dg_out, _ = attention_block_bwd(
            x, g_pre, w_qkv, w_out, g_out, mask, dout, stored, *ctx.static)
        return dx, dg_pre, dw_qkv, dw_out, dg_out, *([None] * 6)


def attention_block_train(x, g_pre, w_qkv, w_out, g_out, mask, heads,
                          dim_head, scale, causal=False, maybe_dead=True):
    """x + LN(W_out · attention(LN(x)·W_qkv)) with the stored backward;
    differentiable in the five tensors. Same arguments as
    `attention_block`."""
    return AttentionBlock.apply(x, g_pre, w_qkv, w_out, g_out, mask, heads,
                                dim_head, scale, causal, maybe_dead)
