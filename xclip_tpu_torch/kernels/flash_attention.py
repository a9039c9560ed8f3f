"""K7: FlashAttention-2, the counterpart of
`xclip_tpu.kernels.flash_attention.flash_attention` (Pallas `_fwd_kernel`
through `_flash_forward`; `_bwd_dq_kernel` and `_bwd_dkv_kernel` through
`_flash_backward`).

    flash_attention(q, k, v, mask=None, causal=False)

takes (b, h, n, d) tensors with q pre-scaled and a (b, n) key mask, pads n
to the kernels' tile, `KERNEL_BLOCK` (the JAX wrapper pads to its 128
block), repeats the key mask per head, as the JAX wrapper does, and runs
the core on (b·h, n_pad, d). Padded keys are masked and padded query rows
are sliced off (their cotangents are 0), so the padding changes no result.
Differentiable in q, k and v.

* `flash_attention_fwd` → (out, lse): the online softmax over key blocks
  in fp32 (m_safe = 0 where m = −inf, correction 0 where the previous m =
  −inf, p = 0 on masked entries, p cast to v's dtype before p·v, l =
  max(l, 1e-30)); out in q's dtype, lse = m_safe + log l: a row with no
  valid key gives out 0 and lse log 1e-30.
* `flash_attention_bwd` → (dq, dk, dv): Δ = Σ dO∘O per row, then p =
  exp(s − lse) (0 on masked entries), ds = p·(dO·vᵀ − Δ), dq = T(ds)·k,
  dk = T(ds)ᵀ·q, dv = T(p)ᵀ·dO.

The CUDA kernels are `csrc/flash_attention.cu` (64 × 64 tiles): bf16 on
the mma.sync kernels of `csrc/flash_attention_sm90.cuh`; fp32, forward
and backward, on the attention core's tiled FMA kernels
(`csrc/attention_core.cuh`) in their K7 mode (K6's with scale 1 and no
dead-row rule, lse = m_safe + log l, any length). Every kernel skips
causal and all-masked key tiles, and every backward computes Δ in its dq
kernel. Their source notes give the design and what bounds it. The
kernels take 16-byte aligned tensors (`flash_attention` hands them fresh
ones). In bf16 they take a head at its true width, any multiple of 8 up
to 256 (⌈d / 64⌉ 64-column halves), in fp32 heads of 64 and 128;
`flash_attention` runs any other head zero-padded to its
`_common.kernel_width` (the attention kernels' one rule).
The plain versions follow the Pallas kernels' rounding points;
the forward's online softmax rounds p against the running max, so its key
block is a rounding point too: the plain forward takes it as `block_k`,
`KERNEL_BLOCK` by default (the kernels' tile; the tests set the Pallas
default, 128, to hold it to JAX). Every wrapper takes its kernel for CUDA
tensors and its plain version for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._common import (KERNEL_DTYPES, check_kernel_args, dot32, dtype_code,
                      kernel_width, route, stream_ptr, takes_width,
                      width_words)

KERNEL_BLOCK = 64   # the kernels' query and key tiles, the sequence
                    # multiple they take
NEG_INF = float("-inf")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _valid(mask, n, j0, width, causal):
    """(bh, n, width) bool: key j0 + c valid for query row r."""
    valid = mask[:, None, j0:j0 + width].bool()
    if causal:
        rows = torch.arange(n, device=mask.device)[:, None]
        cols = j0 + torch.arange(valid.shape[-1], device=mask.device)[None]
        valid = valid & (cols <= rows)
    return valid


def flash_attention_fwd_plain(q, k, v, mask, causal=False,
                              block_k=KERNEL_BLOCK):
    """`_fwd_kernel` in PyTorch over key blocks of `block_k`: q, k, v
    (bh, n, d), q pre-scaled; mask (bh, n) → (out in q.dtype, lse (bh, n)
    fp32)."""
    bh, n, d = q.shape
    m = torch.full((bh, n, 1), NEG_INF, device=q.device)
    l = torch.zeros((bh, n, 1), device=q.device)
    acc = torch.zeros((bh, n, d), device=q.device)
    for j0 in range(0, n, block_k):
        kb, vb = k[:, j0:j0 + block_k], v[:, j0:j0 + block_k]
        valid = _valid(mask, n, j0, kb.shape[1], causal)
        s = torch.where(valid, dot32(q, kb.transpose(-1, -2)), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(m_new == NEG_INF, 0.0, m_new)
        p = torch.where(valid, torch.exp(s - m_safe), 0.0)
        corr = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + dot32(p.to(v.dtype), vb)
        m = m_new
    l = l.clamp_min(1e-30)
    lse = torch.where(m == NEG_INF, 0.0, m) + torch.log(l)
    return (acc / l).to(q.dtype), lse.squeeze(-1)


def flash_attention_bwd_plain(q, k, v, mask, out, lse, do, causal=False):
    """`_flash_backward` in PyTorch → (dq, dk, dv)."""
    n = q.shape[1]
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    valid = _valid(mask, n, 0, n, causal)
    p = torch.where(valid, torch.exp(dot32(q, k.transpose(-1, -2))
                                     - lse[..., None]), 0.0)
    ds = p * (dot32(do, v.transpose(-1, -2)) - delta)
    return (dot32(ds.to(k.dtype), k).to(q.dtype),
            dot32(ds.to(q.dtype).transpose(-1, -2), q).to(k.dtype),
            dot32(p.to(do.dtype).transpose(-1, -2), do).to(v.dtype))


def why_not(dim_head, dtype):
    """Why the CUDA kernels cannot take heads of `dim_head` in `dtype`
    (None if they can); any sequence runs, padded to the kernels' tile
    (`pad_flat`), and another head padded to its `kernel_width`. The
    wrappers raise on it before any launch."""
    if dtype not in KERNEL_DTYPES:
        return f"the CUDA flash kernels take float32 or bfloat16, not {dtype}"
    if not takes_width(dim_head, dtype):
        return (f"the CUDA flash kernels take {width_words(dtype)}, not "
                f"{dim_head}")
    return None


def _check(name, tensors, mask):
    q = tensors[0]
    bh, n, d = q.shape
    check_kernel_args(name, tensors, q.dtype)
    reason = why_not(d, q.dtype)
    if reason:
        raise ValueError(f"{name}: {reason}")
    if any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{name}: the kernel takes (bh, n, d) tensors of "
                         f"one shape, not {[tuple(t.shape) for t in tensors]}")
    if n % KERNEL_BLOCK or mask.shape != (bh, n):
        raise ValueError(f"{name}: n {n} must be a multiple of "
                         f"{KERNEL_BLOCK} and the mask (bh, n), not "
                         f"{tuple(mask.shape)}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the kernels take 16-byte aligned tensors")
    return bh, n


def _mask_u8(mask):
    """The (bh, n) key mask as the kernels read it: uint8, contiguous and
    16-byte aligned (their 8-byte mask loads)."""
    mask_u8 = mask.to(torch.uint8).contiguous()
    return mask_u8 if mask_u8.data_ptr() % 16 == 0 else mask_u8.clone()


def flash_attention_fwd(q, k, v, mask, causal=False):
    """K7 forward on (bh, n, d) → (out, lse) as the plain version."""
    if not route("flash_attention_fwd", (q, k, v, mask)):
        return flash_attention_fwd_plain(q, k, v, mask, causal)
    bh, n = _check("flash_attention_fwd", (q, k, v), mask)
    mask_u8 = _mask_u8(mask)
    out = torch.empty_like(q)
    lse = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _build.library().xclip_flash_fwd(
            dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask_u8.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, n,
            q.shape[-1], int(causal), stream_ptr(q.device))
    _build.check(err, "xclip_flash_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0  # kernel launches (plain calls not counted)


def flash_attention_bwd(q, k, v, mask, out, lse, do, causal=False):
    """K7 backward → (dq, dk, dv) as the plain version; Δ = Σ dO∘O in
    the dq kernel."""
    if not route("flash_attention_bwd", (q, k, v, mask, out, lse, do)):
        return flash_attention_bwd_plain(q, k, v, mask, out, lse, do, causal)
    bh, n = _check("flash_attention_bwd", (q, k, v, out, do), mask)
    check_kernel_args("flash_attention_bwd", (lse,), torch.float32)
    if lse.shape != (bh, n):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)}")
    # scratch: the dq kernel computes Δ, the dk/dv kernel reads it
    delta = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    mask_u8 = _mask_u8(mask)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        err = _build.library().xclip_flash_bwd(
            dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask_u8.data_ptr(), out.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, n, q.shape[-1], int(causal),
            stream_ptr(q.device))
    _build.check(err, "xclip_flash_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashCore(torch.autograd.Function):
    """K7 on (bh, n_pad, d): forward and backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        q, k, v = (t.contiguous() for t in (q, k, v))
        out, lse = flash_attention_fwd(q, k, v, mask, causal)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, mask, out, lse,
                                     do.to(q.dtype).contiguous(), ctx.causal),
                None, None)


def pad_flat(tensors, mask=None):
    """(b, h, n, d) tensors and a (b, n) key mask (None: every key valid)
    → the (b·h, n_pad, d) tensors and the (b·h, n_pad) key mask the
    kernels take: n padded to a multiple of `KERNEL_BLOCK` with masked
    keys, the key mask repeated per head."""
    b, h, n, d = tensors[0].shape
    n_pad = _round_up(n, KERNEL_BLOCK)
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=tensors[0].device)
    key_valid = F.pad(mask.bool(), (0, n_pad - n), value=False)
    key_valid = key_valid[:, None].expand(b, h, n_pad).reshape(b * h, n_pad)
    return ([F.pad(t, (0, 0, 0, n_pad - n)).reshape(b * h, n_pad, d)
             for t in tensors], key_valid)


def flash_attention(q, k, v, mask=None, causal=False):
    """q, k, v: (b, h, n, d) with q pre-scaled; mask: (b, n) key validity.
    Returns (b, h, n, d) in q's dtype, differentiable in q, k, v."""
    b, h, n, d = q.shape
    width = kernel_width(d, q.dtype)
    if width != d:  # zero-padded heads
        return flash_attention(*(F.pad(t, (0, width - d))
                                 for t in (q, k, v)), mask, causal)[..., :d]
    (qf, kf, vf), key_valid = pad_flat((q, k, v), mask)
    out = FlashCore.apply(qf, kf, vf, key_valid, causal)
    return out.reshape(b, h, -1, d)[:, :, :n]
