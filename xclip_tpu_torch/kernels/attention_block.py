"""K6: whole-head attention on the fused qkv, the counterpart of
`xclip_tpu.kernels.attention_block.attention_core` (Pallas `_fwd_kernel`
through `_attention_fwd`, `_bwd_kernel` through `_attention_bwd`).

    attention_core(qkv, mask, heads, dim_head, scale, causal, maybe_dead)

takes the (b, n, 3·heads·dim_head) output of the qkv product (q | k | v,
head h at columns h·dim_head of each third) and returns the heads' outputs
in the residual-stream layout (b, n, heads·dim_head), differentiable in qkv.
The text tower runs it when rotary embeddings turn the megablock off
(`nn/layers.py`), on the rotated qkv.

* `attention_core_fwd` → (out, lse): scores (q·k)·scale in fp32, -inf on
  masked and future keys; with `maybe_dead` a row with no valid key gets m
  = 0 and uniform weights over the n keys; l = max(Σp, 1e-30); p/l cast to
  qkv's dtype before p·v; lse = m + log l in fp32, (b, n, heads).
* `attention_core_bwd` → dqkv in the fused layout: p = exp(s − lse) (1/n
  on a dead row), Δ = Σ do·out from the stored out, ds = p·(do·vᵀ − Δ)·scale
  (0 on a dead row) cast to qkv's dtype, dq = ds·k, dk = dsᵀ·q, dv =
  T(p)ᵀ·do.

The CUDA kernels are `csrc/attention_block.cu`: bf16 on the K6 mode of
`csrc/attention_block_sm90.cuh` (register-resident mma.sync tiles at
heads of 64; at 128 a TMA-fed wgmma forward and dq kernel beside a 4-warp
mma.sync dk/dv kernel; all skip causal and all-masked tiles; its source
notes give the design and what bounds it), whose megablock mode runs the
attention megablock's core; fp32 on the megablock's FMA core (`csrc/attention_core.cuh`). The
length limit is the megablock's, `attention_megablock.seq_len_limit` (2048
in both dtypes, the kernels' mask words, in training too),
and so is the predicate of what the kernels take,
`attention_megablock.why_not` with no block width. The kernels take heads
of 64 and 128 (two 64-column halves); `attention_core` runs a narrower
head on them zero-padded to the next of those
(`attention_megablock.pad_heads`, exact: 80 runs at 128). Every wrapper
takes its kernel
for CUDA tensors and its plain version for CPU tensors; it never falls back
from one to the other.
The Pallas kernel's padding to 128 rows and two-head groups are TPU
artefacts: the kernels work on the true shapes.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import (check_kernel_args, dot32, dtype_code, padded_width,
                      route, stream_ptr)
from .attention_megablock import _check_core as _check
from .attention_megablock import (_heads, _softmax_parts, pad_heads,
                                  unpad_heads)


def supported(heads: int, dim_head: int) -> bool:
    """Whether the JAX kernel's head groups (128 lanes) tile `heads` heads of
    `dim_head`: the reference routes `attn_impl='fused'` to its plain path
    otherwise (`xclip_tpu/nn/layers.py:170-175`), and so does the port."""
    hpg = max(1, 128 // dim_head)   # heads per group
    return (hpg * dim_head) % 128 == 0 and heads % hpg == 0


def _qkv_heads(qkv, heads, dim_head):
    b, n, _ = qkv.shape
    hd = heads * dim_head
    return [_heads(qkv[..., i * hd:(i + 1) * hd], b, n, heads, dim_head)
            for i in range(3)]


def attention_core_fwd_plain(qkv, mask, heads, dim_head, scale, causal=False,
                             maybe_dead=True):
    """`_fwd_kernel` in PyTorch → (out (b, n, heads·dim_head) in qkv.dtype,
    lse (b, n, heads) fp32)."""
    b, n, _ = qkv.shape
    q, k, v = _qkv_heads(qkv, heads, dim_head)
    s, dead = _softmax_parts(q, k, mask, scale, causal, maybe_dead)
    m = s.amax(dim=-1, keepdim=True)
    if dead is not None:
        m = torch.where(dead, 0.0, m)
        p = torch.where(dead, 1.0, torch.exp(s - m))
    else:
        p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = dot32((p / l).to(qkv.dtype), v).to(qkv.dtype)           # (b, h, n, d)
    out = o.transpose(1, 2).reshape(b, n, heads * dim_head)
    lse = (m + torch.log(l)).squeeze(-1).transpose(1, 2)        # (b, n, h)
    return out, lse.contiguous()


def attention_core_bwd_plain(qkv, mask, out, lse, dout, heads, dim_head,
                             scale, causal=False, maybe_dead=True):
    """`_bwd_kernel` in PyTorch → dqkv (b, n, 3·heads·dim_head) in
    qkv.dtype."""
    dtype = qkv.dtype
    b, n, _ = qkv.shape
    q, k, v = _qkv_heads(qkv, heads, dim_head)
    do = _heads(dout.to(dtype), b, n, heads, dim_head)
    o = _heads(out, b, n, heads, dim_head)
    s, dead = _softmax_parts(q, k, mask, scale, causal, maybe_dead)
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    if dead is not None:   # the forward's uniform weights, 1/n
        p = torch.where(dead, 1.0 / n, p)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dot32(do, v.transpose(-1, -2)) - delta) * scale
    if dead is not None:   # no gradient reaches a dead row's scores
        ds = torch.where(dead, 0.0, ds)
    ds = ds.to(dtype)
    parts = (dot32(ds, k), dot32(ds.transpose(-1, -2), q),
             dot32(p.to(dtype).transpose(-1, -2), do))
    return torch.cat([t.transpose(1, 2).reshape(b, n, heads * dim_head)
                      for t in parts], dim=-1).to(dtype)


def attention_core_fwd(qkv, mask, heads, dim_head, scale, causal=False,
                       maybe_dead=True, training=False):
    """K6 forward → (out, lse) as the plain version. `training`: raise now
    for a length the backward kernels do not take."""
    if not route("attention_core_fwd", (qkv, mask)):
        return attention_core_fwd_plain(qkv, mask, heads, dim_head, scale,
                                        causal, maybe_dead)
    b, n = _check("attention_core_fwd", qkv, mask, heads, dim_head, training)
    dev, dt = qkv.device, qkv.dtype
    mask_u8 = mask.to(torch.uint8).contiguous()
    out = torch.empty((b, n, heads * dim_head), dtype=dt, device=dev)
    lse = torch.empty((b, n, heads), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # launch on the tensors' card
        err = _build.library().xclip_attention_core_fwd(
            dtype_code(dt), qkv.data_ptr(), mask_u8.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, n, heads, dim_head,
            float(scale), int(causal), int(maybe_dead), stream_ptr(dev))
    _build.check(err, "xclip_attention_core_fwd")
    attention_core_fwd.launches += 1
    return out, lse


attention_core_fwd.launches = 0  # kernel launches (plain calls not counted)


def attention_core_bwd(qkv, mask, out, lse, dout, heads, dim_head, scale,
                       causal=False, maybe_dead=True):
    """K6 backward → dqkv as the plain version."""
    if not route("attention_core_bwd", (qkv, mask, out, lse, dout)):
        return attention_core_bwd_plain(qkv, mask, out, lse, dout, heads,
                                        dim_head, scale, causal, maybe_dead)
    b, n = _check("attention_core_bwd", qkv, mask, heads, dim_head, True)
    check_kernel_args("attention_core_bwd", (out, dout), qkv.dtype)
    check_kernel_args("attention_core_bwd", (lse,), torch.float32)
    if out.shape != (b, n, heads * dim_head) or dout.shape != out.shape \
            or lse.shape != (b, n, heads):
        raise ValueError("attention_core_bwd: inconsistent shapes "
                         f"{[tuple(t.shape) for t in (qkv, out, lse, dout)]}")
    if out.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("attention_core_bwd: the kernels take a 16-byte "
                         "aligned out and do")
    dev, dt = qkv.device, qkv.dtype
    mask_u8 = mask.to(torch.uint8).contiguous()
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, n, heads), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().xclip_attention_core_bwd(
            dtype_code(dt), qkv.data_ptr(), mask_u8.data_ptr(),
            out.data_ptr(), lse.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
            delta.data_ptr(), b, n, heads, dim_head, float(scale),
            int(causal), int(maybe_dead), stream_ptr(dev))
    _build.check(err, "xclip_attention_core_bwd")
    attention_core_bwd.launches += 1
    return dqkv


attention_core_bwd.launches = 0


class AttentionCore(torch.autograd.Function):
    """K6: whole-head attention, forward and backward kernels."""

    @staticmethod
    def forward(ctx, qkv, mask, heads, dim_head, scale, causal, maybe_dead,
                training):
        out, lse = attention_core_fwd(qkv, mask, heads, dim_head, scale,
                                      causal, maybe_dead, training)
        ctx.save_for_backward(qkv, mask, out, lse)
        ctx.static = (heads, dim_head, scale, causal, maybe_dead)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, mask, out, lse = ctx.saved_tensors
        dqkv = attention_core_bwd(qkv, mask, out, lse,
                                  dout.to(qkv.dtype).contiguous(),
                                  *ctx.static)
        return dqkv, *([None] * 7)


def attention_core(qkv, mask, heads, dim_head, scale, causal=False,
                   maybe_dead=True):
    """qkv: (b, n, 3·heads·dim_head); mask: (b, n) bool, True = a valid key.
    Returns (b, n, heads·dim_head) in qkv.dtype, differentiable in qkv.
    `maybe_dead=False` may be passed when every row has a valid key."""
    width = padded_width(dim_head)
    if width != dim_head:
        return unpad_heads(attention_core(
            pad_heads(qkv, dim_head), mask, heads, width, scale, causal,
            maybe_dead), dim_head)
    training = torch.is_grad_enabled() and qkv.requires_grad
    return AttentionCore.apply(qkv.contiguous(), mask, heads, dim_head, scale,
                               causal, maybe_dead, training)
