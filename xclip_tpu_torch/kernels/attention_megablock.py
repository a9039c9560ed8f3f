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
  gives dx, dqkv, dW_qkv, dW_out, dg_pre and dg_out;
* K3, the memory-lean training route `attention_block_train_recompute`
  (`AttentionBlockRecompute`), the counterpart of `attention_block(...,
  store_qkv=False)` and, with `keep_qkv`, of `store_qkv="qkv"`: the
  forward `attention_block_fwd_stats` (Pallas `_fwd_kernel_stats`,
  `_fwd_kernel_qkv`) keeps `sm`, `ln_stats` and, with `keep_qkv`, qkv; the
  backward `attention_block_bwd_recompute` (Pallas `_bwd_kernel`,
  `_bwd_kernel_qkv`) re-derives qkv (unless kept), attnout and the fp32
  proj with the forward's own launches, then runs K2's backward on them.
  Both kernels walk the batch in chunks under `_common.CHUNK_BYTES` of
  scratch, the backward summing dW and dg over the chunks in order, in
  fp32, cast once; their plain versions take the whole batch at once.

* the attention core alone, `mega_core_fwd` / `mega_core_bwd`: the
  attention step every variant runs (softmax(q·kᵀ·scale)·v per head from
  the fused qkv, keeping `sm`; its backward from the fp32 row cotangent
  dattn), for tests and timing. Its counters also count every megablock
  wrapper call that runs it.

The CUDA kernels are `csrc/attention_megablock.cu`; its source notes give
the designs, what bounds them on the card and which intermediates cross
HBM. The attention core runs in bf16 on the megablock mode of K6's
kernels (`csrc/attention_block_sm90.cuh`: mma.sync at one, three and four
64-column halves, wgmma forward and dq at two) at a head's true width, any
multiple of 8 up to 256 whose heads fill the product kernel's 64-column
grid (ViT-H/14's 16 x 80: qkv 3,840 columns); in fp32 on the FMA core of
`csrc/attention_core.cuh` at heads of 64 and 128. Any other head runs
zero-padded to the width `_common.kernel_width` gives (`pad_heads`).
Every wrapper takes its kernel for CUDA tensors and its
plain version for CPU tensors; it never falls back from one to the
other. The Pallas version's 128/16-row alignment and transposed
stats layout are TPU artefacts: the kernels work on the true (b, n, ·)
shapes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._common import (CHUNK_BYTES, KERNEL_DTYPES, check_kernel_args,
                      chunk_spans, dot32, dtype_code, eps_for, kernel_width,
                      ln_bwd, ln_stats_fp32, refuse_grad, route, stream_ptr,
                      takes_width, width_words)
from .rows import MAX_WIDTH

DIM_HEAD = 64   # the flagship's head width, the chunk helpers' default


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
    out, (qkv, attnout, proj, sm, ln_stats) = _forward_plain(
        x, g_pre, w_qkv, w_out, g_out, mask, heads, dim_head, scale, causal,
        maybe_dead)
    return out, (qkv, attnout, proj.to(x.dtype), sm, ln_stats)


def _forward_plain(x, g_pre, w_qkv, w_out, g_out, mask, heads, dim_head,
                   scale, causal, maybe_dead, qkv=None):
    """The forward's five steps → (out, (qkv, attnout, proj in fp32, sm,
    ln_stats)); a given (b·n, 3·hd) `qkv` skips the first two."""
    dtype = x.dtype
    b, n, _ = x.shape
    hd = heads * dim_head
    eps = eps_for(dtype)
    x32 = x.float()
    mean_pre, inv_pre = ln_stats_fp32(x32, eps)
    if qkv is None:
        xn = (((x32 - mean_pre) * inv_pre) * g_pre.float()).to(dtype)
        qkv = dot32(xn, w_qkv).to(dtype)
    qkv = qkv.reshape(b, n, 3 * hd)
    attnout, sm = mega_core_fwd_plain(qkv, mask, heads, dim_head, scale,
                                      causal, maybe_dead)
    proj = dot32(attnout, w_out)
    mean_o, inv_o = ln_stats_fp32(proj, eps)
    out = (((proj - mean_o) * inv_o) * g_out.float()).to(dtype) + x
    ln_stats = torch.stack([mean_pre, inv_pre, mean_o, inv_o]).reshape(4, -1)
    return out, (qkv.reshape(b * n, 3 * hd), attnout.reshape(b * n, hd),
                 proj.reshape(b * n, -1), sm.reshape(b * n, 2 * heads),
                 ln_stats)


def mega_core_fwd_plain(qkv, mask, heads, dim_head, scale, causal=False,
                        maybe_dead=True):
    """The megablock's attention step in PyTorch, in `_fwd_common`'s cast
    order → (attnout (b, n, heads·dim_head) in qkv.dtype, sm (b, n,
    2·heads) fp32: each row's softmax max m per head, then its normaliser
    l; m = 0 and l = n on a dead row)."""
    dtype = qkv.dtype
    b, n, _ = qkv.shape
    hd = heads * dim_head
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
    sm = torch.cat([m, l], dim=1).squeeze(-1).permute(0, 2, 1)   # (b, n, 2h)
    return attnout, sm.contiguous()


def mega_core_bwd_plain(qkv, mask, dattn, attnout, sm, heads, dim_head,
                        scale, causal=False, maybe_dead=True):
    """The attention part of `_bwd_kernel_stored` / `_bwd_kernel` in
    PyTorch → dqkv (b, n, 3·heads·dim_head) in qkv.dtype, from the fp32
    row cotangent dattn (b, n, heads·dim_head) and the forward's sm: p =
    (dead ? 1 : exp(s − m)) / l from the stored pair, Δ = scale·Σ
    dattn·attnout, dp = T(dattn·scale)·vᵀ, ds = T(p·(dp − Δ)) (0 on a dead
    row; the scale sits on do, not on ds), dq = ds·k, dk = dsᵀ·q, dv =
    T(p)ᵀ·T(dattn)."""
    dtype = qkv.dtype
    b, n, _ = qkv.shape
    hd = heads * dim_head
    q, k, v = (_heads(qkv[..., i * hd:(i + 1) * hd], b, n, heads, dim_head)
               for i in range(3))
    s, dead = _softmax_parts(q, k, mask, scale, causal, maybe_dead)
    m, l = (sm[..., i * heads:(i + 1) * heads].permute(0, 2, 1)[..., None]
            for i in range(2))
    p = torch.exp(s - m)
    if dead is not None:
        p = torch.where(dead, 1.0, p)
    p = p / l
    do_h = _heads(dattn.float(), b, n, heads, dim_head)          # fp32
    delta = (do_h * _heads(attnout, b, n, heads, dim_head).float() * scale
             ).sum(dim=-1, keepdim=True)
    dp = dot32((do_h * scale).to(dtype), v.transpose(-1, -2))
    ds = p * (dp - delta)
    if dead is not None:
        ds = torch.where(dead, 0.0, ds)
    ds = ds.to(dtype)
    parts = (dot32(ds, k), dot32(ds.transpose(-1, -2), q),
             dot32(p.to(dtype).transpose(-1, -2), do_h.to(dtype)))
    return torch.cat([t.transpose(1, 2).reshape(b, n, hd) for t in parts],
                     dim=-1).to(dtype)


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
    """Longest sequence the attention core's forward takes in `dtype`,
    the megablock's and K6's alike: 2048 in both, the mask words of 32 key
    tiles (the bf16 mma.sync kernels and the fp32 FMA forward alike keep
    no score row whole). Needs the built library."""
    return _build.library().xclip_attention_block_max_n(dtype_code(dtype))


def max_seq_len_bwd(dtype) -> int:
    """Longest sequence the attention core's backward takes in `dtype`:
    2048 in both, the mask words of 32 key tiles."""
    return _build.library().xclip_attention_block_bwd_max_n(dtype_code(dtype))


def seq_len_limit(dtype, training=False) -> int:
    """The longest sequence a wrapper of the attention core takes in
    `dtype`: the forward's limit, with `training` the backward's too (2048
    either way, in both dtypes, for inference and training). The
    megablock's wrappers, its core's and K6's all read it (in bf16 they run
    the same kernels, in fp32 the same FMA core)."""
    return (min(max_seq_len(dtype), max_seq_len_bwd(dtype)) if training
            else max_seq_len(dtype))


def pad_heads(t, dim_head, dim=-1, width=None):
    """`t` with each head slice of `dim_head` along `dim` (q, k and v's
    heads, or the heads alone) zero-padded to `width`, by default the
    head's `kernel_width` in t's dtype (the megablock's wrappers pass the
    one its heads give): where the kernels do not take a head as it is it
    runs so (fp32's 80 → 128, bf16's 100 → 104). Exact: the zero columns
    of q and k add nothing to q·kᵀ, those of v and of w_out's rows add
    nothing to the output, and their gradients are dropped by autograd
    (the scale stays the caller's). Padding the weights widens the
    megablock's qkv and out products by the padding too."""
    width = width or kernel_width(dim_head, t.dtype)
    t = t.movedim(dim, -1)
    lead = t.shape[:-1]
    t = F.pad(t.reshape(*lead, -1, dim_head), (0, width - dim_head))
    return t.reshape(*lead, -1).movedim(-1, dim).contiguous()


def unpad_heads(t, dim_head, width=None):
    """The inverse of `pad_heads` along the last dimension."""
    width = width or kernel_width(dim_head, t.dtype)
    lead = t.shape[:-1]
    return t.reshape(*lead, -1, width)[..., :dim_head].reshape(*lead, -1)


def why_not(dim, heads, dim_head, n, dtype, training=False):
    """Why the CUDA kernels cannot take this megablock (`dim` its width) or,
    with `dim` None, this attention core (K6's, the megablock's alone): a
    sentence naming the limit, or None when they can. The wrappers raise on
    it before any launch (the top-level ones pad a head to its
    `kernel_width` first)."""
    if dtype not in KERNEL_DTYPES:
        return (f"the CUDA attention kernels take float32 or bfloat16, not "
                f"{dtype}")
    if not takes_width(dim_head, dtype, None if dim is None else heads):
        return (f"the CUDA attention kernels take "
                f"{width_words(dtype, dim is not None)}, not {dim_head}"
                + (f" ({heads} heads)" if dim is not None else ""))
    if dim is not None and (dim % 64 or dim > MAX_WIDTH):
        return (f"the CUDA megablock takes dim a multiple of 64 up to "
                f"{MAX_WIDTH}, not {dim}")
    limit = seq_len_limit(dtype, training)
    if n > limit:
        return (f"n {n} exceeds the CUDA attention kernels' {limit} in "
                f"{dtype}" + (" training" if training else ""))
    return None


def _check(name, tensors, mask, heads, dim_head, training=False):
    x, g_pre, w_qkv, w_out, g_out = tensors
    b, n, dim = x.shape
    hd = heads * dim_head
    check_kernel_args(name, tensors, x.dtype)
    reason = why_not(dim, heads, dim_head, n, x.dtype, training)
    if reason:
        raise ValueError(f"{name}: {reason}")
    if (g_pre.shape != (dim,) or g_out.shape != (dim,)
            or w_qkv.shape != (dim, 3 * hd) or w_out.shape != (hd, dim)
            or mask.shape != (b, n)):
        raise ValueError(f"{name}: inconsistent shapes "
                         f"{[t.shape for t in tensors + (mask,)]}")
    return b, n, dim, hd


def _fwd_scratch(rows, dim, hd, dtype, device, keep_qkv=False):
    """The forward launches' scratch for `rows` rows: xn, qkv (None when
    the caller keeps it), attnout, the fp32 proj."""
    return (torch.empty((rows, dim), dtype=dtype, device=device),
            None if keep_qkv else torch.empty((rows, 3 * hd), dtype=dtype,
                                              device=device),
            torch.empty((rows, hd), dtype=dtype, device=device),
            torch.empty((rows, dim), dtype=torch.float32, device=device))


def _fwd_kernel(name, tensors, mask, heads, dim_head, scale, causal,
                maybe_dead, stored):
    """Launch the forward kernel → (out, residuals or None); with `stored`,
    the K2 residuals as the plain version returns. One launch over the
    whole batch: K-MEGA and K2 keep what they allocate here."""
    x = tensors[0]
    b, n, dim, hd = _check(name, tensors, mask, heads, dim_head,
                           training=stored)
    dev, dt = x.device, x.dtype
    rows = b * n
    mask_u8 = mask.to(torch.uint8).contiguous()
    out = torch.empty_like(x)
    xn, qkv, attnout, proj = _fwd_scratch(rows, dim, hd, dt, dev)
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
            *residual_ptrs, rows, b, n, dim, heads, dim_head, float(scale),
            int(causal), int(maybe_dead), eps_for(dt), stream_ptr(dev))
    _build.check(err, "xclip_attention_block_fwd")
    mega_core_fwd.launches += 1
    return out, residuals


def attention_block(x, g_pre, w_qkv, w_out, g_out, mask, heads, dim_head,
                    scale, causal=False, maybe_dead=True):
    """x: (b, n, dim); mask: (b, n) bool, True = valid key; w_qkv:
    (dim, 3·heads·dim_head); w_out: (heads·dim_head, dim); gains (dim,).
    Returns x + LN(W_out · attention(LN(x)·W_qkv)) in x.dtype. Forward only:
    training goes through `attention_block_train`. `maybe_dead=False` may
    be passed when every row has a valid key."""
    width = kernel_width(dim_head, x.dtype, heads)
    if width != dim_head:
        return attention_block(x, g_pre,
                               pad_heads(w_qkv, dim_head, width=width),
                               pad_heads(w_out, dim_head, 0, width),
                               g_out, mask, heads, width, scale, causal,
                               maybe_dead)
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
    dx, dqkv, (dw_qkv, dw_out, dg_pre, dg_out) = _bwd_core_plain(
        x, g_pre, w_qkv, w_out, g_out, mask, dout, *stored, heads, dim_head,
        scale, causal, maybe_dead)
    dtype = x.dtype
    return (dx, dg_pre.to(dtype), dw_qkv.to(dtype), dw_out.to(dtype),
            dg_out.to(dtype), dqkv)


def _bwd_core_plain(x, g_pre, w_qkv, w_out, g_out, mask, dout, qkv, attnout,
                    proj, sm, ln_stats, heads, dim_head, scale, causal,
                    maybe_dead):
    """The backward from qkv, attnout and proj (K2's rounded one or K3's
    fp32 one) → (dx, dqkv, (dW_qkv, dW_out, dg_pre, dg_out)), dx and dqkv in
    x.dtype, the sums over the rows in fp32."""
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
    dw_out = dot32(attnout.T, dproj)

    dqkv = mega_core_bwd_plain(
        qkv.reshape(b, n, 3 * hd), mask, dattn.reshape(b, n, hd),
        attnout.reshape(b, n, hd), sm.reshape(b, n, 2 * heads), heads,
        dim_head, scale, causal, maybe_dead).reshape(rows, 3 * hd)

    dxn = dot32(dqkv, w_qkv.T)
    xhat_pre = (x2.float() - mean_pre) * inv_pre
    dx_pre, dg_pre = ln_bwd(dxn, xhat_pre, inv_pre, g_pre.float())
    dx = (dx_pre + do.float()).to(dtype).reshape(b, n, dim)
    xn = (xhat_pre * g_pre.float()).to(dtype)
    return dx, dqkv, (dot32(xn.T, dqkv), dw_out, dg_pre, dg_out)


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
        dtype_code(dt), b, n, dim, heads, dim_head), dtype=torch.uint8,
        device=dev)
    with torch.cuda.device(dev):
        err = lib.xclip_attention_block_bwd(
            dtype_code(dt), *(t.data_ptr() for t in (
                x, g_pre, w_qkv, w_out, g_out, mask_u8, dout, *stored, dx,
                dqkv, dw_qkv, dw_out, dg_pre, dg_out, ws)),
            b, n, dim, heads, dim_head, float(scale), int(causal),
            int(maybe_dead), stream_ptr(dev))
    _build.check(err, "xclip_attention_block_bwd")
    attention_block_bwd.launches += 1
    mega_core_bwd.launches += 1
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
    width = kernel_width(dim_head, x.dtype, heads)
    if width != dim_head:
        w_qkv = pad_heads(w_qkv, dim_head, width=width)
        w_out = pad_heads(w_out, dim_head, 0, width)
        dim_head = width
    return AttentionBlock.apply(x, g_pre, w_qkv, w_out, g_out, mask, heads,
                                dim_head, scale, causal, maybe_dead)


# ------------------------------------------------------------ K3

def fwd_stats_spans(b, n, dim, heads, dtype, keep_qkv, dim_head=DIM_HEAD):
    """K3's forward batch chunks: [(start, stop), ...] of batch elements
    whose scratch (`_fwd_scratch`) stays under CHUNK_BYTES."""
    return chunk_spans(b, lambda k: sum(
        t.nbytes for t in _fwd_scratch(k * n, dim, heads * dim_head, dtype,
                                       "meta", keep_qkv) if t is not None),
        CHUNK_BYTES)


def bwd_recompute_spans(b, n, dim, heads, dtype, keep_qkv,
                        dim_head=DIM_HEAD):
    """K3's backward batch chunks: [(start, stop), ...] of batch elements
    whose workspace (the CUDA entry point's query) stays under
    CHUNK_BYTES. Needs the built library."""
    lib = _build.library()
    return chunk_spans(
        b, lambda k: lib.xclip_attention_block_bwd_recompute_workspace(
            dtype_code(dtype), k, n, dim, heads, dim_head, int(keep_qkv)),
        CHUNK_BYTES)


def attention_block_fwd_stats_plain(x, g_pre, w_qkv, w_out, g_out, mask,
                                    heads, dim_head, scale, causal=False,
                                    maybe_dead=True, keep_qkv=False):
    """Plain K3 forward → (out, sm, ln_stats, qkv or None), the cast order
    of `_fwd_kernel_stats` / `_fwd_kernel_qkv`."""
    out, (qkv, _, _, sm, ln_stats) = _forward_plain(
        x, g_pre, w_qkv, w_out, g_out, mask, heads, dim_head, scale, causal,
        maybe_dead)
    return out, sm, ln_stats, qkv if keep_qkv else None


def attention_block_fwd_stats(x, g_pre, w_qkv, w_out, g_out, mask, heads,
                              dim_head, scale, causal=False, maybe_dead=True,
                              keep_qkv=False):
    """K3 forward: (out, sm, ln_stats, qkv or None) as the plain version.
    The kernel takes the batch in chunks (`fwd_stats_spans`), so its xn,
    qkv, attnout and fp32 proj scratch stays under CHUNK_BYTES; with
    `keep_qkv` qkv is written whole."""
    tensors = (x, g_pre, w_qkv, w_out, g_out)
    if not route("attention_block_fwd_stats", tensors + (mask,)):
        return attention_block_fwd_stats_plain(
            x, g_pre, w_qkv, w_out, g_out, mask, heads, dim_head, scale,
            causal, maybe_dead, keep_qkv)
    b, n, dim, hd = _check("attention_block_fwd_stats", tensors, mask, heads,
                           dim_head, training=True)
    dev, dt = x.device, x.dtype
    rows = b * n
    mask_u8 = mask.to(torch.uint8).contiguous()
    out = torch.empty_like(x)
    sm = torch.empty((rows, 2 * heads), dtype=torch.float32, device=dev)
    ln_stats = torch.empty((4, rows), dtype=torch.float32, device=dev)
    kept = (torch.empty((rows, 3 * hd), dtype=dt, device=dev)
            if keep_qkv else None)
    spans = fwd_stats_spans(b, n, dim, heads, dt, keep_qkv, dim_head)
    xn, qkv, attnout, proj = _fwd_scratch(spans[0][1] * n if spans else 0,
                                          dim, hd, dt, dev, keep_qkv)
    lib = _build.library()
    with torch.cuda.device(dev):
        for s, e in spans:
            r = s * n
            err = lib.xclip_attention_block_fwd(
                dtype_code(dt), x[s:].data_ptr(),
                *(t.data_ptr() for t in tensors[1:]), mask_u8[s:].data_ptr(),
                out[s:].data_ptr(), xn.data_ptr(),
                (kept[r:] if keep_qkv else qkv).data_ptr(),
                attnout.data_ptr(), proj.data_ptr(), None,
                sm[r:].data_ptr(), ln_stats[0, r:].data_ptr(), rows, e - s, n,
                dim, heads, dim_head, float(scale), int(causal),
                int(maybe_dead), eps_for(dt), stream_ptr(dev))
            _build.check(err, "xclip_attention_block_fwd")
    attention_block_fwd_stats.launches += 1
    mega_core_fwd.launches += 1
    return out, sm, ln_stats, kept


attention_block_fwd_stats.launches = 0


def attention_block_bwd_recompute_plain(x, g_pre, w_qkv, w_out, g_out, mask,
                                        dout, sm, ln_stats, heads, dim_head,
                                        scale, causal=False, maybe_dead=True,
                                        qkv=None):
    """`_bwd_kernel` / `_bwd_kernel_qkv` on the whole batch: re-derive qkv
    (unless given), attnout and the fp32 proj as the forward does, then the
    backward with the fp32 proj; returns as
    `attention_block_bwd_recompute`, the sums in fp32 and cast once."""
    _, (qkv, attnout, proj, _, _) = _forward_plain(
        x, g_pre, w_qkv, w_out, g_out, mask, heads, dim_head, scale, causal,
        maybe_dead, qkv)
    dx, _, sums = _bwd_core_plain(
        x, g_pre, w_qkv, w_out, g_out, mask, dout, qkv, attnout, proj, sm,
        ln_stats, heads, dim_head, scale, causal, maybe_dead)
    dw_qkv, dw_out, dg_pre, dg_out = (t.to(x.dtype) for t in sums)
    return dx, dg_pre, dw_qkv, dw_out, dg_out


def attention_block_bwd_recompute(x, g_pre, w_qkv, w_out, g_out, mask, dout,
                                  sm, ln_stats, heads, dim_head, scale,
                                  causal=False, maybe_dead=True, qkv=None):
    """K3 backward from x, dout, the forward's sm and ln_stats and, when it
    kept it, qkv → (dx, dg_pre, dW_qkv, dW_out, dg_out) in x.dtype. The
    kernel takes the batch in chunks (`bwd_recompute_spans`) whose
    workspace stays under CHUNK_BYTES; the chunks' fp32 sums are added in
    chunk order and cast once."""
    tensors = (x, g_pre, w_qkv, w_out, g_out)
    kept = () if qkv is None else (qkv,)
    if not route("attention_block_bwd_recompute",
                 tensors + (mask, dout, sm, ln_stats) + kept):
        return attention_block_bwd_recompute_plain(
            x, g_pre, w_qkv, w_out, g_out, mask, dout, sm, ln_stats, heads,
            dim_head, scale, causal, maybe_dead, qkv)
    b, n, dim, hd = _check("attention_block_bwd_recompute", tensors, mask,
                           heads, dim_head, training=True)
    check_kernel_args("attention_block_bwd_recompute", (dout,) + kept,
                      x.dtype)
    check_kernel_args("attention_block_bwd_recompute", (sm, ln_stats),
                      torch.float32)
    spans = bwd_recompute_spans(b, n, dim, heads, x.dtype, qkv is not None,
                                dim_head)
    dev, dt = x.device, x.dtype
    rows = b * n
    mask_u8 = mask.to(torch.uint8).contiguous()
    dx = torch.empty_like(x)
    sums = [torch.empty(shape, dtype=torch.float32, device=dev)
            for shape in ((dim, 3 * hd), (hd, dim), (dim,), (dim,))]
    lib = _build.library()
    ws = torch.empty(lib.xclip_attention_block_bwd_recompute_workspace(
        dtype_code(dt), spans[0][1], n, dim, heads, dim_head,
        qkv is not None), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        for k, (s, e) in enumerate(spans):
            r = s * n
            err = lib.xclip_attention_block_bwd_recompute(
                dtype_code(dt), x[s:].data_ptr(),
                *(t.data_ptr() for t in tensors[1:]), mask_u8[s:].data_ptr(),
                dout[s:].data_ptr(), qkv[r:].data_ptr() if kept else None,
                sm[r:].data_ptr(), ln_stats[0, r:].data_ptr(), rows,
                dx[s:].data_ptr(), *(t.data_ptr() for t in sums),
                ws.data_ptr(), e - s, n, dim, heads, dim_head, float(scale),
                int(causal), int(maybe_dead), eps_for(dt), 1 if k == 0 else 2,
                stream_ptr(dev))
            _build.check(err, "xclip_attention_block_bwd_recompute")
    attention_block_bwd_recompute.launches += 1
    mega_core_fwd.launches += 1   # the recompute of attnout
    mega_core_bwd.launches += 1
    dw_qkv, dw_out, dg_pre, dg_out = (t.to(dt) for t in sums)
    return dx, dg_pre, dw_qkv, dw_out, dg_out


attention_block_bwd_recompute.launches = 0


class AttentionBlockRecompute(torch.autograd.Function):
    """K3: the memory-lean attention megablock; `keep_qkv` keeps qkv."""

    @staticmethod
    def forward(ctx, x, g_pre, w_qkv, w_out, g_out, mask, heads, dim_head,
                scale, causal, maybe_dead, keep_qkv):
        x = x.contiguous()
        out, sm, ln_stats, qkv = attention_block_fwd_stats(
            x, g_pre, w_qkv, w_out, g_out, mask, heads, dim_head, scale,
            causal, maybe_dead, keep_qkv)
        kept = () if qkv is None else (qkv,)
        ctx.save_for_backward(x, g_pre, w_qkv, w_out, g_out, mask, sm,
                              ln_stats, *kept)
        ctx.static = (heads, dim_head, scale, causal, maybe_dead)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, g_pre, w_qkv, w_out, g_out, mask, sm, ln_stats, *kept = \
            ctx.saved_tensors
        grads = attention_block_bwd_recompute(
            x, g_pre, w_qkv, w_out, g_out, mask,
            dout.to(x.dtype).contiguous(), sm, ln_stats, *ctx.static,
            qkv=kept[0] if kept else None)
        return (*grads, *([None] * 7))


def attention_block_train_recompute(x, g_pre, w_qkv, w_out, g_out, mask,
                                    heads, dim_head, scale, causal=False,
                                    maybe_dead=True, keep_qkv=False):
    """x + LN(W_out · attention(LN(x)·W_qkv)) keeping only row statistics
    (and qkv with `keep_qkv`) for the recompute backward; differentiable in
    the five tensors. Same arguments as `attention_block`."""
    width = kernel_width(dim_head, x.dtype, heads)
    if width != dim_head:
        w_qkv = pad_heads(w_qkv, dim_head, width=width)
        w_out = pad_heads(w_out, dim_head, 0, width)
        dim_head = width
    return AttentionBlockRecompute.apply(x, g_pre, w_qkv, w_out, g_out, mask,
                                         heads, dim_head, scale, causal,
                                         maybe_dead, keep_qkv)


# ------------------------------------------------ the attention core alone

def _check_core(name, qkv, mask, heads, dim_head, training):
    """The checks of the attention core's wrappers (the megablock's and
    K6's) → (b, n)."""
    b, n, width = qkv.shape
    check_kernel_args(name, (qkv,), qkv.dtype)
    reason = why_not(None, heads, dim_head, n, qkv.dtype, training)
    if reason:
        raise ValueError(f"{name}: {reason}")
    if width != 3 * heads * dim_head:
        raise ValueError(f"{name}: qkv of width {width} for {heads} heads of "
                         f"{dim_head}")
    if mask.shape != (b, n):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} for qkv "
                         f"{tuple(qkv.shape)}")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{name}: the kernels take a 16-byte aligned qkv")
    return b, n


def mega_core_fwd(qkv, mask, heads, dim_head, scale, causal=False,
                  maybe_dead=True):
    """The megablock's attention step alone → (attnout, sm) as
    `mega_core_fwd_plain`; qkv (b, n, 3·heads·dim_head), mask (b, n)
    bool."""
    if not route("mega_core_fwd", (qkv, mask)):
        return mega_core_fwd_plain(qkv, mask, heads, dim_head, scale, causal,
                                   maybe_dead)
    b, n = _check_core("mega_core_fwd", qkv, mask, heads, dim_head, False)
    dev, dt = qkv.device, qkv.dtype
    mask_u8 = mask.to(torch.uint8).contiguous()
    attnout = torch.empty((b, n, heads * dim_head), dtype=dt, device=dev)
    sm = torch.empty((b, n, 2 * heads), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().xclip_mega_core_fwd(
            dtype_code(dt), qkv.data_ptr(), mask_u8.data_ptr(),
            attnout.data_ptr(), sm.data_ptr(), b, n, heads, dim_head,
            float(scale), int(causal), int(maybe_dead), stream_ptr(dev))
    _build.check(err, "xclip_mega_core_fwd")
    mega_core_fwd.launches += 1
    return attnout, sm


# launches of the core's forward: by this wrapper, and one by each call of
# a megablock wrapper that runs it (K-MEGA, K2 and K3 forwards, K3's
# recompute backward); plain calls not counted
mega_core_fwd.launches = 0


def mega_core_bwd(qkv, mask, dattn, attnout, sm, heads, dim_head, scale,
                  causal=False, maybe_dead=True):
    """The megablock's attention backward alone → dqkv as
    `mega_core_bwd_plain`; dattn (b, n, heads·dim_head) fp32."""
    if not route("mega_core_bwd", (qkv, mask, dattn, attnout, sm)):
        return mega_core_bwd_plain(qkv, mask, dattn, attnout, sm, heads,
                                   dim_head, scale, causal, maybe_dead)
    b, n = _check_core("mega_core_bwd", qkv, mask, heads, dim_head, True)
    check_kernel_args("mega_core_bwd", (attnout,), qkv.dtype)
    check_kernel_args("mega_core_bwd", (dattn, sm), torch.float32)
    hd = heads * dim_head
    if (dattn.shape != (b, n, hd) or attnout.shape != dattn.shape
            or sm.shape != (b, n, 2 * heads)):
        raise ValueError("mega_core_bwd: inconsistent shapes "
                         f"{[tuple(t.shape) for t in (qkv, dattn, attnout, sm)]}")
    if dattn.data_ptr() % 16 or attnout.data_ptr() % 16:
        raise ValueError("mega_core_bwd: the kernels take a 16-byte aligned "
                         "dattn and attnout")
    dev, dt = qkv.device, qkv.dtype
    mask_u8 = mask.to(torch.uint8).contiguous()
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, n, heads), dtype=torch.float32, device=dev)
    # bf16: the dq kernel's two bf16 copies of dattn (the megablock writes
    # them over its own dattn scratch)
    dcopy = (torch.empty((b, n, 2 * hd), dtype=dt, device=dev)
             if dt == torch.bfloat16 else None)
    with torch.cuda.device(dev):
        err = _build.library().xclip_mega_core_bwd(
            dtype_code(dt), qkv.data_ptr(), mask_u8.data_ptr(),
            dattn.data_ptr(), attnout.data_ptr(), sm.data_ptr(),
            dqkv.data_ptr(), delta.data_ptr(),
            None if dcopy is None else dcopy.data_ptr(), b, n, heads,
            dim_head, float(scale), int(causal), int(maybe_dead),
            stream_ptr(dev))
    _build.check(err, "xclip_mega_core_bwd")
    mega_core_bwd.launches += 1
    return dqkv


# launches of the core's backward: by this wrapper, and one by each call
# of K2's or K3's backward
mega_core_bwd.launches = 0
