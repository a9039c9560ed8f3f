"""Numerics shared by the kernels' plain versions, and the wrappers' checks.

`geglu_parts` and `gelu_grad` are the GEGLU of the FF kernels; `eps_for`,
`ln_fp32` and `ln_bwd` are the counterparts of
`xclip_tpu/kernels/_common.py`; the CUDA kernels compute the same gain-only
LayerNorm (two-pass fp32 statistics) and its vjp in `csrc/common.cuh`.
"""

from __future__ import annotations

import math

import torch

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# The head widths the attention kernels take (K6, the megablock's core,
# K7): in bf16 any multiple of 8 up to BF16_MAX_HEAD, read at its true width
# as ⌈dim_head / 64⌉ 64-column halves; in fp32 the FMA core's 64 and 128.
BF16_MAX_HEAD = 256
F32_HEAD_WIDTHS = (64, 128)

# The memory-lean training routes (K-FF-s / K3 forwards, the recompute
# backwards) take their rows in chunks whose transients (the recomputed
# activations, the backward's scratch) stay under this many bytes, so a
# large batch's peak is one chunk's worth rather than the whole batch's.
# Each wrapper sizes its chunks from its kernel's own scratch: the
# workspace query of the CUDA entry point, or the scratch tensors it
# allocates. 1 GiB: at dim 512 about 24,000 rows of the FF recompute
# backward (~42 KB of workspace per bf16 row) and 250 text sequences of
# the attention one.
CHUNK_BYTES = 1 << 30


def chunk_spans(total: int, nbytes, bound: int = CHUNK_BYTES,
                align: int = 1):
    """[(start, stop), ...] covering range(total) in the fewest chunks
    whose scratch, `nbytes(count)` bytes for a chunk of `count` items (a
    count that grows with the items), stays under `bound`, sized as evenly
    as the count allows; every chunk but the last holds a multiple of
    `align` items (at least `align`, whatever the bound)."""
    lo, hi = 1, max(1, math.ceil(total / align))   # chunk sizes in aligns
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if nbytes(mid * align) <= bound:
            lo = mid
        else:
            hi = mid - 1
    n = max(1, math.ceil(total / (lo * align)))
    size = max(align, math.ceil(math.ceil(total / n) / align) * align)
    return [(s, min(s + size, total)) for s in range(0, total, size)]


def eps_for(dtype) -> float:
    """Dtype-dependent LayerNorm eps: 1e-5 for fp32, 1e-3 otherwise."""
    return 1e-5 if dtype == torch.float32 else 1e-3


def ln_stats_fp32(x32, eps):
    """(mean, rsqrt(var + eps)) over the last axis, two-pass (the training
    forwards store both)."""
    mean = x32.mean(dim=-1, keepdim=True)
    c = x32 - mean
    return mean, torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)


def ln_fp32(x32, g32, eps):
    """Gain-only LayerNorm in fp32 over the last axis: returns (xhat·g, xhat, inv)."""
    mean, inv = ln_stats_fp32(x32, eps)
    xhat = (x32 - mean) * inv
    return xhat * g32, xhat, inv


_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def geglu_parts(h32):
    """(a, b, Φ(b), gelu(b)) of an fp32 h = [a, b] over the last axis: the
    exact (erf) GELU as b·Φ(b), the op sequence of the kernels'
    `GegluParts` (csrc/common.cuh)."""
    inner = h32.shape[-1] // 2
    a, b = h32[..., :inner], h32[..., inner:]
    phi = 0.5 * (1.0 + torch.erf(b * _INV_SQRT2))
    return a, b, phi, b * phi


def gelu_grad(b, phi):
    """gelu'(b) = Φ(b) + b·φ(b) (`_gelu_val_grad`), Φ(b) given."""
    return phi + b * (torch.exp(-0.5 * b * b) * 0.3989422804014327)


def ln_bwd(dy, xhat, inv, g32):
    """Gain-only LayerNorm vjp over rows → (dx, dg), dg summed over rows."""
    dg = (dy * xhat).sum(dim=0)
    dxhat = dy * g32
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return inv * (dxhat - m1 - xhat * m2), dg


def takes_width(dim_head: int, dtype, heads=None) -> bool:
    """Whether the attention kernels take heads of `dim_head` in `dtype` as
    they are: bf16 a multiple of 8 from 8 to BF16_MAX_HEAD (with `heads`,
    the megablock's, heads·dim_head also on the product kernel's 64-column
    grid: its qkv columns and out rows); fp32 one of F32_HEAD_WIDTHS."""
    if dtype == torch.bfloat16:
        return (dim_head % 8 == 0 and 8 <= dim_head <= BF16_MAX_HEAD
                and (heads is None or heads * dim_head % 64 == 0))
    return dim_head in F32_HEAD_WIDTHS


def kernel_width(dim_head: int, dtype, heads=None) -> int:
    """The width a head of `dim_head` runs at on the attention kernels in
    `dtype` (with `heads`, the megablock's): `dim_head` itself where
    `takes_width` holds, else the narrowest width above it that does (bf16:
    the next multiple of 8 whose heads fill the 64-column grid; fp32: 64 or
    128), zero-padded by the wrappers (exact: the zero columns of q and k
    add nothing to q·kᵀ, those of v nothing to the output, and their
    gradients are dropped). A head wider than any kernel takes (bf16 past
    BF16_MAX_HEAD, fp32 past 128) keeps its width: the CPU's plain versions
    run it, as JAX's bodies do, and the kernels' `why_not` refuses it on
    the card. Depends on the dtype and shapes alone, so the CPU's plain
    versions run at the card's width."""
    limit = BF16_MAX_HEAD if dtype == torch.bfloat16 else F32_HEAD_WIDTHS[-1]
    if dim_head > limit:
        return dim_head
    if dtype != torch.bfloat16:
        return next(w for w in F32_HEAD_WIDTHS if dim_head <= w)
    # a multiple of 64 fills the grid at any heads, so this ends by 256
    width = max(8, -(-dim_head // 8) * 8)
    while not takes_width(width, dtype, heads):
        width += 8
    return width


def width_words(dtype, megablock=False) -> str:
    """The head widths the attention kernels take in `dtype`, in words."""
    if dtype == torch.bfloat16:
        return (f"bf16 dim_head a multiple of 8 up to {BF16_MAX_HEAD}"
                + (" with heads·dim_head a multiple of 64" if megablock
                   else ""))
    return (f"fp32 dim_head {' or '.join(map(str, F32_HEAD_WIDTHS))} "
            f"(narrower zero-padded)")


def dot32(a, b):
    """a @ b with fp32 accumulation of storage-dtype operands."""
    return a.float() @ b.float()


def route(name: str, tensors) -> bool:
    """Which path a wrapper takes: False for the plain version (every tensor
    on the CPU), True for the kernel (every tensor on one CUDA device).
    Raises for mixed devices and other devices. Whether gradients flow is
    the caller's matter: the training kernels sit inside autograd
    Functions, the inference wrappers refuse inputs that require grad
    (`refuse_grad`)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    return True


def refuse_grad(name: str, tensors, training_route: str) -> None:
    """An inference-only forward has no backward: raise rather than return
    a result that silently stops gradients."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: this inference forward has no backward; call it under "
            f"torch.no_grad(), or train through {training_route}")


def check_kernel_args(name: str, tensors, dtype) -> None:
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"not {dtype}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def dtype_code(dtype) -> int:
    """The C entry points' dtype code (csrc/common.cuh kF32 / kBF16)."""
    return 0 if dtype == torch.float32 else 1


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
