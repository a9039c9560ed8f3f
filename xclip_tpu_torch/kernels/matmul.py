"""The product kernel alone: out = epilogue(opA · opB), fp32 accumulation.

Every product of the FF block (K-FF, K1, K1-h, K-FF-s, the recompute
backward) and of the attention megablock (K-MEGA, K2, K3) runs on one of
two hand-written kernels inside those blocks' own entry points: bf16 on
`csrc/gemm_sm90.cu` (TMA-fed wgmma), fp32 on `csrc/gemm_f32.cu`
(cp.async-fed, register-tiled FMAs in full fp32, no TF32); their
counterparts are the `dot_general` calls in their Pallas bodies. `mm`
calls them alone, for tests and timing.

opA is `a` (m x k) or, with `ta`, `a`ᵀ for `a` (k x m); opB is `b` (k x n)
or, with `tb`, `b`ᵀ for `b` (n x k). Epilogues, on the fp32 product acc:

* "store": T(acc), the storage dtype;
* "store_f32": acc in fp32; with `k_split`, the fp32 partials over the
  k-ranges [z·k_split, (z + 1)·k_split) (the last ragged at k), shaped
  (parts, m, n), which the blocks sum in range order (`ordered_sum`);
* "geglu": a·gelu(b) in fp32, where `b` is (k, 2n) and a, b are acc's
  column halves (the FF block's [a, b] = xn·W_in);
* "geglu_triple": (a·gelu(b), T(gelu(b)), T(a·gelu'(b))), K1's forward;
* "geglu_h": (a·gelu(b), T(acc)), K1-h's forward (h = [a, b] rounded);
* "residual": T(acc) + resid, the add in T (the FF block's out product).

`mm` takes the kernel for CUDA tensors and its plain version `mm_plain`
for CPU tensors; on a CUDA tensor it launches the kernel or raises: n not
a multiple of 64 raises, and in bf16 so does an operand TMA cannot take (a
pointer not 16-byte aligned, a row stride not a multiple of 16 bytes).
`mm.launches` counts its own launches; each kernel's launches from every
caller, the blocks' included, are counted inside the library per instance
(`kernel_launches`).
"""

from __future__ import annotations

import math

import torch

from . import _build
from ._common import (check_kernel_args, dtype_code, geglu_parts, gelu_grad,
                      route, stream_ptr)

# csrc/common.cuh's epilogue codes
EPILOGUES = {"store": 0, "store_f32": 1, "geglu": 2, "residual": 3,
             "geglu_triple": 4, "geglu_h": 5}
# the (epilogue, ta, tb) instances both kernels are built for, in the
# order of their launch counters (csrc/gemm_sm90.cu gemm_instance)
INSTANCES = (("store", False, False), ("store_f32", False, False),
             ("store_f32", False, True), ("store_f32", True, False),
             ("geglu", False, False), ("geglu_triple", False, False),
             ("geglu_h", False, False), ("residual", False, False))
# the bf16 kernel's tile (csrc/gemm_sm90.cuh): rows, columns, k slice; the
# persistent blocks it runs (132 SMs, one block each)
TILE_M, TILE_N, SLICE = 128, 256, 64
SLOTS = 132
# the fp32 kernel's tile (rows and columns, csrc/gemm_sm90.cuh
# kGemmF32Tile), its blocks in flight (two an SM) and its split-k ranges'
# multiple
F32_TILE, F32_SLOTS, F32_ALIGN = 128, 2 * SLOTS, 32


def split(m: int, n: int, k: int, dtype=torch.bfloat16,
          k_block: int = 0) -> int:
    """The k-range length csrc/common.cuh `gemm_split` gives an (m x n)
    weight gradient over k rows: k_block itself when given; else the
    fewest ranges (each at least 1024 rows, at most two work tiles a slot)
    whose work tiles fill the kernel's slots to within 10 % in their last
    wave (else the fullest): in bf16 128 x 256 tiles on 132 persistent
    blocks, ranges a multiple of the 64-deep k slice; in fp32 128 x 128
    tiles on two blocks an SM, ranges a multiple of 32."""
    if k_block > 0:
        return k_block
    bf16 = dtype == torch.bfloat16
    tiles = (math.ceil(m / TILE_M)
             * math.ceil(n / (TILE_N if bf16 else F32_TILE)))
    slots = SLOTS if bf16 else F32_SLOTS
    most = min(math.ceil(2 * slots / tiles), k // 1024)
    parts, best = 1, 0.0
    for p in range(1, most + 1):
        fill = tiles * p / (math.ceil(tiles * p / slots) * slots)
        if fill > best + 1e-9:
            parts, best = p, fill
        if fill >= 0.9:
            break
    align = SLICE if bf16 else F32_ALIGN
    return math.ceil(math.ceil(k / parts) / align) * align


def k_ranges(k: int, k_split: int):
    """[(kb, ke), ...]: the k-ranges of length k_split, the last ragged."""
    return [(kb, min(kb + k_split, k)) for kb in range(0, k, k_split)]


def ordered_sum(parts):
    """The partials (parts, m, n) summed in range order, in fp32, as
    csrc/common.cuh `launch_reduce_parts` sums them (its slab and wide
    kernels)."""
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total


def _operands(a, b, epilogue, ta, tb):
    """(m, n, k) of the product, n the output's width."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"mm: unknown epilogue {epilogue!r}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("mm: a and b must be matrices")
    m, k = (a.shape[1], a.shape[0]) if ta else a.shape
    kb, n = (b.shape[1], b.shape[0]) if tb else b.shape
    if kb != k:
        raise ValueError(f"mm: inner extents {k} and {kb} differ")
    if epilogue.startswith("geglu"):
        if tb or n % 2:
            raise ValueError("mm: the GEGLU epilogues take b as (k, 2n)")
        n //= 2
    return m, n, k


def mm_plain(a, b, epilogue="store_f32", ta=False, tb=False, resid=None,
             k_split=None):
    """Plain PyTorch version in the kernel's rounding points: the operands
    in fp32, the product over the same k-ranges, the same epilogue."""
    m, n, k = _operands(a, b, epilogue, ta, tb)
    dtype = a.dtype
    A = a.float().T if ta else a.float()
    B = b.float().T if tb else b.float()
    if k_split is not None:
        if epilogue != "store_f32":
            raise ValueError("mm: only 'store_f32' splits k")
        return torch.stack([A[:, kb:ke] @ B[kb:ke]
                            for kb, ke in k_ranges(k, k_split)])
    acc = A @ B
    if epilogue == "store":
        return acc.to(dtype)
    if epilogue == "store_f32":
        return acc
    if epilogue == "residual":
        return (acc.to(dtype).float() + resid.float()).to(dtype)
    a_half, b_half, phi, gelu_b = geglu_parts(acc)
    prod = a_half * gelu_b
    if epilogue == "geglu":
        return prod
    if epilogue == "geglu_triple":
        return (prod, gelu_b.to(dtype),
                (a_half * gelu_grad(b_half, phi)).to(dtype))
    return prod, acc.to(dtype)


def mm(a, b, epilogue="store_f32", ta=False, tb=False, resid=None,
       k_split=None):
    """out = epilogue(opA · opB); returns what `mm_plain` returns."""
    tensors = (a, b) if resid is None else (a, b, resid)
    if not route("mm", tensors):
        return mm_plain(a, b, epilogue, ta, tb, resid, k_split)
    check_kernel_args("mm", tensors, a.dtype)
    m, n, k = _operands(a, b, epilogue, ta, tb)
    if (epilogue == "residual") != (resid is not None) or (
            resid is not None and resid.shape != (m, n)):
        raise ValueError("mm: 'residual' takes resid (m, n), and only it")
    parts = 1 if k_split is None else len(k_ranges(k, k_split))
    if k_split is not None and epilogue != "store_f32":
        raise ValueError("mm: only 'store_f32' splits k")
    dev, dt = a.device, a.dtype

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    aux1 = aux2 = None
    if epilogue in ("store", "residual"):
        out = new(m, n, dtype=dt)
    elif epilogue == "store_f32":
        out = new(parts, m, n) if k_split is not None else new(m, n)
    else:
        out = new(m, n)
        if epilogue == "geglu_triple":
            aux1, aux2 = new(m, n, dtype=dt), new(m, n, dtype=dt)
        elif epilogue == "geglu_h":
            aux1 = new(m, 2 * n, dtype=dt)
    with torch.cuda.device(dev):
        err = _build.library().xclip_mm(
            dtype_code(dt), EPILOGUES[epilogue], int(ta), int(tb),
            a.data_ptr(), b.data_ptr(),
            None if resid is None else resid.data_ptr(), out.data_ptr(),
            None if aux1 is None else aux1.data_ptr(),
            None if aux2 is None else aux2.data_ptr(), m, n, k, parts,
            k_split or 0, stream_ptr(dev))
    _build.check(err, "xclip_mm")
    mm.launches += 1
    if epilogue == "geglu_triple":
        return out, aux1, aux2
    if epilogue == "geglu_h":
        return out, aux1
    return out


mm.launches = 0  # kernel launches by mm (plain calls not counted)


def library_split(m: int, n: int, k: int, dtype=torch.bfloat16,
                  k_block: int = 0) -> int:
    """`split` as the compiled library computes it (needs the library)."""
    return _build.library().xclip_mm_split(dtype_code(dtype), m, n, k,
                                           k_block)


def kernel_launches(reset: bool = False, dtype=torch.bfloat16):
    """{instance: launches of the product kernel of `dtype` (bf16: the
    wgmma kernel, fp32: the FMA kernel) since the library was loaded or
    last reset}, from every caller; `reset` sets them to 0 after reading
    them."""
    lib = _build.library()
    return {inst: lib.xclip_mm_launches(dtype_code(dtype), i, int(reset))
            for i, inst in enumerate(INSTANCES)}
