"""Inputs shared by the port's kernel tests, made from a numpy seed so the
JAX package and the port see the same numbers. Imports no JAX: the
GPU-only tests use it on a machine without JAX."""

import numpy as np
import torch

# bf16 tolerance: two storage ulps at the test outputs' magnitude
# (|out| < 8, ulp 2^-5); both sides round at the same places and only
# summation order can flip a rounding
BF16_ATOL = 2 * 2.0 ** -5


def ff_args(R=40, D=64, I=128, seed=0):
    npr = np.random.RandomState(seed)
    return (npr.randn(R, D).astype(np.float32) * 0.5,
            (1 + 0.1 * npr.randn(D)).astype(np.float32),
            (npr.randn(D, 2 * I) / np.sqrt(D)).astype(np.float32),
            (1 + 0.1 * npr.randn(I)).astype(np.float32),
            (npr.randn(I, D) / np.sqrt(I)).astype(np.float32))


def mega_args(b=2, n=37, dim=128, heads=2, dim_head=64, seed=0,
              mask_kind="keypad"):
    npr = np.random.RandomState(seed)
    hd = heads * dim_head
    x = npr.randn(b, n, dim).astype(np.float32)
    mask = np.ones((b, n), dtype=bool)
    if mask_kind in ("keypad", "dead"):
        mask[0, n - 9:] = False
        mask[1, n // 2:] = False
    if mask_kind == "dead":
        mask[1, :] = False          # every row of element 1 has no valid key
    return (x, (1 + 0.1 * npr.randn(dim)).astype(np.float32),
            (npr.randn(dim, 3 * hd) / np.sqrt(dim)).astype(np.float32),
            (npr.randn(hd, dim) / np.sqrt(hd)).astype(np.float32),
            (1 + 0.1 * npr.randn(dim)).astype(np.float32), mask)


def to_torch(args, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype)
            if a.dtype != bool else torch.from_numpy(a).to(device)
            for a in args]


def to_np(t):
    return np.asarray(t, dtype=np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().cpu().numpy()


def _key_mask(b, n, mask_kind):
    """(b, n) key mask: "none" all valid; "keypad" a right-padded row 0 and
    a left-padded row 1; "dead" as keypad with row b - 1 all masked;
    "holes" as keypad with keys [n // 4, 3n // 4) of row 2 masked between
    valid ones (keys 64..191 at n = 257 or 256: two whole 64-key tiles)."""
    mask = np.ones((b, n), dtype=bool)
    if mask_kind in ("keypad", "dead", "holes"):
        mask[0, n - 9:] = False
        mask[1, :n // 3] = False
    if mask_kind == "dead":
        mask[b - 1, :] = False
    if mask_kind == "holes":
        mask[2, n // 4:3 * n // 4] = False
    return mask


def core_args(b=3, n=33, heads=2, seed=0, mask_kind="keypad", dim_head=64):
    """K6 inputs: the fused qkv (b, n, 3·heads·dim_head), the key mask and
    a cotangent of the output (b, n, heads·dim_head)."""
    npr = np.random.RandomState(seed)
    hd = heads * dim_head
    return (npr.randn(b, n, 3 * hd).astype(np.float32),
            _key_mask(b, n, mask_kind),
            npr.randn(b, n, hd).astype(np.float32))


def flash_args(b=3, h=2, n=37, seed=0, mask_kind="keypad", d=64):
    """K7 inputs: q (pre-scaled by d^-0.5), k, v (b, h, n, d), the key
    mask (b, n) and a cotangent of the output."""
    npr = np.random.RandomState(seed)
    q, k, v, do = (npr.randn(b, h, n, d).astype(np.float32)
                   for _ in range(4))
    return q * np.float32(d ** -0.5), k, v, _key_mask(b, n, mask_kind), do
