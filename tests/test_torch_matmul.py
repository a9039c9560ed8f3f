"""The product kernel's plain version (`xclip_tpu_torch.kernels.matmul`) on
the CPU: its GEGLU epilogues against the JAX package's `_gelu_val_grad`,
its other epilogues against the FF block's and the megablock's plain
compositions, and its split-k partition (the k-ranges `gemm_split` gives
the weight gradients) against an emulation of it, bit for bit.

Tolerances: GEGLU values 2e-6 of (1 + the largest |h|), absolute: the JAX
package's erf is Abramowitz-Stegun 7.1.26 (absolute error 1.5e-7, times
|a| or |b| in the products), the port's torch.erf; bf16 outputs that plus
one bf16 ulp of each element (the two erfs may put an fp32 value on
either side of a rounding boundary). The k-range partition, the partial
sums and the chunked sums are held bit for bit: they are the same fp32
operations in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.kernels.fused_ff_block import _gelu_val_grad
from xclip_tpu_torch.kernels import matmul
from xclip_tpu_torch.kernels._common import dot32
from xclip_tpu_torch.kernels.fused_ff_block import ROW_BLOCK
import torch_one_thread  # noqa: F401


def _bf16(npr, *shape, scale=1.0):
    return torch.from_numpy(
        (npr.randn(*shape) * scale).astype(np.float32)).to(torch.bfloat16)


def _ulp1(want):
    """One bf16 ulp of each element of `want` (fp32 values)."""
    w = want.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(w)) - 7)


@pytest.mark.parametrize("m,n,k", [(37, 64, 64), (130, 192, 128)])
def test_geglu_epilogues_match_jax_gelu(m, n, k):
    npr = np.random.RandomState(m)
    a, b = _bf16(npr, m, k), _bf16(npr, k, 2 * n, scale=2 * k ** -0.5)
    h = dot32(a, b)                       # the fp32 product both sides see
    gelu_b, gelu_db = (torch.from_numpy(np.array(t)) for t in
                       _gelu_val_grad(jnp.asarray(h[:, n:].numpy())))
    ah = h[:, :n]
    prod = matmul.mm_plain(a, b, "geglu")
    prod3, gb, agdb = matmul.mm_plain(a, b, "geglu_triple")
    prod_h, h_s = matmul.mm_plain(a, b, "geglu_h")
    want = ah * gelu_b
    atol = float(2e-6 * (1 + h.abs().max()))
    for got in (prod, prod3, prod_h):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
    for got, ref in ((gb, gelu_b), (agdb, ah * gelu_db)):
        assert got.dtype == torch.bfloat16
        assert ((got.float() - ref.to(torch.bfloat16).float()).abs()
                <= _ulp1(ref) + atol).all()
    assert torch.equal(h_s, h.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogues_match_the_blocks_plain_compositions(dtype):
    """'store', 'store_f32' with either transpose and 'residual' compute
    what the FF block's and the megablock's plain versions compute."""
    npr = np.random.RandomState(3)
    x = _bf16(npr, 77, 64).to(dtype)
    w = _bf16(npr, 64, 192, scale=0.125).to(dtype)
    y = _bf16(npr, 77, 128).to(dtype)
    w_out = _bf16(npr, 128, 64, scale=0.1).to(dtype)
    assert torch.equal(matmul.mm_plain(x, w, "store"), dot32(x, w).to(dtype))
    assert torch.equal(matmul.mm_plain(x, w), dot32(x, w))
    assert torch.equal(matmul.mm_plain(x, w.T.contiguous(), tb=True),
                       dot32(x, w))
    assert torch.equal(matmul.mm_plain(x, y, ta=True), dot32(x.T, y))
    assert torch.equal(matmul.mm_plain(y, w_out, "residual", resid=x),
                       dot32(y, w_out).to(dtype) + x)


def _split_emulated(m, n, k, bf16=True):
    """gemm_split written out again: the fewest ranges (each at least 1024
    rows, at most two blocks a slot) whose work tiles fill the kernel's
    slots to within 10 % in their last wave (else the fullest): bf16 128 x
    256 tiles on 132 persistent blocks, rounded up to the 64-deep k slice;
    fp32 128 x 128 tiles on 264 slots (two blocks an SM), rounded up to
    32."""
    width, slots, align = (256, 132, 64) if bf16 else (128, 264, 32)
    tiles = -(-m // 128) * -(-n // width)
    fills = {}
    for p in range(1, max(1, min(-(-2 * slots // tiles), k // 1024)) + 1):
        work = tiles * p
        fills[p] = work / (-(-work // slots) * slots)
    good = [p for p in fills if fills[p] >= 0.9]
    parts = min(good) if good else max(fills, key=lambda p: (fills[p], -p))
    return -(-(-(-k // parts)) // align) * align


SPLIT_SHAPES = [(512, 4096, 65_792), (2048, 512, 65_792), (512, 512, 65_792),
                (512, 1536, 65_792), (512, 4096, 24_576), (512, 512, 3_341),
                (64, 192, 77), (512, 1536, 526_336), (512, 4096, 8_448),
                (2048, 512, 8_448)]


@pytest.mark.parametrize("m,n,k", SPLIT_SHAPES)
def test_split_ranges_are_whole_k_slices(m, n, k):
    k_split = matmul.split(m, n, k)
    assert k_split == _split_emulated(m, n, k)
    assert k_split % matmul.SLICE == 0
    ranges = matmul.k_ranges(k, k_split)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(e == s2 for (_, e), (s2, _) in zip(ranges, ranges[1:]))
    assert all(kb % matmul.SLICE == 0 for kb, _ in ranges)
    assert len(ranges) == 1 or min(ke - kb for kb, ke in ranges[:-1]) >= 1024
    # fp32: the FMA kernel's 128 x 128 tiles, whole 16-deep slices
    k32 = matmul.split(m, n, k, torch.float32)
    assert k32 == _split_emulated(m, n, k, bf16=False)
    assert k32 % 32 == 0
    ranges32 = matmul.k_ranges(k, k32)
    assert ranges32[-1][1] == k
    assert len(ranges32) == 1 or min(
        ke - kb for kb, ke in ranges32[:-1]) >= 1024


def test_split_partials_match_an_emulation_bit_for_bit():
    npr = np.random.RandomState(5)
    k = 5_000
    a, b = _bf16(npr, k, 128), _bf16(npr, k, 192)
    k_split = matmul.split(128, 192, k)
    parts = matmul.mm_plain(a, b, ta=True, k_split=k_split)
    want = [a[kb:ke].float().T @ b[kb:ke].float()
            for kb in range(0, k, k_split) for ke in [min(kb + k_split, k)]]
    assert parts.shape == (len(want), 128, 192)
    for got, w in zip(parts, want):
        assert torch.equal(got, w)
    total = want[0].clone()
    for w in want[1:]:
        total = total + w
    assert torch.equal(matmul.ordered_sum(parts), total)
    # the CPU wrapper is the plain version, and counts no launch
    before = matmul.mm.launches
    assert torch.equal(matmul.mm(a, b, ta=True, k_split=k_split), parts)
    assert matmul.mm.launches == before


@pytest.mark.parametrize("chunks", [[0, 4096, 9_000], [0, 2048, 4096, 9_000],
                                    [0, 9_000]])
def test_row_block_partials_do_not_depend_on_the_chunking(chunks):
    """The recompute backward's weight gradients: k-ranges of exactly
    ROW_BLOCK rows, chunks starting at multiples of it, each chunk's
    ordered partial sum added onto the running fp32 sum in chunk order:
    the same bits however the rows are chunked."""
    npr = np.random.RandomState(7)
    rows = chunks[-1]
    a, b = _bf16(npr, rows, 64), _bf16(npr, rows, 128)
    assert matmul.split(64, 128, rows, k_block=ROW_BLOCK) == ROW_BLOCK
    whole = matmul.mm_plain(a, b, ta=True, k_split=ROW_BLOCK)
    total, pieces = None, []
    for s, e in zip(chunks, chunks[1:]):
        assert s % ROW_BLOCK == 0
        part = matmul.mm_plain(a[s:e], b[s:e], ta=True, k_split=ROW_BLOCK)
        pieces.append(part)
        total = part[0].clone() if total is None else total + part[0]
        for p in part[1:]:
            total += p
    assert torch.equal(torch.cat(pieces), whole)
    assert torch.equal(total, matmul.ordered_sum(whole))


def test_operand_checks():
    a, b = torch.zeros(8, 64), torch.zeros(32, 128)
    with pytest.raises(ValueError, match="inner extents"):
        matmul.mm_plain(a, b)
    with pytest.raises(ValueError, match="unknown epilogue"):
        matmul.mm_plain(a, torch.zeros(64, 128), "relu")
    with pytest.raises(ValueError, match="only 'store_f32' splits"):
        matmul.mm_plain(a, torch.zeros(64, 128), "store", k_split=64)
    with pytest.raises(ValueError, match="GEGLU epilogues take b"):
        matmul.mm_plain(a, torch.zeros(64, 127), "geglu")
