"""The port's CUDA kernels against their plain versions, on a GPU.

Every test here needs a CUDA device and nvcc and skips elsewhere; the
module imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest configures JAX). fp32 is compared at
1e-4 absolute with TF32 off; bf16 at two storage ulps. The training
kernels' outputs and gradients are compared at 1e-4 (fp32) or two bf16
ulps of each tensor's largest magnitude; K5's lse (fp32, |lse| < 20) at
1e-4 absolute. K6, K7 and the megablock's attention core alone (out,
the fp32 statistics, every gradient) element by element:
fp32 outputs and every lse at 1e-4 of the tensor's largest magnitude,
bf16 outputs at two bf16 ulps of the element plus 3e-2 of its head row's
RMS plus 1e-2 of the tensor's, and each within 1e-3 relative Frobenius
error; the plain versions follow the kernels' rounding points (K7's plain
forward with the kernels' key block, `KERNEL_BLOCK`). K8 and K1-h as the
training kernels: 1e-4 (fp32) or two bf16 ulps of each tensor's largest
magnitude. The row kernels alone (every mode of the LayerNorm and GEGLU
backward rows): bf16 outputs at two ulps of each tensor's largest
magnitude, fp32 outputs and the dg partials at 1e-4 of it. The ordered
sums of partials bit for bit against the strict left-to-right sum.
"""

import math

import pytest
import torch

from xclip_tpu_torch.kernels import attention_block as core
from xclip_tpu_torch.kernels import attention_megablock as mega
from xclip_tpu_torch.kernels import flash_attention as flash
from xclip_tpu_torch.kernels import fused_ff as k8
from xclip_tpu_torch.kernels import fused_ff_block as ffb
from xclip_tpu_torch.kernels import fused_infonce as lse5
from xclip_tpu_torch.kernels import _common as kcommon
from xclip_tpu_torch.kernels import matmul
from xclip_tpu_torch.kernels import rows as rows_mod

from torch_port_inputs import (BF16_ATOL, _key_mask, core_args, ff_args,
                               flash_args, mega_args, to_torch)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels run only on "
                    "the card; python3 chip_smoke.py runs them there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,dim,inner", [(130, 128, 256), (77, 64, 128)])
def test_ff_block_kernel_matches_plain(cuda_device, dtype, rows, dim, inner):
    args = to_torch(ff_args(R=rows, D=dim, I=inner), getattr(torch, dtype),
                    cuda_device)
    before = ffb.ff_block.launches
    got = ffb.ff_block(*args)
    assert ffb.ff_block.launches == before + 1
    want = ffb.ff_block_plain(*args)
    atol = 1e-4 if dtype == "float32" else BF16_ATOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "keypad", "dead"])
@pytest.mark.parametrize("n,dim,heads", [(70, 128, 2), (33, 64, 1)])
def test_attention_block_kernel_matches_plain(cuda_device, dtype, causal,
                                              mask_kind, n, dim, heads):
    args = to_torch(mega_args(n=n, dim=dim, heads=heads, mask_kind=mask_kind),
                    getattr(torch, dtype), cuda_device)
    static = (heads, 64, 0.125, causal, mask_kind != "none")
    before = mega.attention_block.launches
    got = mega.attention_block(*args, *static)
    assert mega.attention_block.launches == before + 1
    want = mega.attention_block_plain(*args, *static)
    atol = 1e-4 if dtype == "float32" else BF16_ATOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


# ---------------------------------------------------------- training: K1, K2

def _grad_atol(want, dtype):
    """fp32: 1e-4 of the tensor's largest magnitude (dW sums every row, in
    another order); bf16: two storage ulps of it."""
    top = max(float(want.float().abs().max()), 1.0)
    if dtype == "float32":
        return 1e-4 * top
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7)


def _assert_all_close(got, want, dtype, names):
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype, name
        assert torch.isfinite(g.float()).all(), name
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=_grad_atol(w, dtype), msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,dim,inner", [(130, 128, 256), (77, 64, 128),
                                            (8192, 512, 2048)])
def test_ff_block_train_kernels_match_plain(cuda_device, dtype, rows, dim,
                                            inner):
    args = to_torch(ff_args(R=rows, D=dim, I=inner), getattr(torch, dtype),
                    cuda_device)
    counts = (ffb.ff_block_fwd_stored.launches, ffb.ff_block_bwd_p1.launches,
              ffb.ff_block_bwd_p2.launches)
    out, stored = ffb.ff_block_fwd_stored(*args)
    want_out, want_stored = ffb.ff_block_fwd_stored_plain(*args)
    _assert_all_close((out, *stored), (want_out, *want_stored), dtype,
                      ("out", "prod", "gelu_b", "agdb", "stats"))
    do = torch.randn(rows, dim, device=cuda_device).to(args[0].dtype)
    p1 = ffb.ff_block_bwd_p1(*args, do, want_stored)
    want_p1 = ffb.ff_block_bwd_p1_plain(*args, do, want_stored)
    names = ("dx", "dprod", "dg_pre", "dg_inner")
    _assert_all_close(p1[:4], want_p1[:4], dtype, names)
    _assert_all_close(p1[4], want_p1[4], dtype, ("xn", "dh2", "y2"))
    p2 = ffb.ff_block_bwd_p2(*want_p1[4], do)
    _assert_all_close(p2, ffb.ff_block_bwd_p2_plain(*want_p1[4], do), dtype,
                      ("dw_in", "dw_out"))
    assert (ffb.ff_block_fwd_stored.launches, ffb.ff_block_bwd_p1.launches,
            ffb.ff_block_bwd_p2.launches) == tuple(c + 1 for c in counts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "keypad", "dead"])
@pytest.mark.parametrize("n,dim,heads", [(70, 128, 2), (33, 64, 1)])
def test_attention_block_train_kernels_match_plain(cuda_device, dtype, causal,
                                                   mask_kind, n, dim, heads):
    args = to_torch(mega_args(n=n, dim=dim, heads=heads, mask_kind=mask_kind),
                    getattr(torch, dtype), cuda_device)
    static = (heads, 64, 0.125, causal, mask_kind != "none")
    counts = (mega.attention_block_fwd_stored.launches,
              mega.attention_block_bwd.launches)
    out, stored = mega.attention_block_fwd_stored(*args, *static)
    want_out, want_stored = mega.attention_block_fwd_stored_plain(*args,
                                                                  *static)
    _assert_all_close((out, *stored), (want_out, *want_stored), dtype,
                      ("out", "qkv", "attnout", "proj", "sm", "ln_stats"))
    do = torch.randn(*out.shape, device=cuda_device).to(out.dtype)
    got = mega.attention_block_bwd(*args, do, want_stored, *static)
    want = mega.attention_block_bwd_plain(*args, do, want_stored, *static)
    _assert_all_close(got, want, dtype, ("dx", "dg_pre", "dw_qkv", "dw_out",
                                         "dg_out", "dqkv"))
    assert (mega.attention_block_fwd_stored.launches,
            mega.attention_block_bwd.launches) == (counts[0] + 1,
                                                   counts[1] + 1)


@pytest.mark.cuda
def test_attention_block_train_kernels_flagship_shape(cuda_device):
    """(b, n, dim, heads) = (16, 257, 512, 8), bf16, key-pad mask."""
    torch.manual_seed(0)
    b, n, dim, heads = 16, 257, 512, 8
    dt = torch.bfloat16
    lengths = torch.randint(1, n + 1, (b,), device=cuda_device)
    mask = torch.arange(n, device=cuda_device)[None] < lengths[:, None]
    hd = heads * 64
    args = [torch.randn(b, n, dim, device=cuda_device).to(dt),
            (1 + 0.1 * torch.randn(dim, device=cuda_device)).to(dt),
            (torch.randn(dim, 3 * hd, device=cuda_device) / dim ** 0.5).to(dt),
            (torch.randn(hd, dim, device=cuda_device) / hd ** 0.5).to(dt),
            (1 + 0.1 * torch.randn(dim, device=cuda_device)).to(dt), mask]
    static = (heads, 64, 64 ** -0.5, False, True)
    out, stored = mega.attention_block_fwd_stored(*args, *static)
    want_out, want_stored = mega.attention_block_fwd_stored_plain(*args,
                                                                  *static)
    _assert_all_close((out, *stored), (want_out, *want_stored), "bfloat16",
                      ("out", "qkv", "attnout", "proj", "sm", "ln_stats"))
    do = torch.randn_like(out)
    _assert_all_close(
        mega.attention_block_bwd(*args, do, want_stored, *static),
        mega.attention_block_bwd_plain(*args, do, want_stored, *static),
        "bfloat16", ("dx", "dg_pre", "dw_qkv", "dw_out", "dg_out", "dqkv"))


@pytest.mark.cuda
def test_training_kernels_are_deterministic(cuda_device):
    """No float atomics: two backward runs agree bit for bit."""
    args = to_torch(mega_args(n=70, dim=128, heads=2, mask_kind="keypad"),
                    torch.bfloat16, cuda_device)
    out, stored = mega.attention_block_fwd_stored(*args, 2, 64, 0.125)
    do = torch.randn(*out.shape, device=cuda_device).to(out.dtype)
    a = mega.attention_block_bwd(*args, do, stored, 2, 64, 0.125)
    b = mega.attention_block_bwd(*args, do, stored, 2, 64, 0.125)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    fargs = to_torch(ff_args(R=4000, D=128, I=256), torch.bfloat16,
                     cuda_device)
    _, fstored = ffb.ff_block_fwd_stored(*fargs)
    do = torch.randn(4000, 128, device=cuda_device).to(torch.bfloat16)
    p1a = ffb.ff_block_bwd_p1(*fargs, do, fstored)
    p1b = ffb.ff_block_bwd_p1(*fargs, do, fstored)
    assert all(torch.equal(x, y) for x, y in zip(p1a[:4], p1b[:4]))
    assert all(torch.equal(x, y) for x, y in
               zip(ffb.ff_block_bwd_p2(*p1a[4], do),
                   ffb.ff_block_bwd_p2(*p1b[4], do)))


# ------------------------------------ memory-lean training: K-FF-s, K3, K5

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,dim,inner", [(130, 128, 256), (77, 64, 128),
                                            (8192, 512, 2048)])
def test_ff_block_lean_kernels_match_plain(cuda_device, dtype, rows, dim,
                                           inner):
    args = to_torch(ff_args(R=rows, D=dim, I=inner), getattr(torch, dtype),
                    cuda_device)
    counts = (ffb.ff_block_fwd_stats.launches,
              ffb.ff_block_bwd_recompute.launches)
    out, stats = ffb.ff_block_fwd_stats(*args)
    want_out, want_stats = ffb.ff_block_fwd_stats_plain(*args)
    _assert_all_close((out, stats), (want_out, want_stats), dtype,
                      ("out", "stats"))
    do = torch.randn(rows, dim, device=cuda_device).to(args[0].dtype)
    _assert_all_close(
        ffb.ff_block_bwd_recompute(*args, do, want_stats),
        ffb.ff_block_bwd_recompute_plain(*args, do, want_stats), dtype,
        ("dx", "dg_pre", "dw_in", "dg_inner", "dw_out"))
    assert (ffb.ff_block_fwd_stats.launches,
            ffb.ff_block_bwd_recompute.launches) == (counts[0] + 1,
                                                     counts[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ff_block_recompute_chunks_agree_bit_for_bit(cuda_device,
                                                     monkeypatch, dtype):
    """Row chunks start at multiples of ROW_BLOCK and the dW partials cover
    ROW_BLOCK rows each: one chunk and three (one ragged) give the same
    bits, and so do two runs; the chunked forward matches the whole one."""
    rows, dim, inner = 2 * ffb.ROW_BLOCK + 904, 128, 256
    dt = getattr(torch, dtype)
    args = to_torch(ff_args(R=rows, D=dim, I=inner), dt, cuda_device)
    out, stats = ffb.ff_block_fwd_stats(*args)
    do = torch.randn(rows, dim, device=cuda_device).to(dt)
    whole = ffb.ff_block_bwd_recompute(*args, do, stats)
    again = ffb.ff_block_bwd_recompute(*args, do, stats)
    monkeypatch.setattr(ffb, "CHUNK_BYTES", sum(
        t.nbytes for t in ffb._fwd_scratch(2000, dim, inner, dt, "meta")))
    assert len(ffb.fwd_stats_spans(rows, dim, inner, dt)) == 3
    out3, stats3 = ffb.ff_block_fwd_stats(*args)
    assert torch.equal(out, out3) and torch.equal(stats, stats3)
    monkeypatch.setattr(
        ffb, "CHUNK_BYTES",
        ffb._build.library().xclip_ff_block_bwd_recompute_workspace(
            ffb.dtype_code(dt), ffb.ROW_BLOCK, dim, inner, ffb.ROW_BLOCK))
    assert len(ffb.bwd_recompute_spans(rows, dim, inner, dt)) == 3
    chunked = ffb.ff_block_bwd_recompute(*args, do, stats)
    for a, b, c in zip(whole, again, chunked):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "keypad", "dead"])
@pytest.mark.parametrize("n,dim,heads", [(70, 128, 2), (33, 64, 1)])
@pytest.mark.parametrize("keep_qkv", [False, True])
def test_attention_block_lean_kernels_match_plain(cuda_device, dtype, causal,
                                                  mask_kind, n, dim, heads,
                                                  keep_qkv):
    args = to_torch(mega_args(n=n, dim=dim, heads=heads, mask_kind=mask_kind),
                    getattr(torch, dtype), cuda_device)
    static = (heads, 64, 0.125, causal, mask_kind != "none")
    counts = (mega.attention_block_fwd_stats.launches,
              mega.attention_block_bwd_recompute.launches)
    got = mega.attention_block_fwd_stats(*args, *static, keep_qkv)
    want = mega.attention_block_fwd_stats_plain(*args, *static, keep_qkv)
    assert (got[3] is None) == (want[3] is None) == (not keep_qkv)
    _assert_all_close(got[:3] + got[3:] * keep_qkv,
                      want[:3] + want[3:] * keep_qkv, dtype,
                      ("out", "sm", "ln_stats", "qkv"))
    do = torch.randn(*got[0].shape, device=cuda_device).to(got[0].dtype)
    _, sm, ln_stats, qkv = want
    _assert_all_close(
        mega.attention_block_bwd_recompute(*args, do, sm, ln_stats, *static,
                                           qkv=qkv),
        mega.attention_block_bwd_recompute_plain(*args, do, sm, ln_stats,
                                                 *static, qkv=qkv),
        dtype, ("dx", "dg_pre", "dw_qkv", "dw_out", "dg_out"))
    assert (mega.attention_block_fwd_stats.launches,
            mega.attention_block_bwd_recompute.launches) == (counts[0] + 1,
                                                            counts[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("keep_qkv", [False, True])
def test_attention_block_lean_kernels_flagship_shape(cuda_device,
                                                     monkeypatch, keep_qkv):
    """(b, n, dim, heads) = (16, 257, 512, 8), bf16, key-pad mask, the
    batch in three chunks; two backward runs agree bit for bit."""
    torch.manual_seed(1)
    b, n, dim, heads = 16, 257, 512, 8
    dt = torch.bfloat16
    lengths = torch.randint(1, n + 1, (b,), device=cuda_device)
    mask = torch.arange(n, device=cuda_device)[None] < lengths[:, None]
    hd = heads * 64
    args = [torch.randn(b, n, dim, device=cuda_device).to(dt),
            (1 + 0.1 * torch.randn(dim, device=cuda_device)).to(dt),
            (torch.randn(dim, 3 * hd, device=cuda_device) / dim ** 0.5).to(dt),
            (torch.randn(hd, dim, device=cuda_device) / hd ** 0.5).to(dt),
            (1 + 0.1 * torch.randn(dim, device=cuda_device)).to(dt), mask]
    static = (heads, 64, 64 ** -0.5, False, True)
    monkeypatch.setattr(
        mega, "CHUNK_BYTES",
        mega._build.library().xclip_attention_block_bwd_recompute_workspace(
            mega.dtype_code(dt), 6, n, dim, heads, 64, int(keep_qkv)))
    assert len(mega.bwd_recompute_spans(b, n, dim, heads, dt, keep_qkv)) == 3
    got = mega.attention_block_fwd_stats(*args, *static, keep_qkv)
    want = mega.attention_block_fwd_stats_plain(*args, *static, keep_qkv)
    names = ("out", "sm", "ln_stats", "qkv")[:3 + keep_qkv]
    _assert_all_close(got[:len(names)], want[:len(names)], "bfloat16", names)
    do = torch.randn_like(got[0])
    _, sm, ln_stats, qkv = want
    run = [mega.attention_block_bwd_recompute(
        *args, do, sm, ln_stats, *static, qkv=qkv) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*run))
    _assert_all_close(
        run[0], mega.attention_block_bwd_recompute_plain(
            *args, do, sm, ln_stats, *static, qkv=qkv),
        "bfloat16", ("dx", "dg_pre", "dw_qkv", "dw_out", "dg_out"))


def _lse_inputs(R, C, d, device):
    """l2-normed rows at a CLIP temperature's scale (|x·y| <= 14)."""
    g = torch.Generator(device=device).manual_seed(R + 7 * C + d)
    x = torch.randn(R, d, generator=g, device=device)
    y = torch.randn(C, d, generator=g, device=device)
    x = 14 * x / x.norm(dim=-1, keepdim=True)
    return x, y / y.norm(dim=-1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,d", [(37, 300, 64), (300, 37, 128),
                                   (2048, 2048, 512), (7, 13, 1100),
                                   (129, 257, 1100), (1000, 3000, 100)])
@pytest.mark.parametrize("decoupled,row_offset", [(False, 0), (True, 0),
                                                  (True, 5)])
def test_streaming_lse_kernels_match_plain(cuda_device, R, C, d, decoupled,
                                           row_offset):
    x, y = _lse_inputs(R, C, d, cuda_device)
    counts = (lse5.streaming_lse_fwd.launches,
              lse5.streaming_lse_bwd.launches)
    lse = lse5.streaming_lse_fwd(x, y, row_offset, decoupled)
    want = lse5.streaming_lse_fwd_plain(x, y, row_offset, decoupled)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-4)
    dlse = torch.randn(R, device=cuda_device)
    got = lse5.streaming_lse_bwd(x, y, want, dlse, row_offset, decoupled)
    _assert_all_close(got, lse5.streaming_lse_bwd_plain(
        x, y, want, dlse, row_offset, decoupled), "float32", ("dx", "dy"))
    again = lse5.streaming_lse_bwd(x, y, want, dlse, row_offset, decoupled)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert (lse5.streaming_lse_fwd.launches,
            lse5.streaming_lse_bwd.launches) == (counts[0] + 1,
                                                 counts[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,d,row_offset,decoupled", [
    (2048, 2048, 512, 0, True), (130, 1, 1, 0, True),
    (130, 4099, 1100, 7, True), (130, 4099, 1, 3, False),
    (130, 1, 1100, 0, False)])
@pytest.mark.parametrize("span", [None, 3 * lse5.TILE])
def test_streaming_lse_forward_ranges(cuda_device, monkeypatch, R, C, d,
                                      row_offset, decoupled, span):
    """K5's forward (the ranged product and the merge) within 1e-4 of its
    plain version, with the plan's ranges and with ranges of three tiles
    (the running (m, l) carried across tiles), at the b = 2048 step's
    shape and at odd ones (C = 1 with DCL: row 0's only column masked);
    two launches bit for bit equal."""
    if span is not None:
        monkeypatch.setattr(lse5, "fwd_plan", lambda R, C: span)
    x, y = _lse_inputs(R, C, d, cuda_device)
    got = lse5.streaming_lse_fwd(x, y, row_offset, decoupled)
    want = lse5.streaming_lse_fwd_plain(x, y, row_offset, decoupled)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert torch.equal(got, lse5.streaming_lse_fwd(x, y, row_offset,
                                                   decoupled))


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 0), (0, 3), (2, 2)])
def test_streaming_lse_takes_unaligned_views(cuda_device, offsets):
    """x and y that start off a 16-byte boundary (contiguous views `offsets`
    floats into a buffer) take K5's element loads: the forward and the
    backward give the bits of the same values aligned."""
    x, y = _lse_inputs(300, 1000, 96, cuda_device)

    def view(t, offset):
        v = torch.empty(offset + t.numel(), device=cuda_device)[offset:]
        return v.view_as(t).copy_(t)

    xv, yv = view(x, offsets[0]), view(y, offsets[1])
    lse = lse5.streaming_lse_fwd(x, y, 5, True)
    assert torch.equal(lse5.streaming_lse_fwd(xv, yv, 5, True), lse)
    dlse = torch.randn(300, device=cuda_device)
    got = lse5.streaming_lse_bwd(xv, yv, lse, dlse, 5, True)
    want = lse5.streaming_lse_bwd(x, y, lse, dlse, 5, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# (parts, width) of the ordered sums' tests: every pair of these counts
# and widths whose partials stay within 1 GiB
SUM_PARTS = (1, 2, 12, 15, 384, 1028, 4097)
SUM_WIDTHS = (1, 7, 500, 512, 2048, 2_097_152)
SUM_SHAPES = [(p, n) for p in SUM_PARTS for n in SUM_WIDTHS
              if p * n <= 1 << 28]


def _sum_case(parts, n, acc, device, part_offset=0, out_offset=0):
    """(got, want) of rows.reduce_parts on seeded partials at `acc` (0: a
    bf16 sum, 1: fp32, 2: added to a running fp32 sum), the partials and
    the running sum optionally views `*_offset` floats into a buffer (not
    16-byte aligned); want: matmul.ordered_sum, the strict order, on the
    card."""
    g = torch.Generator(device=device).manual_seed(parts + 3 * n + acc)
    buf = torch.randn(part_offset + parts * n, generator=g, device=device)
    part = buf[part_offset:].view(parts, n)
    if acc == 2:
        run = torch.randn(out_offset + n, generator=g, device=device)
        out = run[out_offset:]
        want = out.clone()
        for p in part:
            want += p
        return rows_mod.reduce_parts(part, out), want
    dtype = torch.bfloat16 if acc == 0 else torch.float32
    return (rows_mod.reduce_parts(part, dtype=dtype),
            matmul.ordered_sum(part).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("parts,n", SUM_SHAPES)
@pytest.mark.parametrize("acc", [0, 1, 2])
def test_reduce_parts_is_the_strict_ordered_sum(cuda_device, parts, n, acc):
    """The ordered sums' kernels (the slab kernel up to 67,584 columns, the
    wide one from there) bit for bit equal to the strict left-to-right
    sum, at parts counts from 1 to past any ring depth and widths on and
    off every slab and vector grid."""
    got, want = _sum_case(parts, n, acc, cuda_device)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [500, 2048, 2_097_152])
@pytest.mark.parametrize("acc", [0, 1, 2])
def test_reduce_parts_takes_unaligned_views(cuda_device, n, acc):
    """Partials and a running sum that start off a 16-byte boundary take
    the element walk of the same kernels: the same bits."""
    for offsets in ((1, 0), (0, 1), (3, 3)):
        got, want = _sum_case(12, n, acc, cuda_device, *offsets)
        assert torch.equal(got, want), offsets


@pytest.mark.cuda
def test_reduce_parts_counts_launches_by_regime(cuda_device):
    """The library counts each ordered sum by (regime, width), from every
    caller: the dg widths go to the slab kernel, the split-k widths wide."""
    rows_mod.sum_launches(reset=True)
    for parts, n in ((384, 2048), (384, 2048), (12, 512 * 4096)):
        rows_mod.reduce_parts(torch.zeros(parts, n, device=cuda_device))
    assert rows_mod.sum_launches(reset=True) == {("slab", 2048): 2,
                                                 ("wide", 512 * 4096): 1}
    assert rows_mod.sum_launches() == {}


@pytest.mark.cuda
@pytest.mark.parametrize("decoupled,row_offset", [(False, 0), (True, 40)])
def test_streaming_lse_backward_in_chunks_of_columns(cuda_device, monkeypatch,
                                                      decoupled, row_offset):
    """K5's backward with its scores scratch cut to a few columns at a
    time: chunks of 128 columns (the last one short), dx summed across
    them, each chunk's dy rows its own; against the plain version, and
    two runs bit for bit equal."""
    monkeypatch.setattr(lse5, "P_BYTES", 300 * 128 * 4)
    x, y = _lse_inputs(300, 1000, 96, cuda_device)
    assert lse5.bwd_plan(300, 1000, 96)[0] == 128
    lse = lse5.streaming_lse_fwd_plain(x, y, row_offset, decoupled)
    dlse = torch.randn(300, device=cuda_device)
    got = lse5.streaming_lse_bwd(x, y, lse, dlse, row_offset, decoupled)
    _assert_all_close(got, lse5.streaming_lse_bwd_plain(
        x, y, lse, dlse, row_offset, decoupled), "float32", ("dx", "dy"))
    again = lse5.streaming_lse_bwd(x, y, lse, dlse, row_offset, decoupled)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_lean_backwards_are_deterministic(cuda_device):
    """No float atomics: two runs of each memory-lean backward agree bit
    for bit (K5's in the test above)."""
    args = to_torch(mega_args(n=70, dim=128, heads=2, mask_kind="keypad"),
                    torch.bfloat16, cuda_device)
    for keep in (False, True):
        out, sm, ln_stats, qkv = mega.attention_block_fwd_stats(
            *args, 2, 64, 0.125, keep_qkv=keep)
        do = torch.randn(*out.shape, device=cuda_device).to(out.dtype)
        a, b = (mega.attention_block_bwd_recompute(
            *args, do, sm, ln_stats, 2, 64, 0.125, qkv=qkv) for _ in range(2))
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    fargs = to_torch(ff_args(R=4000, D=128, I=256), torch.bfloat16,
                     cuda_device)
    _, stats = ffb.ff_block_fwd_stats(*fargs)
    do = torch.randn(4000, 128, device=cuda_device).to(torch.bfloat16)
    a, b = (ffb.ff_block_bwd_recompute(*fargs, do, stats) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------ rotary text tower: K6 and K7

def _assert_elementwise(got, want, dtype, names):
    """K6, K7 and the megablock's core element by element: fp32 outputs
    and every fp32 statistic (lse; the megablock's m and l) within 1e-4 of
    the tensor's largest magnitude; bf16
    outputs within two bf16 ulps of the element plus 3e-2 of the RMS of
    its head row (64 features) plus 1e-2 of the tensor's RMS (a flipped
    bf16 rounding of a p or ds term moves a sum by up to 2^-7 of that
    term, as large as the row where few keys are valid); every output
    within 1e-3 relative Frobenius error."""
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype, name
        assert torch.isfinite(g.float()).all(), name
        fp32 = w.dtype == torch.float32
        w = w.float()
        if dtype == "float32" or fp32:
            tol = 1e-4 * max(1.0, float(w.abs().max()))
        else:
            rows = w.reshape(-1, 64)
            ulp = torch.exp2(torch.floor(torch.log2(
                rows.abs().clamp_min(2.0 ** -126))) - 7)
            tol = (2 * ulp + 3e-2 * rows.pow(2).mean(-1, keepdim=True).sqrt()
                   + 1e-2 * w.pow(2).mean().sqrt()).reshape(w.shape)
        err = (g.float() - w).abs()
        assert (err <= tol).all(), (
            f"{name}: worst err/tol {(err / tol).max().item():.3f}")
        assert err.norm() <= 1e-3 * w.norm(), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "keypad", "dead", "holes"])
@pytest.mark.parametrize("n,heads", [(33, 2), (257, 8), (256, 8), (1024, 2),
                                     (1621, 1), (2048, 1)])
def test_attention_core_kernels_match_plain(cuda_device, dtype, causal,
                                            mask_kind, n, heads):
    """K6's kernels against their plain versions, in both dtypes up to
    their 2048 keys (no kernel keeps a score row whole); 1,621 ends in a
    ragged query and key tile."""
    qkv, mask, do = to_torch(core_args(n=n, heads=heads, mask_kind=mask_kind),
                             getattr(torch, dtype), cuda_device)
    static = (heads, 64, 0.125, causal, mask_kind != "none")
    counts = (core.attention_core_fwd.launches,
              core.attention_core_bwd.launches)
    got = core.attention_core_fwd(qkv, mask, *static)
    want = core.attention_core_fwd_plain(qkv, mask, *static)
    _assert_elementwise(got, want, dtype, ("out", "lse"))
    out, lse = want
    _assert_elementwise(
        (core.attention_core_bwd(qkv, mask, out, lse, do, *static),),
        (core.attention_core_bwd_plain(qkv, mask, out, lse, do, *static),),
        dtype, ("dqkv",))
    assert (core.attention_core_fwd.launches,
            core.attention_core_bwd.launches) == (counts[0] + 1,
                                                 counts[1] + 1)


def _nan_blocks(*specs):
    """Allocate NaN-filled tensors of the given (shape, dtype)s and free
    them: the caching allocator hands their blocks to the next tensors of
    those sizes, so an element a kernel leaves unwritten reads NaN."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    blocks = [torch.full(shape, float("nan"), dtype=dtype, device="cuda")
              for shape, dtype in specs]
    torch.cuda.synchronize()
    del blocks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["holes", "dead"])
def test_attention_core_writes_every_element(cuda_device, dtype, causal,
                                             mask_kind):
    """K6 skips causal and all-masked tiles (the fp32 backward too, and its
    ragged last tile's empty column groups), yet writes every element of
    out, lse and dqkv (the wrapper takes them from torch.empty), and the
    backward agrees with its plain version."""
    qkv, mask, do = to_torch(core_args(n=257, heads=8, mask_kind=mask_kind),
                             dtype, cuda_device)
    static = (8, 64, 0.125, causal, True)
    b, n, _ = qkv.shape
    _nan_blocks(((b, n, 512), dtype), ((b, n, 8), torch.float32))
    out, lse = core.attention_core_fwd(qkv, mask, *static)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _nan_blocks((tuple(qkv.shape), dtype), ((b, n, 8), torch.float32))
    dqkv = core.attention_core_bwd(qkv, mask, out, lse, do, *static)
    torch.cuda.synchronize()
    assert torch.isfinite(dqkv).all()
    _assert_elementwise(
        (dqkv,), (core.attention_core_bwd_plain(qkv, mask, out, lse, do,
                                                *static),),
        str(dtype).split(".")[-1], ("dqkv",))


@pytest.mark.cuda
def test_attention_core_raises_above_max_seq_len(cuda_device):
    """No fallback: a length the kernel does not take raises. fp32 takes
    the one limit of the mask words, 2048, forward and backward, for
    inference and training, and raises one past it."""
    n = mega.max_seq_len(torch.bfloat16) + 1
    qkv = torch.zeros(1, n, 3 * 128, dtype=torch.bfloat16, device=cuda_device)
    mask = torch.ones(1, n, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="exceeds"):
        core.attention_core(qkv, mask, 2, 64, 0.125)
    n = mega.max_seq_len_bwd(torch.bfloat16) + 1
    qkv = torch.zeros(1, n, 3 * 128, dtype=torch.bfloat16, device=cuda_device,
                      requires_grad=True)
    mask = torch.ones(1, n, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="exceeds"):
        core.attention_core(qkv, mask, 2, 64, 0.125)
    f32 = torch.float32
    assert mega.max_seq_len(f32) == mega.max_seq_len_bwd(f32) == 2048
    assert mega.seq_len_limit(f32) == mega.seq_len_limit(f32, True) == 2048
    for grad in (False, True):
        qkv = torch.zeros(1, 2049, 3 * 128, device=cuda_device,
                          requires_grad=grad)
        mask = torch.ones(1, 2049, dtype=torch.bool, device=cuda_device)
        with pytest.raises(ValueError, match="exceeds"):
            core.attention_core(qkv, mask, 2, 64, 0.125)
    n = mega.max_seq_len(f32)
    qkv = torch.randn(1, n, 3 * 128, device=cuda_device, requires_grad=True)
    mask = torch.ones(1, n, dtype=torch.bool, device=cuda_device)
    core.attention_core(qkv, mask, 2, 64, 0.125, True).sum().backward()
    assert torch.isfinite(qkv.grad).all()


def _flash_padded(args, dtype, device):
    """The (b·h, n_pad, 64) tensors and mask `flash_attention` hands the
    core."""
    q, k, v, mask, do = to_torch(args, dtype, device)
    (q, k, v, do), mask = flash.pad_flat((q, k, v, do), mask)
    return q, k, v, mask, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "keypad", "dead", "holes"])
@pytest.mark.parametrize("n", [32, 37, 64, 200, 256])
def test_flash_attention_kernels_match_plain(cuda_device, dtype, causal,
                                             mask_kind, n):
    q, k, v, mask, do = _flash_padded(flash_args(n=n, mask_kind=mask_kind),
                                      getattr(torch, dtype), cuda_device)
    counts = (flash.flash_attention_fwd.launches,
              flash.flash_attention_bwd.launches)
    got = flash.flash_attention_fwd(q, k, v, mask, causal)
    want = flash.flash_attention_fwd_plain(q, k, v, mask, causal)
    _assert_elementwise(got, want, dtype, ("out", "lse"))
    out, lse = want
    if mask_kind == "dead":   # a dead row gives 0 and log 1e-30
        assert not got[0][-2:].float().abs().any()
        torch.testing.assert_close(got[1][-2:], torch.full_like(
            got[1][-2:], math.log(1e-30)))
    _assert_elementwise(
        flash.flash_attention_bwd(q, k, v, mask, out, lse, do, causal),
        flash.flash_attention_bwd_plain(q, k, v, mask, out, lse, do, causal),
        dtype, ("dq", "dk", "dv"))
    assert (flash.flash_attention_fwd.launches,
            flash.flash_attention_bwd.launches) == (counts[0] + 1,
                                                   counts[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "keypad", "dead", "holes"])
@pytest.mark.parametrize("n", [37, 200, 256, 2048])
def test_flash_attention_kernels_at_head_width_128(cuda_device, causal,
                                                   mask_kind, n, dtype):
    """K7 on heads of 128, two 64-column halves (bf16: the mma.sync
    kernels; fp32: the core's K7 mode), against the plain versions
    (phase 12's element rule), up to 2048 keys."""
    q, k, v, mask, do = _flash_padded(
        flash_args(n=n, mask_kind=mask_kind, d=128), getattr(torch, dtype),
        cuda_device)
    got = flash.flash_attention_fwd(q, k, v, mask, causal)
    want = flash.flash_attention_fwd_plain(q, k, v, mask, causal)
    _assert_elementwise(got, want, dtype, ("out", "lse"))
    _assert_elementwise(
        flash.flash_attention_bwd(q, k, v, mask, *want, do, causal),
        flash.flash_attention_bwd_plain(q, k, v, mask, *want, do, causal),
        dtype, ("dq", "dk", "dv"))


@pytest.mark.cuda
def test_flash_attention_raises_past_its_head_widths(cuda_device):
    """K7 takes heads of 64 and 128 in both dtypes; `flash_attention` pads
    a narrower head to one of those and raises past the widest."""
    for dtype, d in ((torch.float32, 160), (torch.bfloat16, 256)):
        q = torch.zeros(1, 1, 64, d, dtype=dtype, device=cuda_device)
        with pytest.raises(ValueError, match=f"not {d}"):
            flash.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 64), ("bfloat16", 128),
                                     ("float32", 64), ("float32", 128)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["holes", "dead"])
def test_flash_attention_writes_every_element(cuda_device, causal,
                                              mask_kind, dtype, d):
    """K7 skips causal and all-masked key tiles (bf16 also zero-fills a
    key tile with no valid key), yet writes every element of out, lse, dq,
    dk and dv (the wrapper takes them from torch.empty)."""
    dtype = getattr(torch, dtype)
    q, k, v, mask, do = _flash_padded(
        flash_args(b=3, h=2, n=256, mask_kind=mask_kind, d=d), dtype,
        cuda_device)
    _nan_blocks((tuple(q.shape), dtype), (tuple(mask.shape), torch.float32))
    out, lse = flash.flash_attention_fwd(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _nan_blocks(*[(tuple(q.shape), dtype)] * 3,
                (tuple(mask.shape), torch.float32))
    grads = flash.flash_attention_bwd(q, k, v, mask, out, lse, do, causal)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_long_sequence(cuda_device, dtype):
    """(2, 8, 2048, 64) causal with key pads: no length limit."""
    q, k, v, mask, do = _flash_padded(
        flash_args(b=2, h=8, n=2000, mask_kind="keypad"),
        getattr(torch, dtype), cuda_device)
    got = flash.flash_attention_fwd(q, k, v, mask, True)
    want = flash.flash_attention_fwd_plain(q, k, v, mask, True)
    _assert_elementwise(got, want, dtype, ("out", "lse"))
    _assert_elementwise(
        flash.flash_attention_bwd(q, k, v, mask, *want, do, True),
        flash.flash_attention_bwd_plain(q, k, v, mask, *want, do, True),
        dtype, ("dq", "dk", "dv"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_at_8192(cuda_device, dtype):
    """(2, 8, 8192, 64) causal with key pads, against the plain forward
    and backward: 128 tiles a row, no length limit (fp32: past the core's
    other modes' 2048, every element written into NaN-filled memory)."""
    q, k, v, mask, do = _flash_padded(
        flash_args(b=2, h=8, n=8192, mask_kind="keypad"),
        getattr(torch, dtype), cuda_device)
    _nan_blocks((tuple(q.shape), q.dtype), (tuple(mask.shape), torch.float32))
    got = flash.flash_attention_fwd(q, k, v, mask, True)
    want = flash.flash_attention_fwd_plain(q, k, v, mask, True)
    _assert_elementwise(got, want, dtype, ("out", "lse"))
    _assert_elementwise(
        flash.flash_attention_bwd(q, k, v, mask, *want, do, True),
        flash.flash_attention_bwd_plain(q, k, v, mask, *want, do, True),
        dtype, ("dq", "dk", "dv"))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["holes", "dead"])
def test_flash_attention_f32_forward_past_2048(cuda_device, causal,
                                               mask_kind):
    """fp32 K7's forward runs the attention core's tiled forward in its K7
    mode (no mask word a tile kept in shared memory, no dead-row rule): at
    n = 2304, past the core's other modes' 2048, with whole masked key
    tiles and a dead row, it writes every element of out and lse
    (launched into NaN-filled memory), two launches agree bit for bit, it
    matches its plain version element by element, a dead row gives out 0
    and lse log 1e-30, and the backward fed its out and lse matches the
    plain backward on them."""
    q, k, v, mask, do = _flash_padded(
        flash_args(b=3, h=2, n=2304, mask_kind=mask_kind), torch.float32,
        cuda_device)
    before = flash.flash_attention_fwd.launches
    _nan_blocks((tuple(q.shape), torch.float32),
                (tuple(mask.shape), torch.float32))
    got = flash.flash_attention_fwd(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in got)
    again = flash.flash_attention_fwd(q, k, v, mask, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert flash.flash_attention_fwd.launches == before + 2
    _assert_elementwise(got, flash.flash_attention_fwd_plain(
        q, k, v, mask, causal), "float32", ("out", "lse"))
    if mask_kind == "dead":   # the last element's two heads
        assert not got[0][-2:].abs().any()
        torch.testing.assert_close(got[1][-2:], torch.full_like(
            got[1][-2:], math.log(1e-30)))
    _assert_elementwise(
        flash.flash_attention_bwd(q, k, v, mask, *got, do, causal),
        flash.flash_attention_bwd_plain(q, k, v, mask, *got, do, causal),
        "float32", ("dq", "dk", "dv"))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["holes", "dead"])
def test_flash_attention_f32_backward_past_2048(cuda_device, causal,
                                                mask_kind):
    """fp32 K7's backward runs the attention core's tiled kernels in their
    K7 mode, which keep no mask word a tile in shared memory: at n = 2304,
    past the core's 2048, with whole masked key tiles and a dead row, it
    writes every element of dq, dk and dv (launched into NaN-filled
    memory), two launches agree bit for bit, and it matches its plain
    version element by element."""
    q, k, v, mask, do = _flash_padded(
        flash_args(b=3, h=2, n=2304, mask_kind=mask_kind), torch.float32,
        cuda_device)
    out, lse = flash.flash_attention_fwd_plain(q, k, v, mask, causal)
    before = flash.flash_attention_bwd.launches
    _nan_blocks(*[(tuple(q.shape), torch.float32)] * 3,
                (tuple(mask.shape), torch.float32))
    got = flash.flash_attention_bwd(q, k, v, mask, out, lse, do, causal)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g).all() for g in got)
    again = flash.flash_attention_bwd(q, k, v, mask, out, lse, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert flash.flash_attention_bwd.launches == before + 2
    _assert_elementwise(
        got, flash.flash_attention_bwd_plain(q, k, v, mask, out, lse, do,
                                             causal),
        "float32", ("dq", "dk", "dv"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_more_than_65535_heads(cuda_device, dtype):
    """b·h = 70,000 (b 8,750 at 8 heads): b·h is the grid's x axis (bf16)
    or a factor of its 1-D grid (fp32), so the batch has no 65,535
    limit."""
    torch.manual_seed(2)
    bh, n = 70000, 64
    q, k, v, do = (torch.randn(bh, n, 64, device=cuda_device)
                   .to(getattr(torch, dtype)) for _ in range(4))
    mask = torch.arange(n, device=cuda_device)[None] < torch.randint(
        1, n + 1, (bh, 1), device=cuda_device)
    got = flash.flash_attention_fwd(q, k, v, mask, True)
    want = flash.flash_attention_fwd_plain(q, k, v, mask, True)
    _assert_elementwise(got, want, dtype, ("out", "lse"))
    _assert_elementwise(
        flash.flash_attention_bwd(q, k, v, mask, *want, do, True),
        flash.flash_attention_bwd_plain(q, k, v, mask, *want, do, True),
        dtype, ("dq", "dk", "dv"))


@pytest.mark.cuda
def test_attention_cores_are_deterministic(cuda_device):
    """No float atomics: two backward runs of K6 in bf16 and fp32 (also at
    (4, 256, 8 heads) causal with whole masked key tiles), of the
    megablock's fp32 core (dead rows) and of K7 (also at (4, 2, 256) causal
    with whole masked key tiles and a dead row, bf16) agree bit for bit."""
    for dtype in (torch.bfloat16, torch.float32):
        for kwargs in (dict(n=70, heads=2),
                       dict(b=4, n=256, heads=8, mask_kind="holes")):
            qkv, mask, do = to_torch(core_args(**kwargs), dtype, cuda_device)
            static = (kwargs["heads"], 64, 0.125, True)
            out, lse = core.attention_core_fwd(qkv, mask, *static)
            a, b = (core.attention_core_bwd(qkv, mask, out, lse, do, *static)
                    for _ in range(2))
            assert torch.equal(a, b), (dtype, kwargs)
    # the megablock's fp32 core (its own scale order), dead rows
    qkv, mask, dattn = to_torch(core_args(b=4, n=257, heads=8,
                                          mask_kind="dead"), torch.float32,
                                cuda_device)
    static = (8, 64, 0.125, False, True)
    fwd = mega.mega_core_fwd(qkv, mask, *static)
    a, b = (mega.mega_core_bwd(qkv, mask, dattn, *fwd, *static)
            for _ in range(2))
    assert torch.equal(a, b)
    holes = flash_args(b=4, n=256, mask_kind="holes")
    holes[3][-1] = False   # a dead row
    for args in (flash_args(n=200), holes):
        q, k, v, mask, do = _flash_padded(args, torch.bfloat16, cuda_device)
        out, lse = flash.flash_attention_fwd(q, k, v, mask, True)
        a, b = (flash.flash_attention_bwd(q, k, v, mask, out, lse, do, True)
                for _ in range(2))
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------ the megablock's attention core on the mma.sync kernels

def _flagship_mega(device, kind, seed, b=256, n=257, dim=512, heads=8):
    """Megablock inputs at the flagship text shape, bf16: "full" every key
    valid, "keypad" caption lengths uniform in 5..n (`chip_smoke.texts`
    with CLS), "dead" as "keypad" with the last element all pads."""
    g = torch.Generator(device=device).manual_seed(seed)
    dt, hd = torch.bfloat16, heads * 64

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=device) * scale
                ).to(dt)

    lengths = (torch.full((b,), n, device=device) if kind == "full" else
               torch.randint(5, n + 1, (b,), generator=g, device=device))
    mask = torch.arange(n, device=device)[None] < lengths[:, None]
    if kind == "dead":
        mask[-1] = False
    return [randn(b, n, dim), 1 + randn(dim, scale=0.1),
            randn(dim, 3 * hd, scale=dim ** -0.5),
            randn(hd, dim, scale=hd ** -0.5), 1 + randn(dim, scale=0.1),
            mask]


MEGA_FLAGSHIP_CASES = [  # (mask kind, causal, scale)
    ("full", False, 64 ** -0.5), ("keypad", False, 64 ** -0.5),
    ("keypad", False, 0.1), ("dead", False, 64 ** -0.5),
    ("dead", True, 0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,causal,scale", MEGA_FLAGSHIP_CASES)
def test_megablock_variants_at_the_flagship_shape(cuda_device, kind, causal,
                                                  scale):
    """(256, 257, 512, 8 x 64), bf16, full-length and padded captions,
    dead rows, causal, scale 0.1: K-MEGA, K2 forward and backward, K3
    (stats and qkv) forward and recompute backward against their plain
    versions (two bf16 ulps of each tensor's largest magnitude), and the
    attention core alone element by element (as K6)."""
    args = _flagship_mega(cuda_device, kind, seed=5)
    static = (8, 64, scale, causal, True)
    b, n, dim = args[0].shape
    with torch.no_grad():
        _assert_all_close((mega.attention_block(*args, *static),),
                          (mega.attention_block_plain(*args, *static),),
                          "bfloat16", ("out",))
    out, stored = mega.attention_block_fwd_stored(*args, *static)
    want_out, want_stored = mega.attention_block_fwd_stored_plain(*args,
                                                                  *static)
    _assert_all_close((out, *stored), (want_out, *want_stored), "bfloat16",
                      ("out", "qkv", "attnout", "proj", "sm", "ln_stats"))
    do = torch.randn_like(out)
    _assert_all_close(
        mega.attention_block_bwd(*args, do, want_stored, *static),
        mega.attention_block_bwd_plain(*args, do, want_stored, *static),
        "bfloat16", ("dx", "dg_pre", "dw_qkv", "dw_out", "dg_out", "dqkv"))
    del out, stored
    for keep in (False, True):
        got = mega.attention_block_fwd_stats(*args, *static, keep)
        want = mega.attention_block_fwd_stats_plain(*args, *static, keep)
        names = ("out", "sm", "ln_stats", "qkv")[:3 + keep]
        _assert_all_close(got[:len(names)], want[:len(names)], "bfloat16",
                          names)
        _, sm, ln_stats, qkv = want
        _assert_all_close(
            mega.attention_block_bwd_recompute(*args, do, sm, ln_stats,
                                               *static, qkv=qkv),
            mega.attention_block_bwd_recompute_plain(
                *args, do, sm, ln_stats, *static, qkv=qkv),
            "bfloat16", ("dx", "dg_pre", "dw_qkv", "dw_out", "dg_out"))
    qkv = want_stored[0].reshape(b, n, -1)
    counts = (mega.mega_core_fwd.launches, mega.mega_core_bwd.launches)
    got = mega.mega_core_fwd(qkv, args[5], *static)
    want = mega.mega_core_fwd_plain(qkv, args[5], *static)
    _assert_elementwise(got, want, "bfloat16", ("attnout", "sm"))
    dattn = torch.randn(b, n, 512, device=cuda_device)
    _assert_elementwise(
        (mega.mega_core_bwd(qkv, args[5], dattn, *want, *static),),
        (mega.mega_core_bwd_plain(qkv, args[5], dattn, *want, *static),),
        "bfloat16", ("dqkv",))
    assert (mega.mega_core_fwd.launches,
            mega.mega_core_bwd.launches) == (counts[0] + 1, counts[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["holes", "dead"])
def test_megablock_writes_every_element(cuda_device, causal, mask_kind):
    """bf16 K2, K3 and the core alone run the attention on kernels that
    skip tiles, yet write every element of their outputs, residuals and
    gradients (the wrappers take them from torch.empty)."""
    b, n, dim, heads = 8, 257, 512, 8
    rows, hd, dt, f32 = b * n, heads * 64, torch.bfloat16, torch.float32
    args = to_torch(mega_args(b=b, n=n, dim=dim, heads=heads), dt,
                    cuda_device)
    args[5] = torch.from_numpy(_key_mask(b, n, mask_kind)).to(cuda_device)
    static = (heads, 64, 0.1, causal, True)
    _nan_blocks(((b, n, dim), dt), ((rows, dim), dt), ((rows, 3 * hd), dt),
                ((rows, hd), dt), ((rows, dim), f32), ((rows, 2 * heads), f32),
                ((4, rows), f32))
    out, stored = mega.attention_block_fwd_stored(*args, *static)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in (out, *stored))
    _nan_blocks(((b, n, dim), dt), ((rows, 3 * hd), dt))
    grads = mega.attention_block_bwd(*args, torch.randn_like(out), stored,
                                     *static)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in grads)
    for keep in (False, True):
        _nan_blocks(((b, n, dim), dt), ((rows, 2 * heads), f32),
                    ((4, rows), f32), ((rows, 3 * hd), dt))
        got = mega.attention_block_fwd_stats(*args, *static, keep)
        torch.cuda.synchronize()
        assert all(torch.isfinite(t).all() for t in got if t is not None)
        _nan_blocks(((b, n, dim), dt))
        grads = mega.attention_block_bwd_recompute(
            *args, torch.randn_like(out), got[1], got[2], *static,
            qkv=got[3])
        torch.cuda.synchronize()
        assert all(torch.isfinite(t).all() for t in grads)
    qkv = stored[0].reshape(b, n, 3 * hd)
    _nan_blocks(((b, n, hd), dt), ((b, n, 2 * heads), f32))
    attnout, sm = mega.mega_core_fwd(qkv, args[5], *static)
    torch.cuda.synchronize()
    assert torch.isfinite(attnout).all() and torch.isfinite(sm).all()
    _nan_blocks(((b, n, 3 * hd), dt), ((b, n, heads), f32),
                ((b, n, 2 * hd), dt))
    dqkv = mega.mega_core_bwd(qkv, args[5], torch.randn(b, n, hd,
                                                        device=cuda_device),
                              attnout, sm, *static)
    torch.cuda.synchronize()
    assert torch.isfinite(dqkv).all()


# (core, mask kind, b, n, causal, scale): full tiles and ragged tails of
# the warp, chunk and slice cuts at the text tower's 257, the vision
# tower's 32 and lengths around five tiles; "full" every key valid, "pads"
# caption lengths uniform in 1..n
CORE_PATH_CASES = [
    ("mega", "full", 256, 257, False, 64 ** -0.5),
    ("mega", "pads", 16, 320, False, 64 ** -0.5),
    ("mega", "pads", 16, 321, False, 64 ** -0.5),
    ("mega", "full", 64, 32, False, 64 ** -0.5),
    ("mega", "pads", 16, 65, False, 64 ** -0.5),
    ("mega", "dead", 8, 257, True, 0.1),
    ("mega", "dead", 8, 320, True, 0.1),
    ("mega", "dead", 8, 321, True, 0.1),
    ("k6", "pads", 256, 256, True, 0.125),
    ("k6", "dead", 8, 321, True, 0.125),
]


@pytest.mark.cuda
@pytest.mark.parametrize("which,kind,b,n,causal,scale", CORE_PATH_CASES)
def test_attention_core_cuts(cuda_device, which, kind, b, n, causal, scale):
    """bf16, 8 heads: the megablock's core and K6 with full tiles, ragged
    tails (n = 32, 65, 257, 320, 321), dead rows, causal and scale 0.1,
    forward and backward element by element against the plain versions
    (phase 12's rule), and two launches of each bit for bit equal."""
    dt = torch.bfloat16
    g = torch.Generator(device=cuda_device).manual_seed(n)
    qkv = torch.randn(b, n, 3 * 512, generator=g, device=cuda_device).to(dt)
    if kind == "pads":
        lengths = torch.randint(1, n + 1, (b, 1), generator=g,
                                device=cuda_device)
        mask = torch.arange(n, device=cuda_device)[None] < lengths
    else:
        mask = torch.from_numpy(_key_mask(b, n, "dead" if kind == "dead"
                                          else "none")).to(cuda_device)
    static = (8, 64, scale, causal, True)
    if which == "mega":
        fwd, bwd = mega.mega_core_fwd, mega.mega_core_bwd
        fwd_plain = mega.mega_core_fwd_plain
        bwd_plain = mega.mega_core_bwd_plain
        names = ("attnout", "sm")
        cot = torch.randn(b, n, 512, generator=g, device=cuda_device)
    else:
        fwd, bwd = core.attention_core_fwd, core.attention_core_bwd
        fwd_plain = core.attention_core_fwd_plain
        bwd_plain = core.attention_core_bwd_plain
        names = ("out", "lse")
        cot = torch.randn(b, n, 512, generator=g, device=cuda_device).to(dt)
    got = fwd(qkv, mask, *static)
    assert all(torch.equal(x, y) for x, y in zip(got, fwd(qkv, mask,
                                                          *static)))
    want = fwd_plain(qkv, mask, *static)
    _assert_elementwise(got, want, "bfloat16", names)
    if which == "mega":
        grads = [bwd(qkv, mask, cot, *want, *static) for _ in range(2)]
        plain = bwd_plain(qkv, mask, cot, *want, *static)
    else:
        grads = [bwd(qkv, mask, *want, cot, *static) for _ in range(2)]
        plain = bwd_plain(qkv, mask, *want, cot, *static)
    assert torch.equal(grads[0], grads[1])
    _assert_elementwise((grads[0],), (plain,), "bfloat16", ("dqkv",))


@pytest.mark.cuda
def test_megablock_length_limit_is_2048(cuda_device):
    """bf16: the megablock, its core and K6 share the mma.sync kernels'
    limit, 64 x 32 key tiles = 2048 keys. At n = 2048 the core agrees with
    its plain version; at 2049 every wrapper raises (no fallback)."""
    dt = torch.bfloat16
    assert mega.max_seq_len(dt) == mega.max_seq_len_bwd(dt) == 2048
    qkv, mask, _ = to_torch(core_args(b=3, n=2048, heads=2,
                                      mask_kind="holes"), dt, cuda_device)
    static = (2, 64, 0.1, True, True)
    want = mega.mega_core_fwd_plain(qkv, mask, *static)
    _assert_elementwise(mega.mega_core_fwd(qkv, mask, *static), want,
                        "bfloat16", ("attnout", "sm"))
    dattn = torch.randn(3, 2048, 128, device=cuda_device)
    _assert_elementwise(
        (mega.mega_core_bwd(qkv, mask, dattn, *want, *static),),
        (mega.mega_core_bwd_plain(qkv, mask, dattn, *want, *static),),
        "bfloat16", ("dqkv",))
    args = to_torch(mega_args(n=2049, dim=128, heads=2), dt, cuda_device)
    qkv = torch.zeros(2, 2049, 3 * 128, dtype=dt, device=cuda_device)
    calls = [
        lambda: mega.attention_block(*args, 2, 64, 0.125),
        lambda: mega.attention_block_fwd_stats(*args, 2, 64, 0.125),
        lambda: mega.attention_block_train(
            *[t.requires_grad_(True) for t in args[:5]], args[5], 2, 64,
            0.125),
        lambda: mega.mega_core_fwd(qkv, args[5], 2, 64, 0.125),
        lambda: core.attention_core_fwd(qkv, args[5], 2, 64, 0.125)]
    for call in calls:
        with pytest.raises(ValueError, match="exceeds"):
            call()


# ------------------------------------------- K8 (ff_impl='fused'), K1-h


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,inner", [(77, 128), (130, 256), (8192, 2048)])
def test_geglu_layernorm_kernels_match_plain(cuda_device, dtype, rows, inner):
    torch.manual_seed(2)
    dt = getattr(torch, dtype)
    h = torch.randn(rows, 2 * inner, device=cuda_device).to(dt)
    g = (1 + 0.1 * torch.randn(inner, device=cuda_device)).to(dt)
    do = torch.randn(rows, inner, device=cuda_device).to(dt)
    counts = (k8.geglu_layernorm_fwd.launches, k8.geglu_layernorm_bwd.launches)
    _assert_all_close((k8.geglu_layernorm_fwd(h, g),),
                      (k8.geglu_layernorm_plain(h, g),), dtype, ("out",))
    runs = [k8.geglu_layernorm_bwd(h, g, do) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))  # no atomics
    _assert_all_close(runs[0], k8.geglu_layernorm_bwd_plain(h, g, do), dtype,
                      ("dh", "dg"))
    assert (k8.geglu_layernorm_fwd.launches,
            k8.geglu_layernorm_bwd.launches) == (counts[0] + 1, counts[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,inner", [(77, 96), (130, 160), (77, 100),
                                        (66, 7)])
def test_geglu_layernorm_takes_inner_widths_off_64(cuda_device, dtype, rows,
                                                   inner):
    """K8 forward and backward at inner widths that are not multiples of
    64 (96, 160: 16-byte vectors with a short row; 100, 7: element by
    element), as the plain version computes them."""
    torch.manual_seed(3)
    dt = getattr(torch, dtype)
    h = torch.randn(rows, 2 * inner, device=cuda_device).to(dt)
    g = (1 + 0.1 * torch.randn(inner, device=cuda_device)).to(dt)
    do = torch.randn(rows, inner, device=cuda_device).to(dt)
    _assert_all_close((k8.geglu_layernorm_fwd(h, g),),
                      (k8.geglu_layernorm_plain(h, g),), dtype, ("out",))
    runs = [k8.geglu_layernorm_bwd(h, g, do) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    _assert_all_close(runs[0], k8.geglu_layernorm_bwd_plain(h, g, do), dtype,
                      ("dh", "dg"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,dim,inner", [(130, 128, 256), (77, 64, 128),
                                            (8192, 512, 2048)])
def test_ff_block_stored_h_kernels_match_plain(cuda_device, dtype, rows, dim,
                                               inner):
    args = to_torch(ff_args(R=rows, D=dim, I=inner), getattr(torch, dtype),
                    cuda_device)
    counts = (ffb.ff_block_fwd_stored_h.launches,
              ffb.ff_block_bwd_p1_stored_h.launches)
    out, stored = ffb.ff_block_fwd_stored_h(*args)
    want_out, want_stored = ffb.ff_block_fwd_stored_h_plain(*args)
    _assert_all_close((out, *stored), (want_out, *want_stored), dtype,
                      ("out", "h", "stats"))
    do = torch.randn(rows, dim, device=cuda_device).to(args[0].dtype)
    runs = [ffb.ff_block_bwd_p1_stored_h(*args, do, want_stored)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][:4], runs[1][:4]))
    want_p1 = ffb.ff_block_bwd_p1_stored_h_plain(*args, do, want_stored)
    _assert_all_close(runs[0][:4], want_p1[:4], dtype,
                      ("dx", "dprod", "dg_pre", "dg_inner"))
    _assert_all_close(runs[0][4], want_p1[4], dtype, ("xn", "dh2", "y2"))
    _assert_all_close(ffb.ff_block_bwd_p2(*want_p1[4], do),
                      ffb.ff_block_bwd_p2_plain(*want_p1[4], do), dtype,
                      ("dw_in", "dw_out"))
    assert (ffb.ff_block_fwd_stored_h.launches,
            ffb.ff_block_bwd_p1_stored_h.launches) == (counts[0] + 1,
                                                       counts[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("ff_impl,store", [("fused", None),
                                           ("block_stored", "h")])
def test_ff_routes_train_on_the_card_as_on_the_cpu(cuda_device, monkeypatch,
                                                   ff_impl, store):
    """The stack on K8 (ff_impl='fused') or K1-h (XCLIP_FF_STORE=h) in
    fp32 on the card against the same stack's plain versions on the CPU:
    output and every gradient, and the kernels ran."""
    from xclip_tpu_torch.nn import layers as tlayers
    if store:
        monkeypatch.setenv("XCLIP_FF_STORE", store)
    torch.manual_seed(3)
    x = torch.randn(3, 21, 128)
    mask = torch.ones(3, 21, dtype=torch.bool)
    mask[1, 9:] = False
    cot = torch.randn(3, 21, 128)
    counters = ((k8.geglu_layernorm_fwd, k8.geglu_layernorm_bwd)
                if store is None else
                (ffb.ff_block_fwd_stored_h, ffb.ff_block_bwd_p1_stored_h))
    before = [c.launches for c in counters]
    results = []
    for dev in ("cpu", cuda_device):
        stack = tlayers.Transformer(128, depth=2, dim_head=64, heads=2,
                                    generator=torch.Generator().manual_seed(4))
        stack.to(dev)
        tx = x.to(dev, copy=True).requires_grad_(True)
        out = stack(tx, mask.to(dev), attn_impl="fused", ff_impl=ff_impl,
                    training=True)
        out.backward(cot.to(dev))
        results.append([out.detach(), tx.grad,
                        *(p.grad for p in stack.parameters())])
    assert [c.launches for c in counters] == [n + 2 for n in before]
    for want, got in zip(*results):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=_grad_atol(want, "float32"))


# ------------------------------------ the bf16 and fp32 product kernels alone

# (m, n, k) at the flagship widths, "R" the rows: each instance's product
# in the b = 2048 step (kernels/matmul.py INSTANCES)
MM_FLAGSHIP = {("store", False, False): ("R", 1536, 512),
               ("store_f32", False, False): ("R", 4096, 512),
               ("store_f32", False, True): ("R", 512, 4096),
               ("store_f32", True, False): (512, 4096, "R"),
               ("geglu", False, False): ("R", 2048, 512),
               ("geglu_triple", False, False): ("R", 2048, 512),
               ("geglu_h", False, False): ("R", 2048, 512),
               ("residual", False, False): ("R", 512, 2048)}


def _mm_args(instance, m, n, k, device, seed=0, dtype=torch.bfloat16):
    """Operands of `instance` at (m, n, k) in `dtype`: unit-scale A, B
    scaled by k^-1/2, resid for 'residual', gemm_split's k-ranges for
    Aᵀ·B."""
    epi, ta, tb = instance
    g = torch.Generator(device=device).manual_seed(seed)
    width = 2 * n if epi.startswith("geglu") else n

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=device)
                * scale).to(dtype)

    a = rnd(*((k, m) if ta else (m, k)))
    b = rnd(*((width, k) if tb else (k, width)), scale=k ** -0.5)
    resid = rnd(m, n) if epi == "residual" else None
    return (a, b, epi, ta, tb, resid,
            matmul.split(m, n, k, dtype) if ta else None)


def _assert_products_close(got, want):
    """bf16 outputs within two ulps of their largest magnitude; fp32 ones
    (the same operands, summed in another order) within 1e-4 of it."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        top = max(float(w.float().abs().max()), 2.0 ** -20)
        atol = (2 * 2.0 ** (math.floor(math.log2(top)) - 7)
                if w.dtype == torch.bfloat16 else 1e-4 * top)
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=atol)


def _step_rows():
    """Rows of one chunk of the b = 2048 step's FF recompute backward."""
    start, stop = ffb.bwd_recompute_spans(2048 * 257, 512, 2048,
                                          torch.bfloat16)[0]
    return stop - start


@pytest.mark.cuda
@pytest.mark.parametrize("instance", matmul.INSTANCES,
                         ids=["-".join(map(str, i)) for i in matmul.INSTANCES])
@pytest.mark.parametrize("rows", ["small", "ragged", "step"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_product_kernel_matches_plain(cuda_device, instance, rows, dtype):
    """Every instance of either kernel at a ragged row count (77 rows of
    64 / 192 wide operands; 65,792 + 37 and one b = 2048 chunk at the
    flagship widths)."""
    if rows == "small":
        m, n, k = (64, 192, 77) if instance[1] else (77, 192, 64)
    else:
        r = 65_792 + 37 if rows == "ragged" else _step_rows()
        m, n, k = (r if v == "R" else v for v in MM_FLAGSHIP[instance])
    args = _mm_args(instance, m, n, k, cuda_device, dtype=dtype)
    launches = matmul.kernel_launches(dtype=dtype)[instance]
    got = matmul.mm(*args)
    assert matmul.kernel_launches(dtype=dtype)[instance] == launches + 1
    _assert_products_close(got, matmul.mm_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("instance", matmul.INSTANCES,
                         ids=["-".join(map(str, i)) for i in matmul.INSTANCES])
@pytest.mark.parametrize("offset", [0, 1])
def test_fp32_product_kernel_takes_any_shape_and_pointer(cuda_device,
                                                         instance, offset):
    """The fp32 kernel's 4-byte copies: m and k off the 4-float grid (66
    and 75), and with offset 1 every operand a float off 16 bytes; against
    mm_plain as above."""
    epi, ta, tb = instance
    m, n, k = 66, 192, 75
    args = list(_mm_args(instance, m, n, k, cuda_device, seed=3,
                         dtype=torch.float32))

    def shifted(t):
        flat = torch.empty(t.numel() + offset, device=cuda_device)
        out = flat[offset:].view(t.shape)
        out.copy_(t)
        return out

    args[0], args[1] = shifted(args[0]), shifted(args[1])
    if args[5] is not None:
        args[5] = shifted(args[5])
    _assert_products_close(matmul.mm(*args), matmul.mm_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_product_kernel_is_deterministic(cuda_device, dtype):
    for instance in matmul.INSTANCES:
        m, n, k = (512, 1536, 20_000) if instance[1] else (3_001, 512, 1536)
        args = _mm_args(instance, m, n, k, cuda_device, seed=1, dtype=dtype)
        runs = [matmul.mm(*args) for _ in range(2)]
        runs = [r if isinstance(r, tuple) else (r,) for r in runs]
        assert all(torch.equal(x, y) for x, y in zip(*runs)), instance


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_chunked_weight_gradient_equals_unchunked(cuda_device, dtype):
    """k-ranges of ROW_BLOCK rows: chunks of the rows at multiples of it
    give the same partials as the whole, and the FF recompute backward's
    running sum of each chunk's ordered partials the same bits."""
    instance = ("store_f32", True, False)
    rows, kb = 9_000, ffb.ROW_BLOCK
    a, b, *_ = _mm_args(instance, 512, 1536, rows, cuda_device, seed=2,
                        dtype=dtype)
    whole = matmul.mm(a, b, "store_f32", True, False, None, kb)
    pieces = [matmul.mm(a[s:e], b[s:e], "store_f32", True, False, None, kb)
              for s, e in ((0, 4096), (4096, 6144), (6144, rows))]
    assert torch.equal(torch.cat(pieces), whole)
    assert torch.equal(matmul.ordered_sum(torch.cat(pieces)),
                       matmul.ordered_sum(whole))


@pytest.mark.cuda
def test_product_kernel_raises_on_what_tma_cannot_take(cuda_device):
    instance = ("store", False, False)
    a, b, *_ = _mm_args(instance, 256, 128, 64, cuda_device)
    flat = torch.empty(256 * 64 + 8, dtype=torch.bfloat16, device=cuda_device)
    misaligned = flat[1:1 + 256 * 64].view(256, 64)   # 2 bytes off 16
    misaligned.copy_(a)
    with pytest.raises(RuntimeError, match="xclip_mm"):
        matmul.mm(misaligned, b, "store")
    with pytest.raises(RuntimeError, match="xclip_mm"):
        matmul.mm(a, b[:, :96].contiguous(), "store")   # n not 64-aligned
    rows_a, rows_b, *_ = _mm_args(("store_f32", True, False), 64, 128, 300,
                                  cuda_device)
    with pytest.raises(RuntimeError, match="xclip_mm"):  # k_split % 64 != 0
        matmul.mm(rows_a, rows_b, "store_f32", True, False, None, 100)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_matches_the_library(cuda_device, dtype):
    for m, n, k in [(512, 4096, 65_792), (2048, 512, 65_792),
                    (512, 512, 3_341), (64, 192, 77), (512, 1536, 526_336),
                    (512, 4096, 24_576)]:
        assert matmul.library_split(m, n, k, dtype) == matmul.split(
            m, n, k, dtype)
        assert matmul.library_split(m, n, k, dtype, 2048) == 2048


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_blocks_launch_the_product_kernel(cuda_device, dtype):
    """K-FF's forward runs its two products on the kernel of its dtype: the
    GEGLU and the residual instance, once each, and nothing on the other."""
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    args = to_torch(ff_args(R=130, D=128, I=256), dtype, cuda_device)
    before = matmul.kernel_launches(dtype=dtype)
    others = matmul.kernel_launches(dtype=other)
    ffb.ff_block(*args)
    after = matmul.kernel_launches(dtype=dtype)
    grew = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert grew == {("geglu", False, False): 1, ("residual", False, False): 1}
    assert matmul.kernel_launches(dtype=other) == others


# -------------------------------------------- LN / GEGLU backward row kernels

# (kernel, mode, form): every mode, kLnBwd in its callers' two forms ("pre":
# fp32 dy, v and resid of the storage dtype, xn written; "out": dy of the
# storage dtype, fp32 v, as K3's out LayerNorm)
ROW_FORMS = [("geglu", "recompute", None), ("geglu", "k8", None),
             ("geglu", "stored_h", None), ("ln", "geglu", None),
             ("ln", "ln", "pre"), ("ln", "ln", "out")]
# rows x width: every width at a small and at the b = 2048 step's chunk
# rows, ragged 65,792-row cases at the flagship's widths, and widths off
# the 64 grid: short rows of 16-byte vectors (96, 160), element by element
# (7, 100), and a last vector empty or short at two and four vectors a
# thread (4104, 4100)
ROW_SHAPES = [(rows, d) for rows in (77, 24_576)
              for d in (64, 512, 2048, 3072, 8192)] + [
    (65_792 + 37, 512), (65_792 + 37, 2048), (77, 7), (77, 96), (77, 100),
    (77, 160), (130, 4100), (130, 4104)]


def _row_args(kernel, mode, form, rows, d, dtype, device, seed=0):
    """(args, kwargs) of a row-kernel call as its callers give it:
    unit-scale rows, gains near 1, the statistics of the rows' values."""
    gen = torch.Generator(device).manual_seed(seed)
    f32 = torch.float32

    def rand(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    def stats(v):
        mean, inv = kcommon.ln_stats_fp32(
            v, kcommon.eps_for(dtype))
        return mean[:, 0], inv[:, 0]

    g = 1 + 0.1 * rand(d, dtype=dtype)
    if kernel == "geglu" or mode == "geglu":
        h32 = rand(rows, 2 * d)
        a, b, phi, gelu_b = kcommon.geglu_parts(h32)
        st = stats(a * gelu_b)
    if kernel == "geglu":
        h = h32 if mode == "recompute" else h32.to(dtype)
        dy = rand(rows, d, dtype=dtype if mode == "k8" else f32)
        return (mode, dy, h, g), {"stats": None if mode == "k8" else st}
    if mode == "geglu":
        return (("geglu", rand(rows, d), (a * gelu_b).to(dtype), g, st),
                {"gb": gelu_b.to(dtype),
                 "agdb": (a * kcommon.gelu_grad(b, phi)).to(dtype)})
    pre = form == "pre"
    v = rand(rows, d, dtype=dtype if pre else f32)
    return (("ln", rand(rows, d, dtype=f32 if pre else dtype), v, g,
             stats(v.float())),
            {"resid": rand(rows, d, dtype=dtype) if pre else None,
             "xn_out": pre})


def _run_rows(kernel, args, kw, plain=False):
    fn = {"geglu": (rows_mod.geglu_bwd_rows, rows_mod.geglu_bwd_rows_plain),
          "ln": (rows_mod.ln_bwd_rows, rows_mod.ln_bwd_rows_plain)}[kernel]
    return fn[plain](*args, **kw)


def _row_atol(want):
    """bf16: two ulps of the tensor's largest magnitude; fp32 (the dg
    partials in either dtype): 1e-4 of it."""
    top = max(float(want.float().abs().max()), 2.0 ** -20)
    if want.dtype == torch.bfloat16:
        return 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
    return 1e-4 * top


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", ROW_SHAPES)
@pytest.mark.parametrize("kernel,mode,form", ROW_FORMS)
def test_row_kernels_match_plain(cuda_device, kernel, mode, form, rows, d,
                                 dtype):
    args, kw = _row_args(kernel, mode, form, rows, d, getattr(torch, dtype),
                         cuda_device)
    fn = rows_mod.geglu_bwd_rows if kernel == "geglu" else rows_mod.ln_bwd_rows
    before = fn.launches
    got = _run_rows(kernel, args, kw)
    assert fn.launches == before + 1
    want = _run_rows(kernel, args, kw, plain=True)
    assert got[-1].shape == (rows_mod.blocks(rows), d)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), i
        if w is not None:
            assert g.dtype == w.dtype and torch.isfinite(g.float()).all(), i
            torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                       atol=_row_atol(w), msg=str(i))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,mode,form", ROW_FORMS)
def test_row_kernels_are_deterministic(cuda_device, kernel, mode, form):
    args, kw = _row_args(kernel, mode, form, 24_576 + 37, 2048,
                         torch.bfloat16, cuda_device, seed=1)
    first, second = _run_rows(kernel, args, kw), _run_rows(kernel, args, kw)
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8192 + 8, 8192 + 64])
def test_row_kernels_raise_on_a_width_they_cannot_take(cuda_device, d):
    for kernel, mode, form in ROW_FORMS:
        args, kw = _row_args(kernel, mode, form, 70, d, torch.bfloat16,
                             cuda_device)
        with pytest.raises(ValueError, match="between 1 and 8192"):
            _run_rows(kernel, args, kw)
    # the C entry point refuses it too, launching nothing
    x = torch.zeros(70, d, device=cuda_device)
    part = torch.zeros(rows_mod.blocks(70), d, device=cuda_device)
    g = torch.ones(d, device=cuda_device)
    st = torch.ones(70, device=cuda_device)
    err = rows_mod._build.library().xclip_ln_bwd_rows(
        0, 0, 1, 0, x.data_ptr(), x.data_ptr(), st.data_ptr(), st.data_ptr(),
        g.data_ptr(), None, x.data_ptr(), part.data_ptr(), 70, d, None, None,
        None, None, None, None, torch.cuda.current_stream().cuda_stream)
    assert err != 0
    h, dy = torch.randn(8, 2 * d, device=cuda_device), torch.randn(
        8, d, device=cuda_device)
    with pytest.raises(ValueError, match="up to 8192"):
        k8.geglu_layernorm_bwd(h, torch.ones(d, device=cuda_device), dy)


@pytest.mark.cuda
def test_blocks_count_their_row_kernel_launches(cuda_device):
    """The library counts each row-kernel mode's launches from every
    caller: the FF recompute backward launches the recompute mode and a
    LayerNorm backward once a row chunk, K1's pass 1 the GEGLU-triple mode
    and a LayerNorm backward, the wrappers their own mode."""
    dt = torch.bfloat16
    args = to_torch(ff_args(R=130, D=128, I=256), dt, cuda_device)
    do = torch.randn(130, 128, device=cuda_device).to(dt)
    rows_mod.kernel_launches(reset=True)
    _, stats = ffb.ff_block_fwd_stats(*args)
    ffb.ff_block_bwd_recompute(*args, do, stats)
    _, stored = ffb.ff_block_fwd_stored(*args)
    ffb.ff_block_bwd_p1(*args, do, stored)
    counts = rows_mod.kernel_launches()
    assert {k: counts[k] for k in rows_mod.COUNTERS} == {
        ("geglu", "recompute"): 1, ("geglu", "k8"): 0,
        ("geglu", "stored_h"): 0, ("ln", "ln"): 2, ("ln", "geglu"): 1}
    # the forward rows: K-FF-s's two LayerNorms with statistics, the
    # recompute backward's xn, K1's pre-LayerNorm and its inner one
    # keeping the product
    assert {m: counts[("ln_fwd", m)] for m in rows_mod.LN_FWD_MODES} == {
        "plain": 1, "stats": 3, "residual": 0, "in_copy": 1, "geglu": 0}
    rows_mod.kernel_launches(reset=True)
    for (kernel, mode, form) in ROW_FORMS:
        args, kw = _row_args(kernel, mode, form, 77, 128, dt, cuda_device)
        _run_rows(kernel, args, kw)
    counts = rows_mod.kernel_launches(reset=True)
    assert counts[("geglu", "k8")] == 1 and counts[("ln", "ln")] == 2
    assert rows_mod.kernel_launches()[("ln", "ln")] == 0


# ------------------------------------------------- LayerNorm forward rows

LN_FWD_WIDTHS = (7, 96, 100, 160, 512, 2048, 4100, 4104, 8192)


def _ln_fwd_args(mode, rows, d, dtype, x_f32, device, seed=0):
    gen = torch.Generator(device).manual_seed(seed)

    def rand(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen, device=device).to(dt)

    x = rand(rows, 2 * d if mode == "geglu" else d,
             dt=torch.float32 if x_f32 else dtype)
    return (mode, x, 1 + 0.1 * rand(d, dt=dtype),
            rand(rows, d, dt=dtype) if mode == "residual" else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [77, 24_576])
@pytest.mark.parametrize("d", LN_FWD_WIDTHS)
@pytest.mark.parametrize("mode,x_f32", [
    ("plain", False), ("stats", False), ("stats", True), ("residual", True),
    ("in_copy", True), ("geglu", False)])
def test_ln_fwd_rows_match_plain(cuda_device, mode, x_f32, d, rows, dtype):
    """Every LayerNorm forward mode, rows of the storage dtype or fp32 as
    its callers give them, at widths 7 to 8,192 on and off the 8-column
    grid, against its plain version (bf16 two ulps of the largest
    magnitude, fp32 1e-4 of it); two launches bit for bit equal."""
    args = _ln_fwd_args(mode, rows, d, getattr(torch, dtype), x_f32,
                        cuda_device)
    before = rows_mod.ln_rows.launches
    got = rows_mod.ln_rows(*args)
    assert rows_mod.ln_rows.launches == before + 1
    want = rows_mod.ln_rows_plain(*args)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.isfinite(g.float()).all(), i
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=_row_atol(w), msg=str(i))
    again = rows_mod.ln_rows(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_ln_fwd_rows_raise_past_8192(cuda_device):
    """A row wider than the kernels' 8,192 raises before any launch; the C
    entry point refuses it too."""
    x = torch.zeros(8, 8200, device=cuda_device)
    g = torch.ones(8200, device=cuda_device)
    with pytest.raises(ValueError, match="between 1 and 8192"):
        rows_mod.ln_rows("plain", x, g)
    err = rows_mod._build.library().xclip_ln_fwd_rows(
        0, 0, 0, x.data_ptr(), g.data_ptr(), None, x.data_ptr(), 8, 8200,
        1e-5, None, None, None, torch.cuda.current_stream().cuda_stream)
    assert err != 0


# ------------------------------------ narrow heads, and past the kernels

NARROW_CLIPS = [  # (CLIP kwargs, routes)
    (dict(text_dim_head=32), dict(attn_impl="fused", visual_attn_impl="fused",
                                  ff_impl="block_stored")),
    (dict(text_dim_head=32), dict(attn_impl="fused_recompute",
                                  ff_impl="block")),
    (dict(text_dim_head=32, text_rotary_pos_emb=True),
     dict(attn_impl="fused", ff_impl="block_stored")),
    (dict(text_dim_head=32), dict(attn_impl="flash", ff_impl="block_stored")),
    (dict(text_dim_head=128), dict(attn_impl="flash")),
    (dict(text_dim_head=96), dict(attn_impl="flash")),
    (dict(text_dim_head=128), dict(attn_impl="fused_recompute",
                                   ff_impl="block")),
    (dict(text_dim_head=80, visual_dim_head=80),
     dict(attn_impl="fused", ff_impl="block_stored")),
]
PAST_CLIPS = [  # (CLIP kwargs, routes, the limit's words)
    (dict(text_dim_head=256), dict(attn_impl="fused_recompute",
                                   ff_impl="block"), "not 256"),
    (dict(dim_text=72, text_heads=2), dict(ff_impl="block"),
     "not dim 72, inner 288"),
]
SMALL_CLIP = dict(dim_text=128, dim_image=128, dim_latent=64,
                  num_text_tokens=1000, text_enc_depth=2, text_seq_len=32,
                  text_heads=4, visual_enc_depth=2, visual_heads=2,
                  visual_image_size=64, visual_patch_size=16)


def _small_inputs(device, seed):
    gen = torch.Generator(device).manual_seed(seed)
    text = torch.randint(1, 1000, (4, 32), generator=gen, device=device)
    text[:, 20:] = 0
    return text, torch.randn(4, 3, 64, 64, generator=gen,
                             device=device).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("extra,routes", NARROW_CLIPS)
def test_clip_with_narrow_heads_runs_the_kernels(cuda_device, extra, routes):
    """A small CLIP whose text heads are 32 wide (zero-padded to 64), 96 or
    128 wide (the kernels take 128 as two 64-column halves), or whose heads
    are 80 wide in both towers (zero-padded to 128) serves and trains on
    the card through its kernels, with no fallback warning, and its latents
    and loss match the plain routes' (bf16: latents 3e-2, the first loss
    0.05)."""
    import warnings
    import xclip_tpu_torch
    from xclip_tpu_torch.train import default_optimizer, make_train_step
    bf = torch.bfloat16
    text, images = _small_inputs(cuda_device, 3)
    model = xclip_tpu_torch.CLIP(**SMALL_CLIP, **extra, **routes,
                                 param_dtype=bf, compute_dtype="bfloat16",
                                 seed=3)
    plain = xclip_tpu_torch.CLIP(**SMALL_CLIP, **extra, param_dtype=bf,
                                 compute_dtype="bfloat16")
    plain.load_state_dict(model.state_dict())
    counters = (mega.attention_block, flash.flash_attention_fwd,
                core.attention_core_fwd)
    before = [c.launches for c in counters]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with torch.no_grad():
            got = model(text, images, return_latents=True)
    # both towers' attention layers launched their kernels
    assert sum(c.launches - b for c, b in zip(counters, before)) == 4
    with torch.no_grad():
        want = plain(text, images, return_latents=True)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g.float() - w.float()).abs().max().item() <= 3e-2
    # the same patch-dropout draw on both routes
    losses = [make_train_step(m, default_optimizer(m.parameters()))(
        text, images, generator=torch.Generator(cuda_device).manual_seed(4))[
            "loss"].float().item() for m in (model, plain)]
    assert math.isfinite(losses[0]) and abs(losses[0] - losses[1]) <= 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("extra,routes,words", PAST_CLIPS)
def test_clip_past_the_kernels_raises(cuda_device, extra, routes, words):
    """Where the CUDA kernels cannot take a shape the JAX package runs,
    the entry point raises naming the limit; no plain route runs in the
    kernel's place."""
    import xclip_tpu_torch
    text, images = _small_inputs(cuda_device, 5)
    model = xclip_tpu_torch.CLIP(**{**SMALL_CLIP, **extra}, **routes,
                                 param_dtype=torch.bfloat16,
                                 compute_dtype="bfloat16", seed=5)
    with pytest.raises(ValueError, match=words):
        with torch.no_grad():
            model(text, images, return_latents=True)


# ----------------------------------------- the training surface on the card

SURFACE_CLIP = dict(dim_text=128, dim_image=128, dim_latent=128,
                  num_text_tokens=500, text_enc_depth=2, text_seq_len=32,
                  text_heads=2, visual_enc_depth=2, visual_heads=2,
                  visual_image_size=64, visual_patch_size=16,
                  visual_patch_dropout=0.5)
CARD_ROUTES = {"stored": dict(attn_impl="fused", ff_impl="block_stored"),
               "lean": dict(attn_impl="fused_recompute", ff_impl="block",
                            loss_impl="fused")}


def _small_batch(device, b=8):
    g = torch.Generator(device=device).manual_seed(5)
    text = torch.randint(1, 500, (b, 32), generator=g, device=device)
    text[:, 20:] = 0
    image = torch.randn(b, 3, 64, 64, generator=g, device=device)
    return text, image.to(torch.bfloat16)


def _card_clip(routes, **flags):
    from xclip_tpu_torch import CLIP
    return CLIP(**SURFACE_CLIP, **routes, param_dtype=torch.bfloat16,
                compute_dtype="bfloat16", device="cuda", seed=0, **flags)


def _card_grads(model, text, image, seed=7):
    model.zero_grad(set_to_none=True)
    loss = model(text, image, return_loss=True,
                 generator=torch.Generator(device="cuda").manual_seed(seed))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()
                           if p.grad is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["stored", "lean"])
@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_is_bit_equal_on_the_card(cuda_device, route, policy):
    """Remat None and 'dots' on the stored (K2, K1) and lean (K3, K-FF-s,
    K5) routes: loss and every gradient bit for bit the step without
    remat, each forward kernel launched twice a layer."""
    forwards = ((mega.attention_block_fwd_stored, ffb.ff_block_fwd_stored)
                if route == "stored" else
                (mega.attention_block_fwd_stats, ffb.ff_block_fwd_stats))
    text, image = _small_batch(cuda_device)
    plain = _card_clip(CARD_ROUTES[route])
    remat = _card_clip(CARD_ROUTES[route], checkpoint_during_training=True,
                       remat_policy=policy)
    launches = []
    results = []
    for model in (plain, remat):
        before = [c.launches for c in forwards]
        results.append(_card_grads(model, text, image))
        launches.append([c.launches - n for c, n in zip(forwards, before)])
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    # the megablock and the FF block in both towers' 4 layers
    assert launches[0] == [4, 4]
    assert launches[1] == [2 * n for n in launches[0]]


@pytest.mark.cuda
def test_checkpoint_resume_is_bit_equal_on_the_card(cuda_device, tmp_path):
    from xclip_tpu_torch.train import (default_optimizer, make_train_step,
                                       restore_checkpoint, save_checkpoint)
    text, image = _small_batch(cuda_device)
    model = _card_clip(CARD_ROUTES["stored"])
    opt = default_optimizer(model.parameters(), learning_rate=1e-3)
    step = make_train_step(model, opt)

    def gen(i):
        return torch.Generator(device="cuda").manual_seed(i)

    for i in range(2):
        step(text, image, generator=gen(i))
    save_checkpoint(str(tmp_path / "ck"), model, opt, step=2)
    want = step(text, image, generator=gen(2))
    fresh = _card_clip(CARD_ROUTES["stored"])
    fresh_opt = default_optimizer(fresh.parameters(), learning_rate=1e-3)
    assert restore_checkpoint(str(tmp_path / "ck"), fresh, fresh_opt) == 2
    got = make_train_step(fresh, fresh_opt)(text, image, generator=gen(2))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for p, q in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(p, q)
    a, b = opt.state_dict(), fresh_opt.state_dict()
    assert a["count"] == b["count"] == 3
    for i in a["state"]:
        for m in ("mu", "nu"):
            assert torch.equal(a["state"][i][m], b["state"][i][m]), (i, m)


@pytest.mark.cuda
def test_dropout_route_launches_k5_and_no_block_kernel(cuda_device,
                                                      monkeypatch):
    """Custom encoders with attention and FF dropout on the kernel flags:
    the plain attention and FF run, K5 the loss; no megablock or FF block
    launches."""
    from xclip_tpu_torch import CLIP
    from xclip_tpu_torch.nn import layers as tlayers
    from xclip_tpu_torch.nn.text import TextTransformer
    from xclip_tpu_torch.nn.vision import VisionTransformer
    g = torch.Generator().manual_seed(0)
    tower = dict(depth=2, heads=2, ff_impl="block_stored", attn_dropout=0.1,
                 ff_dropout=0.1, generator=g, dtype=torch.bfloat16)
    model = CLIP(**SURFACE_CLIP, attn_impl="fused", loss_impl="fused",
                 param_dtype=torch.bfloat16, compute_dtype="bfloat16",
                 device="cuda", text_encoder=TextTransformer(128, 500, 32,
                                                             **tower),
                 image_encoder=VisionTransformer(128, 64, 16, **tower))
    counters = (mega.attention_block, mega.attention_block_fwd_stored,
                mega.attention_block_fwd_stats, ffb.ff_block,
                ffb.ff_block_fwd_stored, ffb.ff_block_fwd_stats,
                lse5.streaming_lse_fwd, lse5.streaming_lse_bwd)
    before = [c.launches for c in counters]
    text, image = _small_batch(cuda_device)
    monkeypatch.setattr(tlayers, "_warned_fallbacks", set())
    with pytest.warns(UserWarning, match="falling back"):
        loss, grads = _card_grads(model, text, image)
    assert torch.isfinite(loss) and grads
    assert [c.launches - n for c, n in zip(counters, before)] == (
        [0] * 6 + [2, 2])


OBJECTIVE_FLAGS = dict(use_mlm=True, use_visual_ssl=True,
                       decoupled_contrastive_learning=True,
                       extra_latent_projection=True, sim_reg_loss_weight=0.1,
                       loss_impl="fused")
CARD_PLAIN = dict(attn_impl="xla", ff_impl="xla")


def _objective_step(model, text, image, draws):
    """One fp32 training forward and backward with every draw injected:
    (metrics, {name: gradient})."""
    model.zero_grad(set_to_none=True)
    loss, metrics = model(text, image, return_loss=True, return_metrics=True,
                          aug_text=text.flip(0), aug_image=image.flip(0),
                          **draws)
    loss.backward()
    return metrics, {n: p.grad for n, p in model.named_parameters()
                     if p.grad is not None}


def _gradient_rule(got, want):
    """The repo's gradient rule: 1e-3 relative with 1e-5 of the tensor's
    largest magnitude."""
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(
            got[k], want[k], rtol=1e-3,
            atol=1e-5 * max(1.0, want[k].abs().max().item()), msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["stored", "lean"])
def test_every_objective_on_the_kernel_routes_matches_plain(cuda_device,
                                                            route):
    """MLM, SimSiam, an augmented text and image view, sim-reg, DCL, the
    extra heads and K5, fp32, from the same weights and draws, against the
    plain routes with the dense loss: every metric at 1e-4, every
    gradient to the gradient rule, the BatchNorm statistics at 1e-4; the
    kernels launch in every pass (the SimSiam targets on K-MEGA / K-FF),
    and the plain routes launch none."""
    from xclip_tpu_torch import CLIP
    from xclip_tpu_torch.objectives.augment import augment_draws
    text, image = _small_batch(cuda_device)
    image = image.float()
    kw = dict(**SURFACE_CLIP, **{**OBJECTIVE_FLAGS, "loss_impl": "xla"},
              device="cuda", seed=0)
    kernel = CLIP(**{**kw, **CARD_ROUTES[route], "loss_impl": "fused"})
    plain = CLIP(**kw, **CARD_PLAIN)
    plain.load_state_dict(kernel.state_dict())
    g = torch.Generator(device="cuda").manual_seed(3)

    def keep(rows):
        return torch.rand(rows, 16, generator=g, device="cuda").topk(
            8, dim=-1).indices

    draws = dict(keep_idx=keep(16), mlm_draws=kernel.model.mlm.draws(text, g),
                 ssl_draws={"augment": [augment_draws(g), augment_draws(g)],
                            "keep_idx": [keep(8) for _ in range(4)]})
    counters = (mega.attention_block, ffb.ff_block,
                mega.attention_block_fwd_stored, ffb.ff_block_fwd_stored,
                mega.attention_block_fwd_stats, ffb.ff_block_fwd_stats,
                lse5.streaming_lse_fwd, lse5.streaming_lse_bwd)
    before = [c.launches for c in counters]
    want, want_g = _objective_step(plain, text, image, draws)
    assert [c.launches for c in counters] == before
    got, got_g = _objective_step(kernel, text, image, draws)
    launched = [c.launches - n for c, n in zip(counters, before)]
    # 5 passes with gradients (MLM, main text, 2 online, main vision) and
    # the 2 targets, 2 layers each; K5 over 2 x 2 view pairs
    forwards = [10, 10, 0, 0] if route == "stored" else [0, 0, 10, 10]
    assert launched == [4, 4] + forwards + [8, 8]
    for k in ("loss", "cl_loss", "text_ssl_loss", "image_ssl_loss",
              "multiview_cl_loss", "sim_reg_loss"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-4,
                                   msg=k)
    _gradient_rule(got_g, want_g)
    for path, stats in want["bn_updates"].items():
        for a, b in zip(got["bn_updates"][path], stats):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=path)


@pytest.mark.cuda
def test_filip_blocked_matches_dense_on_the_card(cuda_device):
    """FILIP with the extra heads on the stored kernel routes, fp32: the
    column-blocked loss (blocks of 2) and every gradient against the
    dense at 1e-5 and the gradient rule."""
    from xclip_tpu_torch import CLIP
    text, image = _small_batch(cuda_device)
    image = image.float()
    kw = dict(**SURFACE_CLIP, **CARD_ROUTES["stored"],
              use_all_token_embeds=True, extra_latent_projection=True,
              device="cuda", seed=0)
    dense = CLIP(**kw)
    blocked = CLIP(**kw, filip_block=2)
    blocked.load_state_dict(dense.state_dict())
    keep = torch.rand(8, 16, generator=torch.Generator(device="cuda")
                      .manual_seed(4), device="cuda").topk(8, dim=-1).indices
    results = []
    for model in (dense, blocked):
        model.zero_grad(set_to_none=True)
        loss = model(text, image, return_loss=True, keep_idx=keep)
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in
                                        model.named_parameters()
                                        if p.grad is not None}))
    (want, want_g), (got, got_g) = results
    assert torch.isfinite(want)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    _gradient_rule(got_g, want_g)


@pytest.mark.cuda
def test_streaming_lse_at_one_rank_of_the_32k_batch(cuda_device):
    """K5 at one rank of the 32k global batch: 2048 rows against 32,768
    gathered columns (d = 512), DCL at row_offset 30,720 (rank 15). The
    backward takes the columns in chunks of 8,192, so the diagonal falls
    in its last chunk; forward and backward against the plain version."""
    R, C, d, offset = 2048, 32768, 512, 30720
    assert lse5.bwd_plan(R, C, d)[0] == 8192
    x, y = _lse_inputs(R, C, d, cuda_device)
    lse = lse5.streaming_lse_fwd(x, y, offset, True)
    want = lse5.streaming_lse_fwd_plain(x, y, offset, True)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-4)
    dlse = torch.randn(R, device=cuda_device)
    got = lse5.streaming_lse_bwd(x, y, want, dlse, offset, True)
    _assert_all_close(got, lse5.streaming_lse_bwd_plain(
        x, y, want, dlse, offset, True), "float32", ("dx", "dy"))


@pytest.mark.cuda
def test_gloo_group_refuses_cuda_tensors(cuda_device, tmp_path):
    """A gloo group carries CPU tensors only: the collectives raise on a
    CUDA tensor instead of staging it through the host."""
    import torch.distributed as dist
    from xclip_tpu_torch.parallel.collectives import (all_gather,
                                                      all_reduce_sum_, psum)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        x = torch.ones(2, 3, device=cuda_device, requires_grad=True)
        for call in (lambda: all_gather(x, group, dim=1),
                     lambda: psum(x, group),
                     lambda: all_reduce_sum_([x.detach()], group)):
            with pytest.raises(ValueError, match="gloo"):
                call()
        assert torch.equal(all_gather(x.detach().cpu(), group, dim=1),
                           torch.ones(2, 3))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["stored", "lean"])
def test_mesh_step_at_one_rank_is_bit_equal(cuda_device, tmp_path, route):
    """A (1, 1) mesh over a world-1 NCCL group (`create_mesh`,
    `shard_state`, `shard_batch`, `make_train_step(mesh=)`): the tiny
    model's kernel-route step bit for bit the step without a mesh (loss,
    `grad_norm`, every parameter and moment), with the same kernel
    launches."""
    import torch.distributed as dist
    from xclip_tpu_torch.parallel import create_mesh
    from xclip_tpu_torch.train import (default_optimizer, make_train_step,
                                       shard_batch, shard_state)
    counters = ((mega.attention_block_fwd_stored, ffb.ff_block_fwd_stored)
                if route == "stored" else
                (mega.attention_block_fwd_stats, ffb.ff_block_fwd_stats))
    text, image = _small_batch(cuda_device)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = create_mesh((1, 1))
        runs = []
        for on_mesh in (False, True):
            model = _card_clip(CARD_ROUTES[route])
            opt = default_optimizer(model.parameters(), learning_rate=1e-4)
            t, i, kw = text, image, {}
            if on_mesh:
                shard_state(model, opt, mesh)
                t, i = shard_batch((text, image), mesh)
                kw = dict(mesh=mesh)
            before = [c.launches for c in counters]
            m = make_train_step(model, opt, **kw)(
                t, i, generator=torch.Generator(device="cuda").manual_seed(7))
            torch.cuda.synchronize()
            runs.append((m, list(model.parameters()),
                         [opt.state[p]["mu"] for p in model.parameters()],
                         [c.launches - n for c, n in zip(counters, before)]))
    finally:
        dist.destroy_process_group()
    (m0, p0, mu0, n0), (m1, p1, mu1, n1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(map(torch.equal, p0, p1)) and all(map(torch.equal, mu0, mu1))
    assert n0 == n1 and min(n0) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("image_dtype", ["float32", "bfloat16"])
def test_loader_batches_reach_the_card_bit_for_bit(cuda_device, image_dtype):
    """20 batches with prefetch 2 while the default stream is kept busy:
    each batch on the card (staged in pinned memory, copied on the
    loader's stream) equals the host collate of the same indices, bit for
    bit, tokens, images, `valid` and `loader_state`."""
    import numpy as np
    from xclip_tpu_torch.data import SimpleTokenizer, TextImageLoader
    npr = np.random.RandomState(0)
    examples = [(f"{i} a photo of a cat", npr.randn(3, 64, 64).astype(
        np.float32)) for i in range(20 * 16 - 5)]
    kw = dict(batch_size=16, context_length=32, prefetch=2, shuffle_seed=0,
              tokenizer=SimpleTokenizer(), num_workers=2,
              image_dtype=image_dtype, drop_remainder=False,
              pad_remainder=True)
    host = list(TextImageLoader(examples, device="cpu", **kw))
    busy = torch.randn(2048, 2048, device=cuda_device)
    got = []
    for batch in TextImageLoader(examples, device=cuda_device, **kw):
        # read on the consumer's stream at once: it must wait for the copy
        batch["early"] = batch["image"].clone()
        for _ in range(4):             # the consumer's stream stays busy
            busy = torch.tanh(busy @ busy)
        got.append(batch)
    torch.cuda.synchronize()
    assert len(got) == len(host) == 20
    for g, h in zip(got, host):
        assert g["loader_state"] == h["loader_state"]
        assert g["image"].is_cuda and g["image"].dtype == h["image"].dtype
        assert torch.equal(g["text"].cpu(), h["text"])
        assert torch.equal(g["valid"].cpu(), h["valid"])
        for image in (g["image"], g["early"]):
            assert torch.equal(image.cpu().view(torch.int16),
                               h["image"].view(torch.int16))


# ---------------------------------------------------- heads of 128 (80 padded)

WIDE_CORE_CASES = [  # (n, heads, causal, mask kind)
    (33, 2, False, "keypad"), (257, 2, True, "dead"), (257, 2, False, "holes"),
    (256, 1, True, "keypad"), (2048, 1, True, "holes"),
    # b = 3: a TMA box of 64 rows crosses into the next batch element's rows
    # unless the 3-D map clips it; a single key is a whole tile
    (1, 2, False, "keypad"), (64, 2, True, "dead"), (65, 2, False, "holes")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["k6", "mega"])
@pytest.mark.parametrize("n,heads,causal,mask_kind", WIDE_CORE_CASES)
def test_attention_cores_at_head_width_128(cuda_device, dtype, which, n,
                                           heads, causal, mask_kind):
    """K6 and the megablock's core on heads of 128 (two 64-column halves),
    forward and backward, against their plain versions element by element
    (phase 12's rule), up to 2048 keys; two backward launches bit for bit
    equal."""
    dt = getattr(torch, dtype)
    qkv, mask, do = to_torch(core_args(b=3, n=n, heads=heads,
                                       mask_kind=mask_kind, dim_head=128),
                             dt, cuda_device)
    static = (heads, 128, 128 ** -0.5, causal, True)
    if which == "mega":
        fwd, bwd = mega.mega_core_fwd, mega.mega_core_bwd
        fwd_plain = mega.mega_core_fwd_plain
        bwd_plain = mega.mega_core_bwd_plain
        names, cot = ("attnout", "sm"), do.float()
    else:
        fwd, bwd = core.attention_core_fwd, core.attention_core_bwd
        fwd_plain = core.attention_core_fwd_plain
        bwd_plain = core.attention_core_bwd_plain
        names, cot = ("out", "lse"), do
    before = (fwd.launches, bwd.launches)
    got = fwd(qkv, mask, *static)
    want = fwd_plain(qkv, mask, *static)
    _assert_elementwise(got, want, dtype, names)
    if which == "mega":
        grads = [bwd(qkv, mask, cot, *want, *static) for _ in range(2)]
        plain = bwd_plain(qkv, mask, cot, *want, *static)
    else:
        grads = [bwd(qkv, mask, *want, cot, *static) for _ in range(2)]
        plain = bwd_plain(qkv, mask, *want, cot, *static)
    assert torch.equal(grads[0], grads[1])
    _assert_elementwise((grads[0],), (plain,), dtype, ("dqkv",))
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 2)


WIDE_STATIC = (2, 128, 128 ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["k6", "mega"])
@pytest.mark.parametrize("n,causal,mask_kind",
                         [(257, False, "dead"), (200, True, "holes"),
                          (1, False, "keypad")])
def test_wide_bf16_forward_launches_agree_bit_for_bit(cuda_device, which, n,
                                                      causal, mask_kind):
    """The bf16 forward at heads of 128, K6's and the megablock's: two
    launches on the same inputs give the same bits (no atomics, a fixed
    order of every sum)."""
    qkv, mask, _ = to_torch(core_args(b=3, n=n, heads=2, mask_kind=mask_kind,
                                      dim_head=128), torch.bfloat16,
                            cuda_device)
    fwd = core.attention_core_fwd if which == "k6" else mega.mega_core_fwd
    before = fwd.launches
    first = fwd(qkv, mask, *WIDE_STATIC, causal, True)
    second = fwd(qkv, mask, *WIDE_STATIC, causal, True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert fwd.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n,causal,mask_kind",
                         [(257, False, "dead"), (70, True, "keypad")])
def test_mega_core_bwd_at_128_with_copies_over_dattn(cuda_device, n, causal,
                                                     mask_kind):
    """The bf16 megablock core's backward at heads of 128 with dattn's two
    bf16 copies written over dattn's own storage (`dcopy` aliasing dattn,
    as K2 and K3 call it): the dqkv of a separate `dcopy` bit for bit, and
    the plain version's element by element."""
    b, heads = 3, 2
    qkv, mask, do = to_torch(core_args(b=b, n=n, heads=heads,
                                       mask_kind=mask_kind, dim_head=128),
                             torch.bfloat16, cuda_device)
    static = (*WIDE_STATIC, causal, True)
    attnout, sm = mega.mega_core_fwd(qkv, mask, *static)
    dattn = do.float()
    want = mega.mega_core_bwd(qkv, mask, dattn, attnout, sm, *static)
    scratch = dattn.clone()
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, n, heads), dtype=torch.float32,
                        device=cuda_device)
    mask_u8 = mask.to(torch.uint8).contiguous()
    err = mega._build.library().xclip_mega_core_bwd(
        1, qkv.data_ptr(), mask_u8.data_ptr(), scratch.data_ptr(),
        attnout.data_ptr(), sm.data_ptr(), dqkv.data_ptr(), delta.data_ptr(),
        scratch.data_ptr(), b, n, heads, 128, float(WIDE_STATIC[2]),
        int(causal), 1, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    assert torch.equal(dqkv, want)
    _assert_elementwise(
        (dqkv,), (mega.mega_core_bwd_plain(qkv, mask, dattn, attnout, sm,
                                           *static),),
        "bfloat16", ("dqkv",))


def _misaligned(t):
    """A contiguous copy of t whose base lies one element past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["k6", "mega"])
@pytest.mark.parametrize("off", ["qkv", "cotangent"])
def test_wide_bf16_kernels_refuse_a_view_tma_cannot_take(cuda_device, which,
                                                         off):
    """A contiguous qkv (or backward cotangent) view whose base is not
    16-byte aligned (TMA boxes and 16-byte copies cannot start there)
    raises ValueError naming the limit, forward and backward, and launches
    nothing."""
    qkv, mask, do = to_torch(core_args(b=2, n=40, heads=2, dim_head=128),
                             torch.bfloat16, cuda_device)
    static = (*WIDE_STATIC, False, True)
    if which == "k6":
        fwd, bwd = core.attention_core_fwd, core.attention_core_bwd
        out, stats = fwd(qkv, mask, *static)
        cot = do
    else:
        fwd, bwd = mega.mega_core_fwd, mega.mega_core_bwd
        out, stats = fwd(qkv, mask, *static)
        cot = do.float()
    q_in = _misaligned(qkv) if off == "qkv" else qkv
    if off == "cotangent":
        cot = _misaligned(cot)
    bwd_args = ((q_in, mask, out, stats, cot) if which == "k6"
                else (q_in, mask, cot, out, stats))
    before = (fwd.launches, bwd.launches)
    if off == "qkv":
        with pytest.raises(ValueError, match="16-byte aligned"):
            fwd(q_in, mask, *static)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bwd(*bwd_args, *static)
    assert (fwd.launches, bwd.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind", ["keypad", "dead"])
@pytest.mark.parametrize("causal", [False, True])
def test_megablock_kernels_at_head_width_128(cuda_device, dtype, mask_kind,
                                             causal):
    """K-MEGA, K2 and K3 (both modes) at heads of 128: outputs and every
    gradient against their plain versions (fp32 1e-4 or two bf16 ulps of
    each tensor's largest magnitude)."""
    dt = getattr(torch, dtype)
    args = to_torch(mega_args(n=70, dim=128, heads=2, dim_head=128,
                              mask_kind=mask_kind), dt, cuda_device)
    static = (2, 128, 128 ** -0.5, causal, True)
    atol = 1e-4 if dtype == "float32" else BF16_ATOL
    torch.testing.assert_close(
        mega.attention_block(*args, *static).float(),
        mega.attention_block_plain(*args, *static).float(), atol=atol, rtol=0)
    out, stored = mega.attention_block_fwd_stored(*args, *static)
    want_out, want_stored = mega.attention_block_fwd_stored_plain(*args,
                                                                  *static)
    _assert_all_close((out, *stored), (want_out, *want_stored), dtype,
                      ("out", "qkv", "attnout", "proj", "sm", "ln_stats"))
    do = torch.randn(*out.shape, device=cuda_device).to(dt)
    _assert_all_close(
        mega.attention_block_bwd(*args, do, want_stored, *static),
        mega.attention_block_bwd_plain(*args, do, want_stored, *static),
        dtype, ("dx", "dg_pre", "dw_qkv", "dw_out", "dg_out", "dqkv"))
    for keep_qkv in (False, True):
        got = mega.attention_block_fwd_stats(*args, *static, keep_qkv)
        want = mega.attention_block_fwd_stats_plain(*args, *static, keep_qkv)
        names = ("out", "sm", "ln_stats", "qkv")[:3 + keep_qkv]
        _assert_all_close(got[:len(names)], want[:len(names)], dtype, names)
        _, sm, ln_stats, qkv = want
        _assert_all_close(
            mega.attention_block_bwd_recompute(*args, do, sm, ln_stats,
                                               *static, qkv=qkv),
            mega.attention_block_bwd_recompute_plain(*args, do, sm, ln_stats,
                                                     *static, qkv=qkv),
            dtype, ("dx", "dg_pre", "dw_qkv", "dw_out", "dg_out"))


@pytest.mark.cuda
@pytest.mark.parametrize("dim_head", [80, 104])
def test_heads_padded_to_128_match_the_unpadded_plain_versions(cuda_device,
                                                               dim_head):
    """The megablock's, K6's and K7's top-level wrappers run heads of 80
    (ViT-H/14) and 104 (ViT-bigG/14) zero-padded to 128 on the card, fp32:
    outputs and gradients against the plain versions at the true width on
    the CPU (1e-4 of the largest magnitude)."""
    heads, b, n, dim = 2, 2, 45, 128
    gen = torch.Generator().manual_seed(dim_head)
    hd = heads * dim_head
    mask = torch.ones(b, n, dtype=torch.bool)
    mask[1, 30:] = False
    scale = dim_head ** -0.5
    x = torch.randn(b, n, dim, generator=gen)
    g = 1 + 0.1 * torch.randn(dim, generator=gen)
    w_qkv = torch.randn(dim, 3 * hd, generator=gen) * dim ** -0.5
    w_out = torch.randn(hd, dim, generator=gen) * hd ** -0.5
    qkv = torch.randn(b, n, 3 * hd, generator=gen)
    q, k, v = (torch.randn(b, heads, n, dim_head, generator=gen)
               for _ in range(3))
    q = q * scale
    results = {}
    for dev in ("cuda", "cpu"):
        on = [t.to(dev).requires_grad_(t.is_floating_point()) for t in
              (x, w_qkv, w_out, qkv, q, k, v)]
        gg, mm = g.to(dev), mask.to(dev)
        if dev == "cuda":
            outs = [mega.attention_block_train(on[0], gg, on[1], on[2], gg,
                                               mm, heads, dim_head, scale),
                    mega.attention_block_train_recompute(
                        on[0], gg, on[1], on[2], gg, mm, heads, dim_head,
                        scale),
                    core.attention_core(on[3], mm, heads, dim_head, scale,
                                        causal=True),
                    flash.flash_attention(*on[4:], mm, causal=True)]
        else:
            def sdpa():
                s = on[4] @ on[5].transpose(-1, -2)
                valid = mm[:, None, None, :] & torch.ones(
                    n, n, dtype=torch.bool).tril()
                return s.masked_fill(~valid, float("-inf")).softmax(-1) @ on[6]
            outs = [mega.attention_block_plain(on[0], gg, on[1], on[2], gg,
                                               mm, heads, dim_head, scale)
                    for _ in range(2)]
            outs += [core.attention_core_fwd_plain(on[3], mm, heads, dim_head,
                                                   scale, True)[0], sdpa()]
        cot = [torch.randn(o.shape, generator=torch.Generator().manual_seed(
            i)).to(dev) for i, o in enumerate(outs)]
        leaves = [[on[0], on[1], on[2]], [on[0], on[1], on[2]], [on[3]],
                  on[4:]]
        results[dev] = [(o.detach().cpu(), [t.cpu() for t in
                                            torch.autograd.grad(o, lv, c)])
                        for o, lv, c in zip(outs, leaves, cot)]
    for (got, got_g), (want, want_g) in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
        for a, w in zip(got_g, want_g):
            torch.testing.assert_close(a, w, rtol=0,
                                       atol=1e-4 * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_f32_attention_kernels_hold_16_warps_an_sm(cuda_device, d):
    """The fp32 core's forward, dq and dk/dv kernels hold 16 warps an SM in
    every mode (the megablock's, K6's and K7's), as the occupancy
    calculator gives them for the build's registers and shared memory: two
    256-thread blocks at heads of 64, one block of two 256-thread halves
    (a 64-column half each) at 128."""
    lib = flash._build.library()
    block_warps = 8 * (d // 64)
    blocks = {("k7", "fwd"): lib.xclip_flash_fwd_blocks(d)}
    for which, name in ((0, "dq"), (1, "dkv")):
        blocks["k7", name] = lib.xclip_flash_bwd_blocks(which, d)
    for mode, kind in ((0, "mega"), (1, "k6")):
        blocks[kind, "fwd"] = lib.xclip_attention_fwd_blocks(0, mode, d, 0)
        for which, name in ((0, "dq"), (1, "dkv")):
            blocks[kind, name] = lib.xclip_attention_bwd_blocks(0, mode, which,
                                                                d, 0)
    warps = {key: b * block_warps for key, b in blocks.items()}
    assert warps == dict.fromkeys(blocks, 16), blocks


@pytest.mark.cuda
def test_bf16_attention_kernels_hold_8_warps_an_sm_at_128(cuda_device):
    """The bf16 forward, dq and dk/dv kernels at heads of 128 hold the 8
    warps an SM their designs are built for, K6's and the megablock's: two
    one-warpgroup wgmma blocks (forward, dq), two 4-warp blocks (dk/dv; the
    megablock's with one buffer of do and of T(dattn))."""
    lib = flash._build.library()
    got = {}
    for mode, kind in ((0, "mega"), (1, "k6")):
        got[kind, "fwd"] = (lib.xclip_attention_fwd_blocks(1, mode, 128, 0),
                            lib.xclip_attention_fwd_blocks(1, mode, 128, 1))
        for which, name in ((0, "dq"), (1, "dkv")):
            got[kind, name] = tuple(
                lib.xclip_attention_bwd_blocks(1, mode, which, 128, w)
                for w in (0, 1))
    assert got == dict.fromkeys(got, (2, 8)), got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mega", "k6", "k7"])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_attention_at_head_width_128_is_deterministic(cuda_device, kind,
                                                          causal):
    """Two launches of the fp32 kernels at heads of 128 (the forward and
    the dq and dk/dv pair) agree bit for bit in every mode, with whole
    masked key tiles and a dead row (K7: a row with no valid key)."""
    if kind == "k7":
        args = flash_args(b=4, n=257, mask_kind="holes", d=128)
        args[3][-1] = False
        q, k, v, mask, do = _flash_padded(args, torch.float32, cuda_device)
        runs = []
        for _ in range(2):
            out, lse = flash.flash_attention_fwd(q, k, v, mask, causal)
            runs.append((out, lse, *flash.flash_attention_bwd(
                q, k, v, mask, out, lse, do, causal)))
    else:
        qkv, mask, do = to_torch(core_args(b=4, n=257, heads=2,
                                           mask_kind="holes", dim_head=128),
                                 torch.float32, cuda_device)
        mask[-1] = False
        static = (2, 128, 128 ** -0.5, causal, True)
        runs = []
        for _ in range(2):
            if kind == "mega":
                fwd = mega.mega_core_fwd(qkv, mask, *static)
                bwd = mega.mega_core_bwd(qkv, mask, do, *fwd, *static)
            else:
                fwd = core.attention_core_fwd(qkv, mask, *static)
                bwd = core.attention_core_bwd(qkv, mask, *fwd, do, *static)
            runs.append((*fwd, bwd))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
