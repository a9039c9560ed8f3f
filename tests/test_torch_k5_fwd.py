"""K5's forward as the CUDA kernel computes it (`csrc/fused_infonce.cu`
`k5_gemm_kernel<kLse>` and `lse_merge_kernel`), mirrored in PyTorch and
held to the JAX package's `streaming_lse` (Pallas interpret mode) on the
CPU: each row's running max m and normaliser l over a fixed range of
columns, the ranges then merged in range order, M = max m_z, l = Σ_z l_z
exp(m_z − M), lse = M + log(max(l, 1e-30)) (m = 0 on a row whose every
column is masked). Inputs come from a numpy seed, at ragged R, C and d,
with and without DCL, with a row offset, and over several range counts:
the plan's (`fwd_plan`), one tile a range, two tiles a range, one range.

Tolerance: 1e-5 of each lse's largest magnitude (fp32 throughout; the
ranges change only the order of the max and the sums).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.kernels import fused_infonce as jlse
from xclip_tpu_torch.kernels import fused_infonce as lse5
import torch_one_thread  # noqa: F401


def _ranged_fwd(x, y, span, row_offset=0, decoupled=False):
    """lse (R,) from the (m, l) of each range of `span` columns, merged in
    range order, as the CUDA forward computes it."""
    s = x @ y.T
    if decoupled:
        diag = (torch.arange(y.shape[0])[None]
                == torch.arange(x.shape[0])[:, None] + row_offset)
        s = s.masked_fill(diag, float("-inf"))
    ms, ls = [], []
    for c0 in range(0, y.shape[0], span):
        t = s[:, c0:c0 + span]
        m = t.amax(dim=-1)
        safe = torch.where(m == float("-inf"), 0.0, m)
        ms.append(m)
        ls.append(torch.exp(t - safe[:, None]).sum(dim=-1))
    top = torch.stack(ms).amax(dim=0)
    safe = torch.where(top == float("-inf"), 0.0, top)
    total = torch.zeros_like(safe)
    for m, l in zip(ms, ls):
        total = total + torch.where(m == float("-inf"), 0.0,
                                    l * torch.exp(m - safe))
    return safe + torch.log(total.clamp_min(1e-30))


def _inputs(R, C, d, seed):
    npr = np.random.RandomState(seed)
    x = npr.randn(R, d).astype(np.float32)
    y = npr.randn(C, d).astype(np.float32)
    x = 10 * x / np.linalg.norm(x, axis=-1, keepdims=True)
    return x, y / np.linalg.norm(y, axis=-1, keepdims=True)


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    atol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("C", [1, 7, 130, 2048])
@pytest.mark.parametrize("d", [1, 33, 512])
@pytest.mark.parametrize("decoupled,row_offset", [(False, 0), (True, 0),
                                                  (True, 3)])
def test_ranged_forward_matches_pallas(C, d, decoupled, row_offset):
    """At C = 1 with DCL and no offset, row 0's only column is masked."""
    R = 9
    x, y = _inputs(R, C, d, seed=C + d)
    want = jlse.streaming_lse(jnp.asarray(x), jnp.asarray(y), row_offset,
                              decoupled)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    tile = lse5.TILE
    spans = {lse5.fwd_plan(R, C), tile, 2 * tile, math.ceil(C / tile) * tile}
    for span in sorted(spans):
        _close(_ranged_fwd(tx, ty, span, row_offset, decoupled), want,
               f"span {span}")
    _close(lse5.streaming_lse_fwd(tx, ty, row_offset, decoupled), want,
           "plain")


@pytest.mark.parametrize("R,C,d", [(130, 300, 64), (7, 2048, 33),
                                   (130, 4099, 1)])
def test_ranged_forward_matches_plain_across_row_tiles(R, C, d):
    """More than one 128-row tile, and ranges of one and several tiles."""
    x, y = map(torch.from_numpy, _inputs(R, C, d, seed=R))
    want = lse5.streaming_lse_fwd_plain(x, y, 5, True)
    for span in (128, 256, 1024):
        _close(_ranged_fwd(x, y, span, 5, True), want, f"span {span}")


def test_a_row_with_every_column_masked():
    """m = 0 and the sum clamped at 1e-30, as `_lse_kernel`'s finalize."""
    x, y = map(torch.from_numpy, _inputs(3, 1, 8, seed=1))
    got = _ranged_fwd(x, y, 128, 0, True)
    assert got[0].item() == pytest.approx(math.log(1e-30))
    torch.testing.assert_close(got, lse5.streaming_lse_fwd_plain(x, y, 0,
                                                                 True))


def test_fwd_plan_fills_the_card():
    """At the b = 2048 step's R = C = 2048: 16 row tiles x 16 ranges of one
    128-column tile, 256 blocks, two an SM on 132 SMs. Ranges are whole
    tiles and cover every column."""
    assert lse5.fwd_plan(2048, 2048) == 128
    for R, C in ((1, 1), (130, 4099), (8192, 8192), (2048, 32768)):
        span = lse5.fwd_plan(R, C)
        assert span % lse5.TILE == 0 and span >= lse5.TILE
        ranges = math.ceil(C / span)
        assert (ranges - 1) * span < C <= ranges * span
