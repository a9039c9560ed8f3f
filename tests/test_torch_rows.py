"""The row kernels' plain versions (`xclip_tpu_torch.kernels.rows`: the
LayerNorm forward rows in each mode, the GEGLU backward rows in their
recompute, K8 and stored-h modes, the LayerNorm backward rows plain and
from the GEGLU triple) against the JAX package's bodies on the CPU, on the
same x, h, dy and statistics made from a numpy seed: `layer_norm_apply`
(`xclip_tpu/nn/core.py`) and K8's forward (`fused_ff.py`, Pallas
interpret mode) for the forward modes, `_p1_recompute_core`,
`_p1_stored_core` (with
`_p2_stored_core` for dh2 and y), K8's backward (`fused_ff.py`, Pallas
interpret mode), `_common.ln_bwd` and `_p1_geglu_core` (with
`_p2_geglu_core` for dh2 and y2). The pass-2 bodies hand back only weight
gradients: fed x = I (dim = rows, statistics 0 and 1, gain 1) and do = I,
their products are dh2's halves and y themselves (one nonzero term a sum,
exact).

Tolerances: fp32 at 1e-5 of each output's largest magnitude (the JAX
bodies' erf is a polynomial within 1.5e-7 of erf, which the port computes
exactly, and the row sums are taken in another order); bf16 at two ulps
of each output's largest magnitude (both sides round at the same places;
those differences can flip a rounding). The dg partials of 64-row blocks,
summed in order, carry the same bits whether the rows are taken whole or
in chunks at multiples of 64. `reduce_parts` is bit for bit the strict
left-to-right fp32 sum (a numpy float32 loop) at every `acc`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.kernels import _common as jcommon
from xclip_tpu.kernels import fused_ff as jff8
from xclip_tpu.kernels import fused_ff_block as jffb
from xclip_tpu.nn import core as jcore
from xclip_tpu_torch.kernels import rows as rk
from xclip_tpu_torch.kernels.matmul import ordered_sum
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

ROWS, DIM, INNER = 130, 128, 128  # 130 rows: two whole 64-row blocks + 2


def _close(got, want, dtype, what):
    """got (torch) against want (numpy or JAX), as the module says."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32).reshape(got.shape)
    top = max(float(np.abs(want).max()), 2.0 ** -20)
    atol = (1e-5 * top if dtype == "float32"
            else 2 * 2.0 ** (np.floor(np.log2(top)) - 7))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


def _stats(v):
    """(mean, inv) of fp32 rows, two-pass, as (rows, 1) JAX arrays."""
    mean = jnp.mean(v, axis=-1, keepdims=True)
    c = v - mean
    return mean, jax.lax.rsqrt(jnp.mean(c * c, axis=-1, keepdims=True)
                               + jcommon.eps_for(v.dtype))


def _t(a, dtype=None):
    """A JAX array as a torch tensor (fp32 unless dtype)."""
    t = torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
    return t if dtype is None else t.to(dtype)


def _ff_inputs(dtype, seed, rows=ROWS):
    """x, do, gpre, gin, win, wout of the FF block in `dtype`, numpy seeded."""
    npr = np.random.RandomState(seed)
    dt = jnp.dtype(dtype)
    return (jnp.asarray(npr.randn(rows, DIM) * 0.5, dt),
            jnp.asarray(npr.randn(rows, DIM), dt),
            jnp.asarray(1 + 0.1 * npr.randn(DIM), dt),
            jnp.asarray(1 + 0.1 * npr.randn(INNER), dt),
            jnp.asarray(npr.randn(DIM, 2 * INNER) / np.sqrt(DIM), dt),
            jnp.asarray(npr.randn(INNER, DIM) / np.sqrt(INNER), dt))


def _h_dy(x, do, gpre, win, wout):
    """The pre-LN statistics, xn, h = xn·w_in and dy = do·w_outᵀ in fp32,
    as the pass-1 bodies compute them."""
    mp, ip = _stats(x.astype(jnp.float32))
    xn = (((x.astype(jnp.float32) - mp) * ip)
          * gpre.astype(jnp.float32)).astype(x.dtype)
    h = jax.lax.dot_general(xn, win, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
    dy = jax.lax.dot_general(do, wout, (((1,), (1,)), ((), ())),
                             preferred_element_type=jnp.float32)
    return mp, ip, h, dy


def _prod(h):
    a, b = h[:, :INNER], h[:, INNER:]
    gelu_b, gelu_db = jffb._gelu_val_grad(b)
    return a * gelu_b, gelu_b, a * gelu_db


def _eye_pass2(dtype, rows):
    """x = I (rows x rows), do = I, gain 1, statistics 0 and 1: the pass-2
    bodies' products become their operands."""
    eye = jnp.eye(rows, dtype=jnp.dtype(dtype))
    zero, one = jnp.zeros((rows, 1)), jnp.ones((rows, 1))
    return eye, eye, jnp.ones((rows,), jnp.dtype(dtype)), zero, one


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu_recompute_plain_matches_p1_recompute_core(dtype):
    x, do, gpre, gin, win, wout = _ff_inputs(dtype, seed=0)
    mp, ip, h, dy = _h_dy(x, do, gpre, win, wout)
    mi, ii = _stats(_prod(h)[0])
    _, _, _, want_dh, want_y, _, _, want_dg = jffb._p1_recompute_core(
        x, do, gpre, gin, win, wout, mp, ip, mi, ii)
    tdt = getattr(torch, dtype)
    dh, y, part = rk.geglu_bwd_rows_plain(
        "recompute", _t(dy), _t(h), _t(gin, tdt), (_t(mi[:, 0]), _t(ii[:, 0])))
    assert dh.dtype == y.dtype == tdt and part.shape == (3, INNER)
    _close(dh, want_dh, dtype, "dh")
    _close(y, want_y, dtype, "y")
    _close(ordered_sum(part), want_dg, "float32", "dg")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu_stored_h_plain_matches_p1_stored_core(dtype):
    rows = 96  # pass 2 fed x = I takes dim = rows
    x, do, gpre, gin, win, wout = _ff_inputs(dtype, seed=1, rows=rows)
    mp, ip, h32, dy = _h_dy(x, do, gpre, win, wout)
    mi, ii = _stats(_prod(h32)[0])  # from the fp32 h: the reference's quirk
    h = h32.astype(jnp.dtype(dtype))
    _, want_dprod, _, want_dg = jffb._p1_stored_core(
        x, do, gpre, gin, win, wout, h, mp, ip, mi, ii)
    x2, do2, gpre2, zero, one = _eye_pass2(dtype, rows)
    want_da, want_db, want_yt = jffb._p2_stored_core(
        x2, do2, gpre2, gin, h[:, :INNER], h[:, INNER:], want_dprod, mi, ii,
        zero, one)
    tdt = getattr(torch, dtype)
    dh, y, dprod, dh2, part = rk.geglu_bwd_rows_plain(
        "stored_h", _t(dy), _t(h, tdt), _t(gin, tdt),
        (_t(mi[:, 0]), _t(ii[:, 0])))
    assert dh.shape == dh2.shape == (rows, 2 * INNER)
    _close(dprod, want_dprod, dtype, "dprod")
    _close(ordered_sum(part), want_dg, "float32", "dg")
    _close(dh2[:, :INNER], want_da, dtype, "dh2 a")
    _close(dh2[:, INNER:], want_db, dtype, "dh2 b")
    _close(y, np.asarray(want_yt, np.float32).T, dtype, "y")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["plain", "stats", "residual", "in_copy"])
@pytest.mark.parametrize("d", [7, 100, 512])
def test_ln_fwd_plain_matches_layer_norm_apply(dtype, mode, d):
    """Each LayerNorm forward mode's plain version against
    `layer_norm_apply` on the same rows of the storage dtype: out (with the
    residual added in that dtype), the two-pass statistics, the copy."""
    npr = np.random.RandomState(7)
    dt = jnp.dtype(dtype)
    x = jnp.asarray(npr.randn(ROWS, d) * 2 + 0.5, dt)
    g = jnp.asarray(1 + 0.1 * npr.randn(d), dt)
    resid = jnp.asarray(npr.randn(ROWS, d), dt) if mode == "residual" \
        else None
    want = jcore.layer_norm_apply({"g": g}, x)
    if resid is not None:
        want = want + resid
    tdt = getattr(torch, dtype)
    got = rk.ln_rows_plain(mode, _t(x, tdt), _t(g, tdt),
                           None if resid is None else _t(resid, tdt))
    assert got[0].dtype == tdt
    _close(got[0], want, dtype, "out")
    if mode != "plain":
        mean, inv = _stats(jnp.asarray(x, jnp.float32))
        _close(got[1], mean, "float32", "mean")
        # eps of the storage dtype, as the kernels' callers pass it
        inv = jax.lax.rsqrt(1 / inv ** 2 - jcommon.eps_for(jnp.float32)
                            + jcommon.eps_for(dt))
        _close(got[2], inv, "float32", "inv")
    if mode == "in_copy":
        assert torch.equal(got[3], _t(x, tdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inner", [7, 128])
def test_ln_fwd_geglu_plain_matches_pallas_forward(dtype, inner):
    """The GEGLU mode's plain version against K8's Pallas forward."""
    npr = np.random.RandomState(8)
    dt = jnp.dtype(dtype)
    h = jnp.asarray(npr.randn(ROWS, 2 * inner), dt)
    g = jnp.asarray(1 + 0.1 * npr.randn(inner), dt)
    want = jff8.geglu_layernorm(h, g, None, 8, True)
    tdt = getattr(torch, dtype)
    got, = rk.ln_rows_plain("geglu", _t(h, tdt), _t(g, tdt))
    _close(got, want, dtype, "out")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_fwd_plain_from_fp32_rows(dtype):
    """The callers that normalise fp32 rows into the storage dtype (the FF
    block's inner LayerNorm, the megablock's out LayerNorm): the
    statistics of the fp32 rows with the storage dtype's eps, out rounded
    once, as JAX's `_common.ln_fp32` then a cast."""
    npr = np.random.RandomState(9)
    x = jnp.asarray(npr.randn(ROWS, 96), jnp.float32)
    g = jnp.asarray(1 + 0.1 * npr.randn(96), jnp.dtype(dtype))
    eps = jcommon.eps_for(jnp.dtype(dtype))
    want, _, _ = jcommon.ln_fp32(x, jnp.asarray(g, jnp.float32), eps)
    tdt = getattr(torch, dtype)
    for mode in ("stats", "in_copy"):
        got = rk.ln_rows_plain(mode, _t(x), _t(g, tdt))
        _close(got[0], jnp.asarray(want, jnp.dtype(dtype)), dtype, "out")
        if mode == "in_copy":
            assert torch.equal(got[3], _t(x).to(tdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu_k8_plain_matches_pallas_backward(dtype):
    npr = np.random.RandomState(2)
    dt = jnp.dtype(dtype)
    h = jnp.asarray(npr.randn(ROWS, 2 * INNER), dt)
    g = jnp.asarray(1 + 0.1 * npr.randn(INNER), dt)
    do = jnp.asarray(npr.randn(ROWS, INNER), dt)
    _, vjp = jax.vjp(lambda a, b: jff8.geglu_layernorm(a, b, None, 8, True),
                     h, g)
    want_dh, want_dg = vjp(do)
    tdt = getattr(torch, dtype)
    dh, part = rk.geglu_bwd_rows_plain("k8", _t(do, tdt), _t(h, tdt),
                                       _t(g, tdt))
    _close(dh, want_dh, dtype, "dh")
    # the Pallas kernel sums dg in fp32 and casts once to g's dtype
    _close(ordered_sum(part).to(tdt), want_dg, dtype, "dg")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("resid,xn_out", [(False, False), (True, False),
                                          (False, True), (True, True)])
@pytest.mark.parametrize("dy_f32", [True, False])
def test_ln_plain_matches_ln_bwd(dtype, resid, xn_out, dy_f32):
    npr = np.random.RandomState(3)
    dt = jnp.dtype(dtype)
    v = jnp.asarray(npr.randn(ROWS, DIM) * 2 + 0.5, dt)
    g = jnp.asarray(1 + 0.1 * npr.randn(DIM), dt)
    dy = jnp.asarray(npr.randn(ROWS, DIM), jnp.float32 if dy_f32 else dt)
    r = jnp.asarray(npr.randn(ROWS, DIM), dt)
    mean, inv = _stats(v.astype(jnp.float32))
    xhat = (v.astype(jnp.float32) - mean) * inv
    g32 = g.astype(jnp.float32)
    want_dx, want_dg = jcommon.ln_bwd(dy.astype(jnp.float32), xhat, inv, g32)
    want_out = (want_dx + r.astype(jnp.float32) if resid else want_dx)
    tdt = getattr(torch, dtype)
    out, xn, part = rk.ln_bwd_rows_plain(
        "ln", _t(dy, None if dy_f32 else tdt), _t(v, tdt), _t(g, tdt),
        (_t(mean[:, 0]), _t(inv[:, 0])), _t(r, tdt) if resid else None,
        xn_out)
    assert out.dtype == tdt and (xn is None) == (not xn_out)
    _close(out, want_out.astype(dt), dtype, "out")
    if xn_out:
        _close(xn, (xhat * g32).astype(dt), dtype, "xn")
    _close(ordered_sum(part), want_dg, "float32", "dg")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_geglu_plain_matches_p1_geglu_core(dtype):
    rows = 96  # pass 2 fed x = I takes dim = rows
    x, do, gpre, gin, win, wout = _ff_inputs(dtype, seed=4, rows=rows)
    mp, ip, h, dy = _h_dy(x, do, gpre, win, wout)
    prod32, gb32, agdb32 = _prod(h)
    mi, ii = _stats(prod32)
    dt = jnp.dtype(dtype)
    prod, gb, agdb = (t.astype(dt) for t in (prod32, gb32, agdb32))
    _, want_dprod, _, want_dg = jffb._p1_geglu_core(
        x, do, gpre, gin, win, wout, prod, gb, agdb, mp, ip, mi, ii)
    x2, do2, gpre2, zero, one = _eye_pass2(dtype, rows)
    want_da, want_db, want_yt = jffb._p2_geglu_core(
        x2, do2, gpre2, gin, prod, gb, agdb, want_dprod, mi, ii, zero, one)
    tdt = getattr(torch, dtype)
    dprod, dh, dh2, y2, part = rk.ln_bwd_rows_plain(
        "geglu", _t(dy), _t(prod, tdt), _t(gin, tdt),
        (_t(mi[:, 0]), _t(ii[:, 0])), gb=_t(gb, tdt), agdb=_t(agdb, tdt))
    _close(dprod, want_dprod, dtype, "dprod")
    _close(ordered_sum(part), want_dg, "float32", "dg")
    _close(dh2[:, :INNER], want_da, dtype, "dh2 a")
    _close(dh2[:, INNER:], want_db, dtype, "dh2 b")
    _close(y2, np.asarray(want_yt, np.float32).T, dtype, "y2")
    if dtype == "float32":  # dh, from the unrounded dprod, is dh2 there
        assert torch.equal(dh, dh2)


def _mode_call(kernel, mode, rows, seed):
    """A plain call of (kernel, mode) on `rows` seeded rows: a function of
    a row slice that returns the dg partials."""
    gen = torch.Generator().manual_seed(seed)
    d, bf = INNER, torch.bfloat16

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dtype)

    g = 1 + 0.1 * rand(d, dtype=bf)
    stats = (rand(rows), rand(rows).abs() + 0.5)
    if kernel == "geglu":
        h = rand(rows, 2 * d, dtype=torch.float32 if mode == "recompute"
                 else bf)
        dy = rand(rows, d, dtype=bf if mode == "k8" else torch.float32)
        return lambda s, e: rk.geglu_bwd_rows_plain(
            mode, dy[s:e], h[s:e], g, tuple(t[s:e] for t in stats))[-1]
    v, dy = rand(rows, d, dtype=bf), rand(rows, d)
    gb, agdb = rand(rows, d, dtype=bf), rand(rows, d, dtype=bf)
    return lambda s, e: rk.ln_bwd_rows_plain(
        mode, dy[s:e], v[s:e], g, tuple(t[s:e] for t in stats),
        gb=gb[s:e] if mode == "geglu" else None,
        agdb=agdb[s:e] if mode == "geglu" else None)[-1]


@pytest.mark.parametrize("kernel,mode", rk.COUNTERS)
def test_dg_partials_do_not_depend_on_the_chunking(kernel, mode):
    rows = 5 * 64 + 37
    call = _mode_call(kernel, mode, rows, seed=5)
    whole = call(0, rows)
    assert whole.shape == (rk.blocks(rows), INNER)
    for cuts in ((0, 64, rows), (0, 128, 320, rows), (0, 320, rows)):
        parts = torch.cat([call(s, e) for s, e in zip(cuts, cuts[1:])])
        assert torch.equal(parts, whole)
        assert torch.equal(ordered_sum(parts), ordered_sum(whole))


def test_partials_add_each_block_in_row_order():
    t = torch.randn(64 * 2 + 5, 8, dtype=torch.float32)
    part = rk.partials(t)
    assert part.shape == (3, 8)
    for b in range(3):
        want = t[64 * b].clone()
        for r in range(64 * b + 1, min(64 * (b + 1), t.shape[0])):
            want += t[r]
        assert torch.equal(part[b], want)


def _strict_sum(part, start=None):
    """numpy float32, one partial at a time, left to right (from `start`
    when given, else from part[0])."""
    part = part.numpy()
    total = part[0].copy() if start is None else start.numpy().copy()
    for p in part[0 if start is not None else 1:]:
        total = (total + p).astype(np.float32)
    return torch.from_numpy(total)


@pytest.mark.parametrize("parts,n", [(4097, 7), (1, 500), (384, 2048 + 7),
                                     (12, 4096 + 3)])
@pytest.mark.parametrize("acc", [0, 1, 2])
def test_reduce_parts_is_the_strict_ordered_sum(parts, n, acc):
    """`rows.reduce_parts` (its plain version here) at parts counts above
    any ring depth of the slab kernel and widths off its 4-, 8- and
    16-column slabs: bit for bit the strict left-to-right fp32 sum and
    `matmul.ordered_sum`, rounded once to bf16 (`acc` 0), written in fp32
    (1) or added to a running fp32 sum (2)."""
    gen = torch.Generator().manual_seed(parts + n)
    part = torch.randn(parts, n, generator=gen)
    if acc == 2:
        out = torch.randn(n, generator=gen)
        want = _strict_sum(part, out)
        got = rk.reduce_parts(part, out.clone())
    else:
        want = _strict_sum(part)
        assert torch.equal(ordered_sum(part), want)
        dtype = torch.bfloat16 if acc == 0 else torch.float32
        want = want.to(dtype)
        got = rk.reduce_parts(part, dtype=dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)
