"""The port's memory-lean training kernels against the JAX package's Pallas
kernels, on the CPU: K3 (the attention megablock's stats / qkv forwards
and recompute backward), K-FF-s with the FF block's recompute backward,
and K5 (the streaming log-sum-exp of the InfoNCE loss).

Each wrapper runs its kernel's plain version here. The forwards are held to
`_mega_fwd(..., store_qkv=False / "qkv", need_residuals=True)` and
`_ff_block_fwd(..., store_h=False)` (outputs, statistics, qkv), the
autograd Functions' gradients to `jax.grad` of `attention_block(...,
store_qkv=False / "qkv")`, of `ff_block(..., store_h=False)` under both
`XCLIP_FF_P2_FED=0` (self-contained pass 2) and `=1` (fed pass 2), and of
`streaming_lse`, all in Pallas interpret mode. Inputs come from a numpy
seed.

Tolerances: fp32 outputs and statistics 1e-4 absolute (summation order
only); fp32 gradients rtol 1e-3 with atol 1e-5 times the leaf's largest
magnitude (a dW is a sum over every row); bf16 two storage ulps of the
compared tensor's largest magnitude, since both sides round at the same
places and only summation order can flip a rounding. Chunked against
whole runs of the port: rtol 1e-5 with atol 1e-6 times the largest
magnitude (the dW and dg sums only change their order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.kernels import attention_megablock as jmega
from xclip_tpu.kernels import fused_ff_block as jff
from xclip_tpu.kernels import fused_infonce as jlse
from xclip_tpu_torch.kernels import attention_megablock as mega
from xclip_tpu_torch.kernels import fused_ff_block as ffb
from xclip_tpu_torch.kernels import fused_infonce as lse5
from xclip_tpu_torch.kernels._common import chunk_spans
from xclip_tpu_torch.objectives.contrastive import clip_contrastive_loss

from torch_port_inputs import ff_args, mega_args, to_np, to_torch
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")


def _ulps2(want):
    """Two bf16 ulps at the largest magnitude of `want`."""
    top = float(np.abs(want).max())
    return 2 * 2.0 ** (np.floor(np.log2(max(top, 2.0 ** -20))) - 7)


def _close(got, want, dtype, what=""):
    got, want = to_np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = 1e-4 if dtype == "float32" else _ulps2(want)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


def _close_grad(got, want, dtype, what=""):
    got, want = to_np(got), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * scale,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=_ulps2(want),
                                   err_msg=what)


def _close_sum_order(got, want):
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * scale)


def _cot(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------------ K3

def _mega_jax(args, dtype):
    return ([jnp.asarray(a, dtype) for a in args[:5]]
            + [jnp.asarray(args[5])])


@pytest.mark.parametrize("dtype,causal,mask_kind,keep_qkv", [
    ("float32", False, "keypad", False), ("float32", True, "dead", False),
    ("float32", False, "dead", True), ("bfloat16", True, "keypad", True)])
def test_attention_block_fwd_stats_matches_pallas(dtype, causal, mask_kind,
                                                  keep_qkv):
    b, n, heads = 2, 33, 2
    args = mega_args(n=n, dim=128, heads=heads, mask_kind=mask_kind)
    static = (heads, 64, 0.125, causal)
    out, (_, _, res) = jmega._mega_fwd(
        *_mega_jax(args, dtype), *static, True, True,
        "qkv" if keep_qkv else False, need_residuals=True)
    got_out, sm, ln, qkv = mega.attention_block_fwd_stats(
        *to_torch(args, getattr(torch, dtype)), *static, True, keep_qkv)
    _close(got_out, out, dtype, "out")
    # fp32 statistics of storage-dtype activations: in bf16 a flipped
    # rounding of qkv or attnout moves them, so bf16 takes two ulps
    stats = np.asarray(res[-1])                # (b, 2·heads + 4, n)
    want_sm = stats[:, :2 * heads].transpose(0, 2, 1).reshape(b * n, -1)
    want_ln = stats[:, 2 * heads:].transpose(1, 0, 2).reshape(4, b * n)
    if dtype == "float32":
        np.testing.assert_allclose(sm.numpy(), want_sm, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(ln.numpy(), want_ln, atol=1e-4, rtol=1e-5)
    else:
        _close(sm, want_sm, dtype, "sm")
        _close(ln, want_ln, dtype, "ln_stats")
    if keep_qkv:
        _close(qkv, np.asarray(res[0], np.float32).reshape(b * n, -1), dtype,
               "qkv")
    else:
        assert qkv is None and len(res) == 1


K3_GRAD_CASES = [  # (dtype, n, causal, mask_kind, keep_qkv)
    ("float32", 33, False, "keypad", False),
    ("float32", 70, True, "dead", False),
    ("float32", 33, False, "none", True),
    ("float32", 33, True, "keypad", True),
    ("bfloat16", 33, False, "keypad", False),
    ("bfloat16", 33, False, "dead", True),
]


@pytest.mark.parametrize("dtype,n,causal,mask_kind,keep_qkv", K3_GRAD_CASES)
def test_attention_block_recompute_grads_match_pallas(dtype, n, causal,
                                                      mask_kind, keep_qkv):
    heads = 2
    args = mega_args(n=n, dim=128, heads=heads, mask_kind=mask_kind)
    maybe_dead = mask_kind != "none"
    static = (heads, 64, 64 ** -0.5, causal)
    ja = _mega_jax(args, dtype)
    cot = _cot((2, n, 128))

    def f(*a):
        out = jmega.attention_block(*a, ja[5], *static, True, maybe_dead,
                                    "qkv" if keep_qkv else False)
        return jnp.sum(out.astype(jnp.float32) * cot)

    want = jax.grad(f, argnums=range(5))(*ja[:5])
    ta = to_torch(args, getattr(torch, dtype))
    tt = [t.requires_grad_(True) for t in ta[:5]]
    out = mega.attention_block_train_recompute(*tt, ta[5], *static,
                                               maybe_dead, keep_qkv)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    for name, t, w in zip(("x", "g_pre", "w_qkv", "w_out", "g_out"), tt,
                          want):
        assert t.grad.dtype == t.dtype
        _close_grad(t.grad, w, dtype, name)


@pytest.mark.parametrize("keep_qkv", [False, True])
def test_attention_block_recompute_chunks_match_whole(monkeypatch, keep_qkv):
    """The batch chunking the kernels take: at a bound of one element's
    forward scratch, three chunks of one element; the backward of the
    three chunks, summed in chunk order as the CUDA wrapper sums them,
    against the whole batch's."""
    b, n, dim = 3, 21, 64
    args = to_torch(mega_args(b=b, n=n, dim=dim, heads=1, mask_kind="dead")
                    [:5] + (np.ones((b, n), bool),), torch.float32)
    args[5][0, 15:] = False
    static = (1, 64, 0.125, True, True)
    _, sm, ln, qkv = mega.attention_block_fwd_stats(*args, *static, keep_qkv)
    do = torch.from_numpy(_cot((b, n, dim)))
    whole = mega.attention_block_bwd_recompute(*args, do, sm, ln, *static,
                                               qkv=qkv)
    monkeypatch.setattr(mega, "CHUNK_BYTES", sum(
        t.nbytes for t in mega._fwd_scratch(n, dim, 64, torch.float32, "meta",
                                            keep_qkv) if t is not None))
    spans = mega.fwd_stats_spans(b, n, dim, 1, torch.float32, keep_qkv)
    assert spans == [(0, 1), (1, 2), (2, 3)]
    dx, sums = torch.empty_like(args[0]), None
    for s, e in spans:
        r0, r1 = s * n, e * n
        dx[s:e], *parts = mega.attention_block_bwd_recompute(
            args[0][s:e], *args[1:5], args[5][s:e], do[s:e], sm[r0:r1],
            ln[:, r0:r1],
            *static, qkv=None if qkv is None else qkv[r0:r1])
        sums = parts if sums is None else [a + p for a, p in zip(sums, parts)]
    _close_sum_order([dx, *sums], whole)


@pytest.mark.parametrize("causal,mask_kind,keep_qkv", [
    (False, "keypad", False), (True, "dead", True)])
def test_attention_block_recompute_plain_matches_autograd(causal, mask_kind,
                                                          keep_qkv):
    """The plain recompute backward against autograd through the plain
    forward; a dead row passes no gradient to its scores."""
    ta = to_torch(mega_args(n=21, dim=64, heads=1, mask_kind=mask_kind),
                  torch.float32)
    tt = [t.requires_grad_(True) for t in ta[:5]]
    static = (1, 64, 0.125, causal, True)
    out, sm, ln, qkv = mega.attention_block_fwd_stats_plain(
        *tt, ta[5], *static, keep_qkv)
    do = torch.from_numpy(_cot(out.shape))
    want = torch.autograd.grad(out, tt, do)
    with torch.no_grad():
        got = mega.attention_block_bwd_recompute_plain(
            *tt, ta[5], do, sm, ln, *static,
            qkv=None if qkv is None else qkv.detach())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------- K-FF-s, recompute FF

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ff_block_fwd_stats_matches_pallas(dtype):
    rows = 70
    args = ff_args(R=rows, D=64, I=128)
    out, res = jff._ff_block_fwd(*(jnp.asarray(a, dtype) for a in args),
                                 256, 512, True, False)
    (stats,) = res[5]
    stats = np.asarray(stats)
    stats = stats if stats.shape[0] == 4 else stats.T   # Pallas layouts
    got_out, got_stats = ffb.ff_block_fwd_stats(
        *to_torch(args, getattr(torch, dtype)))
    _close(got_out, out, dtype, "out")
    np.testing.assert_allclose(got_stats.numpy(), stats[:, :rows], atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("fed", ["0", "1"])
@pytest.mark.parametrize("dtype,rows,dim,inner", [
    ("float32", 70, 64, 128), ("float32", 33, 128, 256),
    ("bfloat16", 70, 64, 128)])
def test_ff_block_recompute_grads_match_pallas(monkeypatch, fed, dtype, rows,
                                               dim, inner):
    """Both Pallas recompute backwards (self-contained and fed pass 2)
    compute the same gradients; the port's one design matches each."""
    monkeypatch.setenv("XCLIP_FF_P2_FED", fed)
    args = ff_args(R=rows, D=dim, I=inner)
    ja = [jnp.asarray(a, dtype) for a in args]
    cot = _cot((rows, dim))

    def f(*a):
        out = jff.ff_block(*a, 256, 512, True, False)
        return jnp.sum(out.astype(jnp.float32) * cot)

    want = jax.grad(f, argnums=range(5))(*ja)
    tt = [t.requires_grad_(True) for t in to_torch(args,
                                                    getattr(torch, dtype))]
    out = ffb.ff_block_train_recompute(*tt)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    for name, t, w in zip(("x", "g_pre", "w_in", "g_inner", "w_out"), tt,
                          want):
        assert t.grad.dtype == t.dtype
        _close_grad(t.grad, w, dtype, name)


def test_ff_block_recompute_chunks_match_whole():
    """The row chunking the backward kernel takes: `chunk_spans` at a
    bound of one ROW_BLOCK's workspace (a per-row part and a fixed one, as
    the CUDA query counts) cuts 2·ROW_BLOCK + 301 rows in three, the last
    ragged; the backward of the three chunks, summed in chunk order as the
    CUDA wrapper sums them, against the whole."""
    rows = 2 * ffb.ROW_BLOCK + 301
    args = to_torch(ff_args(R=rows, D=64, I=128), torch.float32)
    _, stats = ffb.ff_block_fwd_stats(*args)
    do = torch.from_numpy(_cot((rows, 64)))
    whole = ffb.ff_block_bwd_recompute(*args, do, stats)

    def nbytes(k):
        return 3000 * k + 65536

    spans = chunk_spans(rows, nbytes, nbytes(ffb.ROW_BLOCK), ffb.ROW_BLOCK)
    assert spans == [(0, ffb.ROW_BLOCK), (ffb.ROW_BLOCK, 2 * ffb.ROW_BLOCK),
                     (2 * ffb.ROW_BLOCK, rows)]
    dx, sums = torch.empty_like(args[0]), None
    for s, e in spans:
        dx[s:e], *parts = ffb.ff_block_bwd_recompute(
            args[0][s:e], *args[1:], do[s:e], stats[:, s:e])
        sums = parts if sums is None else [a + p for a, p in zip(sums, parts)]
    _close_sum_order([dx, *sums], whole)


def test_ff_block_recompute_plain_matches_autograd():
    tt = [t.requires_grad_(True) for t in to_torch(ff_args(R=37),
                                                    torch.float32)]
    out, stats = ffb.ff_block_fwd_stats_plain(*tt)
    do = torch.from_numpy(_cot(out.shape))
    want = torch.autograd.grad(out, tt, do)
    with torch.no_grad():
        got = ffb.ff_block_bwd_recompute_plain(*tt, do, stats.detach())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ K5

def _lse_args(R, C, d, seed=0):
    npr = np.random.RandomState(seed)
    x = npr.randn(R, d).astype(np.float32)
    y = npr.randn(C, d).astype(np.float32)
    x = 10 * x / np.linalg.norm(x, axis=-1, keepdims=True)
    return x, y / np.linalg.norm(y, axis=-1, keepdims=True)


@pytest.mark.parametrize("R,C,decoupled,row_offset", [
    (37, 300, False, 0), (37, 300, True, 0), (37, 300, True, 5),
    (24, 24, True, 0)])
def test_streaming_lse_matches_pallas(R, C, decoupled, row_offset):
    x, y = _lse_args(R, C, 64)
    cot = _cot((R,), seed=2)

    def f(a, b):
        return jnp.sum(jlse.streaming_lse(a, b, row_offset, decoupled) * cot)

    want_lse = jlse.streaming_lse(jnp.asarray(x), jnp.asarray(y), row_offset,
                                  decoupled)
    want_dx, want_dy = jax.grad(f, argnums=(0, 1))(jnp.asarray(x),
                                                   jnp.asarray(y))
    tx, ty = (torch.from_numpy(a).requires_grad_(True) for a in (x, y))
    lse = lse5.streaming_lse(tx, ty, row_offset, decoupled)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want_lse),
                               atol=1e-4, rtol=0)
    (lse * torch.from_numpy(cot)).sum().backward()
    _close_grad(tx.grad, want_dx, "float32", "dx")
    _close_grad(ty.grad, want_dy, "float32", "dy")


def _ordered_bwd(x, y, lse, dlse, row_offset, decoupled, plan):
    """The CUDA backward's decomposition (`csrc/fused_infonce.cu`
    xclip_lse_bwd) in PyTorch: per chunk of cc columns, p = exp(x·yᵀ −
    lse) (0 on the DCL diagonal), dx's product over column ranges of kx
    and dy's over row ranges of ky, each range a partial added in order
    from zero (dx from its running sum after the first chunk), dx scaled
    by dlse after the last chunk."""
    cc, kx, ky = plan
    R, C = x.shape[0], y.shape[0]
    dx, dy = torch.zeros_like(x), torch.empty_like(y)
    xw = x * dlse[:, None]
    for c0 in range(0, C, cc):
        n = min(cc, C - c0)
        p = torch.exp(x @ y[c0:c0 + n].T - lse[:, None])
        if decoupled:
            diag = (torch.arange(c0, c0 + n)[None]
                    == torch.arange(R)[:, None] + row_offset)
            p = torch.where(diag, 0.0, p)
        acc = dx if c0 else torch.zeros_like(dx)
        for k in range(0, n, kx):
            acc = acc + p[:, k:k + kx] @ y[c0 + k:c0 + min(k + kx, n)]
        dx = acc * dlse[:, None] if c0 + n == C else acc
        part = torch.zeros(n, x.shape[1])
        for k in range(0, R, ky):
            part = part + p[k:k + ky].T @ xw[k:k + ky]
        dy[c0:c0 + n] = part
    return dx, dy


@pytest.mark.parametrize("R,C,d,row_offset,decoupled", [
    (37, 300, 64, 5, True), (300, 37, 64, 0, True), (37, 300, 1100, 0, False),
    (24, 24, 1100, 0, True), (45, 130, 64, 3, True)])
@pytest.mark.parametrize("forced", [False, True])
def test_streaming_lse_ordered_partials_match(R, C, d, row_offset, decoupled,
                                              forced):
    """K5's backward as the CUDA kernels decompose it (chunks of columns,
    ranges of the reductions, partials summed in order), with the wrapper's
    plan or one forced to several chunks and ranges, against the dense
    plain backward and JAX's `_lse_backward` in interpret mode."""
    x, y = _lse_args(R, C, d, seed=4)
    cot = _cot((R,), seed=6)
    tx, ty, dlse = (torch.from_numpy(a) for a in (x, y, cot))
    lse = lse5.streaming_lse_fwd_plain(tx, ty, row_offset, decoupled)
    plan = lse5.bwd_plan(R, C, d)
    assert plan[0] <= C and plan[1] % lse5.SLICE == plan[2] % lse5.SLICE == 0
    if forced:
        plan = (max(1, C // 3), 16, 8)
    got = _ordered_bwd(tx, ty, lse, dlse, row_offset, decoupled, plan)
    plain = lse5.streaming_lse_bwd_plain(tx, ty, lse, dlse, row_offset,
                                         decoupled)
    _close_sum_order(got, plain)

    def f(a, b):
        return jnp.sum(jlse.streaming_lse(a, b, row_offset, decoupled) * cot)

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    _close_grad(got[0], want[0], "float32", "dx")
    _close_grad(got[1], want[1], "float32", "dy")


def test_streaming_lse_bwd_plan_fills_the_card():
    """At the b = 2048 step's (2048, 2048, 512), the plan computes p once
    for every column and gives each backward product 4 ranges of 128 x 128
    tiles: 256 blocks, two an SM on 132 SMs; at a row shard of a gathered
    32k batch, chunks of columns keep p under 64 MiB."""
    assert lse5.bwd_plan(2048, 2048, 512) == (2048, 512, 512)
    cc, _, _ = lse5.bwd_plan(2048, 32768, 512)
    assert 2048 * cc * 4 <= lse5.P_BYTES and cc % lse5.TILE == 0


def test_streaming_lse_plain_matches_autograd():
    x, y = (torch.from_numpy(a).requires_grad_(True)
            for a in _lse_args(9, 13, 16, seed=3))
    lse = lse5.streaming_lse_fwd_plain(x, y, 2, True)
    dlse = torch.from_numpy(_cot((9,)))
    want = torch.autograd.grad(lse, (x, y), dlse)
    with torch.no_grad():
        got = lse5.streaming_lse_bwd_plain(x, y, lse, dlse, 2, True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("decoupled,extra", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_fused_infonce_matches_dense(decoupled, extra):
    """`loss_impl='fused'` against the dense InfoNCE on the same latents:
    the loss and the gradients of every latent and of the temperature."""
    npr = np.random.RandomState(4)
    lats = [npr.randn(6, 32).astype(np.float32) for _ in range(4)]
    lats = [a / np.linalg.norm(a, axis=-1, keepdims=True) for a in lats]
    results = []
    for impl in ("xla", "fused"):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in lats]
        temp = torch.tensor(np.exp(1.5), requires_grad=True)
        views = [t[None] for t in ts]       # one view a side: (1, b, d)
        (loss,), _ = clip_contrastive_loss(
            views[0], views[1], temp,
            decoupled_contrastive_learning=decoupled,
            text_latents_extra=views[2] if extra else None,
            image_latents_extra=views[3] if extra else None, loss_impl=impl)
        grads = torch.autograd.grad(loss, ts[:2 + 2 * extra] + [temp])
        results.append((loss, grads))
    (want, want_g), (got, got_g) = results
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)


def test_lean_wrappers_on_cpu_are_plain_and_uncounted():
    counters = (ffb.ff_block_fwd_stats, ffb.ff_block_bwd_recompute,
                mega.attention_block_fwd_stats,
                mega.attention_block_bwd_recompute, lse5.streaming_lse_fwd,
                lse5.streaming_lse_bwd)
    before = [fn.launches for fn in counters]
    args = to_torch(ff_args(R=9), torch.float32)
    out, stats = ffb.ff_block_fwd_stats(*args)
    ffb.ff_block_bwd_recompute(*args, torch.ones_like(out), stats)
    margs = to_torch(mega_args(n=9, dim=64, heads=1), torch.float32)
    out, sm, ln, qkv = mega.attention_block_fwd_stats(*margs, 1, 64, 0.125)
    mega.attention_block_bwd_recompute(*margs, torch.ones_like(out), sm, ln,
                                       1, 64, 0.125)
    x, y = map(torch.from_numpy, _lse_args(5, 7, 8))
    lse = lse5.streaming_lse_fwd(x, y)
    lse5.streaming_lse_bwd(x, y, lse, torch.ones_like(lse))
    assert [fn.launches for fn in counters] == before
    args[2] = args[2].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        ffb.ff_block_fwd_stats(*args)
