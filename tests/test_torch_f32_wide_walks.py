"""The fp32 attention core's split-head walk at heads of 128
(`csrc/attention_core.cuh`, NH = 2), on the CPU.

At heads of 128 a block of the fp32 kernels is two 256-thread halves, each
owning one 64-column half of the head. The CUDA kernels run only on the
card; these tests pin their arithmetic with PyTorch models of it, on the
walks and cuts of tests/test_torch_f32_walks.py:

* the forward: each half computes its partial scores over its own 64
  columns; the two are summed through the exchange tiles as s0 + s1 in
  either half (fp32 addition commutes, so both halves hold the same
  bits), so both form the same running max, sum and p, and each half
  keeps only its own 64 columns of o. The model gives the plain versions'
  outputs within 1e-5, and the JAX package's Pallas forwards in
  interpret mode within 1e-5: K6's `_attention_fwd`, the megablock's
  `_mega_fwd` and K7's `_flash_forward`;
* the backward: the dq kernel's half 0 makes s and half 1 dp, each over
  the whole head, and ds is formed once; the dk/dv kernel's half 0 makes
  p and half 1 dpᵀ, and ds is formed once. Each half keeps its own
  columns of dq = ds · k, dk = dsᵀ · q and dv = pᵀ · do. With p and ds
  kept only on the pairs the walks and cuts reach, the model gives the
  plain versions' gradients within 1e-4 in every mode (the megablock's,
  K6's with dead rows, K7's), and JAX's `flash_attention` gradients in
  interpret mode within 1e-4.

Tolerances as tests/test_torch_f32_walks.py: outputs 1e-5 (summation
order only), gradients 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.kernels import attention_block as jcore
from xclip_tpu.kernels import attention_megablock as jmega
from xclip_tpu.kernels import flash_attention as jflash
from xclip_tpu_torch.kernels import attention_block as core
from xclip_tpu_torch.kernels import attention_megablock as mega
from xclip_tpu_torch.kernels import flash_attention as flash

from test_torch_f32_walks import _k7_scores, _nonzero_p, _walk
from test_torch_megablock_core import _f32_cuts, _mask
from torch_port_inputs import core_args, flash_args, mega_args
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

HEADS, D = 2, 128
SCALE = D ** -0.5
HALVES = (slice(0, 64), slice(64, 128))   # the block's two column halves
NEG_INF = float("-inf")


def _split_fwd(q, k, v, partial, mask, causal, maybe_dead, scale):
    """The forward at heads of 128 on q, k, v (b, H, n, 128): the halves'
    partial scores `partial(q_h, k_h)` summed (s0 + s1), scaled, and the
    walk of each half over the same scores with its own 64 columns of v →
    (out (b, H, n, 128), m, l (b, H, n), the pairs computed). Both halves'
    m and l are the same bits."""
    parts = [partial(q[..., h], k[..., h]) for h in HALVES]
    scores = (parts[0] + parts[1]) * scale
    walks = [_walk(q, k, v[..., h], scores, mask, causal, maybe_dead)
             for h in HALVES]
    (_, m, l, computed), (_, m1, l1, _) = walks
    assert torch.equal(m, m1) and torch.equal(l, l1)
    return torch.cat([w[0] for w in walks], -1), m, l, computed


def _fused_fwd(qkv, mask, causal, maybe_dead):
    """The split forward on the fused qkv (the megablock's and K6's modes)
    → (out (b, n, H·128), m and l (b, n, H), the pairs computed)."""
    b, n, _ = qkv.shape
    hd = HEADS * D
    q, k, v = (mega._heads(qkv[..., i * hd:(i + 1) * hd], b, n, HEADS, D)
               for i in range(3))
    out, m, l, computed = _split_fwd(q, k, v,
                                     lambda a, c: a @ c.transpose(-1, -2),
                                     mask, causal, maybe_dead, SCALE)
    out = out.transpose(1, 2).reshape(b, n, hd)
    return out, m.transpose(1, 2), l.transpose(1, 2), computed


def _k7_fwd(q, k, v, mask, causal):
    """The split forward in K7's mode on (bh, n, 128) q (pre-scaled), k, v:
    scale 1, no dead-row rule → (out, lse = m_safe + log l, the pairs
    computed)."""
    out, m, l, computed = _split_fwd(q[:, None], k[:, None], v[:, None],
                                     lambda a, c: _k7_scores(a[:, 0],
                                                             c[:, 0])[:, None],
                                     mask, causal, False, 1.0)
    m, l = m[:, 0], l[:, 0]
    lse = torch.where(m == NEG_INF, 0.0, m) + torch.log(l)
    return out[:, 0], lse, computed


def _split_grads(q, k, v, do, p, ds, mask, causal, maybe_dead):
    """The backward at heads of 128 on (b, H, n, 128) q, k, v, do and p, ds
    (b, H, n, n) formed once over the whole head: p and ds kept on the
    pairs each kernel reaches (the dq kernel's ds; the dk/dv kernel's p and
    ds), and each half's own columns of dq = ds · k, dk = dsᵀ · q, dv = pᵀ ·
    do → (dq, dk, dv)."""
    n = q.shape[2]
    dq_map, dkv_map = (c[:, None, :n, :n] for c in _f32_cuts(
        mask, causal, maybe_dead))
    zero = torch.zeros(())
    ds_q = torch.where(dq_map, ds, zero)
    ds_k, p_k = (torch.where(dkv_map, t, zero) for t in (ds, p))
    return tuple(torch.cat([flash.dot32(a, b[..., h]) for h in HALVES], -1)
                 for a, b in ((ds_q, k), (ds_k.transpose(-1, -2), q),
                              (p_k.transpose(-1, -2), do)))


def test_split_scores_are_the_same_bits_in_both_halves():
    """Each half adds the other's partial scores to its own: s0 + s1 in
    half 0, s1 + s0 in half 1, the same fp32 bits (addition commutes), so
    both halves form the same row max, sum and p."""
    gen = torch.Generator().manual_seed(0)
    q, k = (torch.randn(4, 64, D, generator=gen) for _ in range(2))
    s0, s1 = (q[..., h] @ k[..., h].transpose(-1, -2) for h in HALVES)
    assert torch.equal(s0 + s1, s1 + s0)
    torch.testing.assert_close(s0 + s1, q @ k.transpose(-1, -2), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind,n", [("none", 33), ("keypad", 200),
                                    ("holes", 257), ("dead", 257),
                                    ("all", 200)])
def test_wide_forward_walk_matches_plain(causal, kind, n):
    """The split forward (the megablock's and K6's modes) computes every
    score a nonzero p needs and gives the plain versions' outputs (1e-5),
    m (1e-5: the halves' sum rounds apart from one chain) and l (1e-5
    relative); a dead row's m is 0 and its l n."""
    maybe_dead = kind != "none"
    qkv, _, _ = core_args(b=4, n=n, heads=HEADS, dim_head=D)
    qkv = torch.from_numpy(qkv)
    mask = torch.from_numpy(_mask(4, n, kind))
    out, m, l, computed = _fused_fwd(qkv, mask, causal, maybe_dead)
    assert not (_nonzero_p(mask, causal, maybe_dead)
                & ~computed[:, :n, :n]).any()
    attnout, sm = mega.mega_core_fwd_plain(qkv, mask, HEADS, D, SCALE,
                                           causal, maybe_dead)
    torch.testing.assert_close(out, attnout, atol=1e-5, rtol=0)
    torch.testing.assert_close(m, sm[..., :HEADS], atol=1e-5, rtol=0)
    torch.testing.assert_close(l, sm[..., HEADS:], atol=0, rtol=1e-5)
    k6_out, lse = core.attention_core_fwd_plain(qkv, mask, HEADS, D, SCALE,
                                                causal, maybe_dead)
    torch.testing.assert_close(out, k6_out, atol=1e-5, rtol=0)
    torch.testing.assert_close(m + torch.log(l), lse, atol=1e-5, rtol=0)
    if kind in ("dead", "all"):
        assert not m[-1].any()
        assert torch.equal(l[-1], torch.full((n, HEADS), float(n)))


@pytest.mark.parametrize("causal,kind", [(False, "keypad"), (True, "holes"),
                                         (True, "all"), (False, "none")])
def test_wide_forward_walk_matches_pallas(causal, kind):
    """The split forward against the JAX package's Pallas forwards in
    interpret mode at heads of 128: K6's `_attention_fwd` (out, lse) on
    the same qkv, and the megablock's `_mega_fwd` (attnout, m, l) on its
    own stored qkv (1e-5)."""
    n, maybe_dead = 130, kind != "none"
    qkv, _, _ = core_args(b=4, n=n, heads=HEADS, dim_head=D)
    mask = _mask(4, n, kind)
    want, res = jcore._attention_fwd(jnp.asarray(qkv), jnp.asarray(mask),
                                     HEADS, D, SCALE, causal, True,
                                     maybe_dead)
    out, m, l, _ = _fused_fwd(torch.from_numpy(qkv), torch.from_numpy(mask),
                              causal, maybe_dead)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # K6's lse: one head a group at 128, (groups, b, n_pad, 1)
    lse = np.asarray(res[3])[..., 0].transpose(1, 2, 0)[:, :n]
    np.testing.assert_allclose((m + torch.log(l)).numpy(), lse, atol=1e-5,
                               rtol=0)
    args = mega_args(b=4, n=n, dim=128, heads=HEADS, dim_head=D)
    ja = [jnp.asarray(a) for a in args[:5]] + [jnp.asarray(mask)]
    _, (_, _, (jqkv, attnout, _, stats)) = jmega._mega_fwd(
        *ja, HEADS, D, SCALE, causal, True, maybe_dead, True)
    out, m, l, _ = _fused_fwd(torch.from_numpy(np.array(jqkv, np.float32)),
                              torch.from_numpy(mask), causal, maybe_dead)
    np.testing.assert_allclose(out.numpy(), np.asarray(attnout), atol=1e-5,
                               rtol=0)
    stats = np.asarray(stats)[:, :2 * HEADS].transpose(0, 2, 1)
    np.testing.assert_allclose(m.numpy(), stats[..., :HEADS], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), stats[..., HEADS:], atol=1e-5,
                               rtol=1e-5)


def _k7_inputs(n, kind):
    """(bh, n, 128) q (pre-scaled), k, v at b·h 4 and the (4, n) mask of
    `kind` ("holes", or "all": the last row all masked too)."""
    q, k, v, _, _ = flash_args(b=4, h=1, n=n, d=D)
    return [torch.from_numpy(t[:, 0]) for t in (q, k, v)], torch.from_numpy(
        _mask(4, n, kind))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["holes", "all"])
def test_k7_wide_forward_walk_matches_plain(causal, kind):
    """K7's mode of the split forward, at n = 640 (ten key tiles, the
    holes whole masked tiles): its walk reaches every score a nonzero p
    needs, and it gives `flash_attention_fwd_plain`'s out and lse (1e-5);
    a row with no valid key gives out 0 and lse log 1e-30."""
    n = 640
    (q, k, v), mask = _k7_inputs(n, kind)
    out, lse, computed = _k7_fwd(q, k, v, mask, causal)
    assert not (_nonzero_p(mask, causal, False) & ~computed).any()
    want_out, want_lse = flash.flash_attention_fwd_plain(q, k, v, mask,
                                                         causal)
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
    none = ~flash._valid(mask, n, 0, n, causal).any(-1).expand(-1, n)
    assert none[-1].all() == (kind == "all")
    assert not out[none].any()
    assert torch.equal(lse[none], torch.full_like(
        lse[none], float(torch.log(torch.tensor(1e-30)))))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["holes", "all"])
def test_k7_wide_forward_walk_matches_pallas(causal, kind):
    """K7's split forward against the JAX package's Pallas
    `_flash_forward` in interpret mode with 64-key blocks, at n = 256 and
    heads of 128: out and lse within 1e-5."""
    n = 256
    flat, mask = _k7_inputs(n, kind)
    want_out, want_lse = jflash._flash_forward(
        *(jnp.asarray(t.numpy()) for t in flat),
        jnp.asarray(mask.numpy().reshape(4, 1, n).astype(np.int32)), causal,
        64, 64, True)
    out, lse, _ = _k7_fwd(*flat, mask, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["mega", "k6"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["keypad", "holes", "all"])
def test_wide_walked_gradients_match_plain(mode, causal, kind):
    """The split backward in the megablock's mode (p = (dead ? 1 : e^(s −
    m)) / l, the scale on do) and K6's (p = e^(s − lse), 1/n on a dead
    row, the scale on ds), at (4, 257, 2 heads of 128) with dead rows:
    each half's columns of dq, dk, dv from p and ds formed once and kept
    on the pairs the walks reach give the plain version's dqkv (1e-4)."""
    b, n = 4, 257
    qkv, _, do = core_args(b=b, n=n, heads=HEADS, dim_head=D)
    qkv, do = torch.from_numpy(qkv), torch.from_numpy(do)
    mask = torch.from_numpy(_mask(b, n, kind))
    static = (HEADS, D, SCALE, causal, True)
    hd = HEADS * D
    q, k, v = (mega._heads(qkv[..., i * hd:(i + 1) * hd], b, n, HEADS, D)
               for i in range(3))
    do_h = mega._heads(do, b, n, HEADS, D)
    s, dead = mega._softmax_parts(q, k, mask, SCALE, causal, True)
    if mode == "mega":
        out, sm = mega.mega_core_fwd_plain(qkv, mask, *static)
        m, l = (sm[..., i * HEADS:(i + 1) * HEADS].permute(0, 2, 1)[..., None]
                for i in range(2))
        p = torch.where(dead, 1.0, torch.exp(s - m)) / l
        delta = (do_h * mega._heads(out, b, n, HEADS, D) * SCALE).sum(
            -1, keepdim=True)
        ds = p * (flash.dot32(do_h * SCALE, v.transpose(-1, -2)) - delta)
        want = mega.mega_core_bwd_plain(qkv, mask, do, out, sm, *static)
    else:
        out, lse = core.attention_core_fwd_plain(qkv, mask, *static)
        p = torch.where(dead, 1.0 / n,
                        torch.exp(s - lse.transpose(1, 2)[..., None]))
        delta = (do_h * mega._heads(out, b, n, HEADS, D)).sum(-1,
                                                              keepdim=True)
        ds = p * (flash.dot32(do_h, v.transpose(-1, -2)) - delta) * SCALE
        want = core.attention_core_bwd_plain(qkv, mask, out, lse, do,
                                             *static)
    ds = torch.where(dead, 0.0, ds)
    grads = _split_grads(q, k, v, do_h, p, ds, mask, causal, True)
    got = torch.cat([t.transpose(1, 2).reshape(b, n, hd) for t in grads], -1)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["holes", "all"])
def test_k7_wide_walked_gradients_match_pallas(causal, kind):
    """K7's split backward at heads of 128 (no dead-row rule), at n = 200
    (four tiles after padding): each half's columns of dq, dk, dv from p
    and ds formed once and kept on the pairs the walks reach give the plain
    version's gradients and JAX's `flash_attention` gradients of a sum of
    squares (interpret mode) within 1e-4."""
    b, h, n = 3, 2, 200
    q, k, v, mask, _ = flash_args(b=b, h=h, n=n, mask_kind="holes", d=D)
    mask[-1] = mask[-1] & (kind != "all")
    (qf, kf, vf), mask_bh = flash.pad_flat(
        [torch.from_numpy(t) for t in (q, k, v)], torch.from_numpy(mask))
    out, lse = flash.flash_attention_fwd_plain(qf, kf, vf, mask_bh, causal)
    n_pad = qf.shape[1]
    do = torch.zeros_like(out)
    do[:, :n] = 2 * out[:, :n]   # d(sum out²) on the real rows
    delta = (do * out).sum(-1, keepdim=True)
    valid = flash._valid(mask_bh, n_pad, 0, n_pad, causal)
    p = torch.where(valid, torch.exp(flash.dot32(qf, kf.transpose(-1, -2))
                                     - lse[..., None]), 0.0)
    ds = p * (flash.dot32(do, vf.transpose(-1, -2)) - delta)
    grads = [g[:, 0] for g in _split_grads(
        *(t[:, None] for t in (qf, kf, vf, do, p, ds)), mask_bh, causal,
        False)]
    plain = flash.flash_attention_bwd_plain(qf, kf, vf, mask_bh, out, lse,
                                            do, causal)
    for got, want in zip(grads, plain):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)

    def f(*a):
        return jflash.flash_attention(*a, mask=jnp.asarray(mask),
                                      causal=causal, interpret=True)

    want = jax.grad(lambda *a: jnp.sum(f(*a) ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(t) for t in (q, k, v)))
    for got, w in zip(grads, want):
        got = got.reshape(b, h, n_pad, D)[:, :, :n]
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)
