"""The fp32 attention core's walks (`csrc/attention_core.cuh`), on the CPU.

The CUDA kernels run only on the card; these tests pin what their design
rests on, with PyTorch models of the walks:

* the forward: one block per (batch element, head, 64-query tile) walks
  the key tiles up to the causal diagonal that hold a valid key (every
  tile for a block holding a dead row); a warp of 8 query rows computes
  the scores of its keys in groups of 16 up to the tile's last valid key
  and, causal, its last row (every real key for a warp holding a dead
  row), and folds them into each row's running max m and sum l in the
  kernel's order (o and l rescaled by e^(m_old - m_new) when m grows; a
  dead row's m is 0 and its p 1), dividing by l once at the end. On the
  plain versions' scores the model gives their outputs within 1e-5 and
  their m bit for bit (the skipped tiles hold no valid key), and the JAX
  package's Pallas forwards (interpret mode) within 1e-5: K6's
  `_attention_fwd` and the megablock's `_mega_fwd`;
* K7's fp32 backward, the core's kernels in their K7 mode (no dead-row
  rule): their walks and cuts cover every (query, key) pair with a
  nonzero p at n = 2304, past the 2048 the core's other modes take; and
  the gradients with p and ds kept only where the walks reach are the
  plain version's bit for bit and JAX's `flash_attention` gradients
  within 1e-4.

Tolerances as tests/test_torch_attention_cores.py: outputs 1e-5
(summation order only), gradients 1e-4.
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

from test_torch_megablock_core import _f32_cuts, _mask, _tile_bits, _walks
from torch_port_inputs import core_args, flash_args, mega_args

jax.config.update("jax_default_matmul_precision", "highest")

HEADS = 2
WARP_ROWS, GROUP = 8, 16   # the forward's warp: 8 query rows; key groups
NEG_INF = float("-inf")


def _fwd_walk(qkv, mask, scale, causal, maybe_dead):
    """The fp32 forward kernel's arithmetic over its walk, block by block
    in its order → (out (b, n, HEADS·64), m and l (b, n, HEADS), the (b, N,
    N) map of the (query, key) pairs whose scores it computes, N the
    padded length)."""
    b, n, _ = qkv.shape
    hd = HEADS * 64
    q, k, v = (mega._heads(qkv[..., i * hd:(i + 1) * hd], b, n, HEADS, 64)
               for i in range(3))
    # the scores as the plain versions take them (the kernel's are FMA
    # chains in column order: the same values up to summation order)
    scores = (q @ k.transpose(-1, -2)) * scale
    size = 64 * -(-n // 64)
    _, first = _tile_bits(mask)
    walk = _walks(mask, causal, maybe_dead)[0]
    out = torch.zeros(b, HEADS, n, 64)
    m_all = torch.full((b, HEADS, n), NEG_INF)
    l_all = torch.zeros(b, HEADS, n)
    computed = torch.zeros(b, size, size, dtype=torch.bool)
    for (bi, t), us in walk.items():
        fv = int(first[bi])
        dead_end = ((min(fv, n) if causal else (n if fv >= n else 0))
                    if maybe_dead else 0)
        q0 = 64 * t
        rows = torch.arange(q0, min(n, q0 + 64))
        dead = (rows < dead_end)[:, None]
        m = torch.full((HEADS, len(rows)), NEG_INF)
        l = torch.zeros(HEADS, len(rows))
        o = torch.zeros(HEADS, len(rows), 64)
        for u in us:
            keys = torch.arange(64 * u, min(n, 64 * u + 64))
            in_tile = mask[bi, keys].nonzero()
            last = int(in_tile.max()) + 1 if len(in_tile) else 0
            comp = torch.zeros(len(rows), len(keys), dtype=torch.bool)
            for w0 in range(0, len(rows), WARP_ROWS):
                r0 = q0 + w0
                kend = min(n, r0 + WARP_ROWS) if causal else n
                cols = (min(64, n - 64 * u) if r0 < dead_end
                        else min(kend - 64 * u, last) if last else 0)
                if cols > 0:
                    comp[w0:w0 + WARP_ROWS, :-(-cols // GROUP) * GROUP] = True
            valid = torch.where(
                dead, keys[None] < n,
                mask[bi, keys][None] & ~(causal & (keys[None] > rows[:, None])))
            use = comp & valid
            x = scores[bi][:, rows][:, :, keys]
            x = torch.where(use, torch.where(dead, 0.0, x), NEG_INF)
            mn = torch.maximum(m, x.amax(-1))
            corr = torch.where(mn == m, 1.0, torch.exp(m - mn))
            p = torch.where(use, torch.where(dead, 1.0,
                                             torch.exp(x - mn[..., None])),
                            0.0)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + p @ v[bi][:, keys]
            m = mn
            computed[bi, q0:q0 + len(rows), 64 * u:64 * u + len(keys)] |= comp
        l = l.clamp_min(1e-30)
        out[bi, :, rows] = o / l[..., None]
        m_all[bi, :, rows], l_all[bi, :, rows] = m, l
    out = out.transpose(1, 2).reshape(b, n, hd)
    return out, m_all.transpose(1, 2), l_all.transpose(1, 2), computed


def _nonzero_p(mask, causal, maybe_dead):
    """(b, n, n): the (query, key) pairs with a nonzero p (a dead row's on
    every key)."""
    b, n = mask.shape
    valid = mask[:, None, :].expand(b, n, n).clone()
    if causal:
        valid &= torch.ones(n, n, dtype=torch.bool).tril()
    if maybe_dead:
        dead = ~valid.any(-1, keepdim=True)
        valid |= dead
    return valid


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind,n", [("none", 33), ("none", 130),
                                    ("keypad", 200), ("holes", 257),
                                    ("dead", 257), ("all", 200)])
def test_f32_forward_walk_matches_plain(causal, kind, n):
    """The forward's walk and cuts compute every score a nonzero p needs,
    and its online softmax gives the plain versions' outputs (1e-5), their
    m bit for bit (the skipped tiles hold no valid key) and their l
    (1e-5 relative): the megablock's (m, l) and K6's lse."""
    maybe_dead = kind != "none"
    qkv, _, _ = core_args(b=4, n=n, heads=HEADS)
    qkv = torch.from_numpy(qkv)
    mask = torch.from_numpy(_mask(4, n, kind))
    out, m, l, computed = _fwd_walk(qkv, mask, 0.125, causal, maybe_dead)
    assert not (_nonzero_p(mask, causal, maybe_dead)
                & ~computed[:, :n, :n]).any()
    attnout, sm = mega.mega_core_fwd_plain(qkv, mask, HEADS, 64, 0.125,
                                           causal, maybe_dead)
    torch.testing.assert_close(out, attnout, atol=1e-5, rtol=0)
    assert torch.equal(m, sm[..., :HEADS])
    torch.testing.assert_close(l, sm[..., HEADS:], atol=0, rtol=1e-5)
    k6_out, lse = core.attention_core_fwd_plain(qkv, mask, HEADS, 64, 0.125,
                                                causal, maybe_dead)
    torch.testing.assert_close(out, k6_out, atol=1e-5, rtol=0)
    torch.testing.assert_close(m + torch.log(l), lse, atol=1e-5, rtol=0)
    if kind in ("dead", "all"):   # m = 0, p = 1 on every key, l = n
        assert not m[-1].any()
        assert torch.equal(l[-1], torch.full((n, HEADS), float(n)))


@pytest.mark.parametrize("causal,kind", [(False, "keypad"), (True, "holes"),
                                         (True, "all"), (False, "none")])
def test_f32_forward_walk_matches_pallas(causal, kind):
    """The forward's model against the JAX package's Pallas forwards in
    interpret mode: K6's `_attention_fwd` (out, lse) on the same qkv, and
    the megablock's `_mega_fwd` (attnout, m, l) on its own stored qkv."""
    n, maybe_dead = 130, kind != "none"
    qkv, _, _ = core_args(b=4, n=n, heads=HEADS)
    mask = _mask(4, n, kind)
    want, res = jcore._attention_fwd(jnp.asarray(qkv), jnp.asarray(mask),
                                     HEADS, 64, 0.125, causal, True,
                                     maybe_dead)
    out, m, l, _ = _fwd_walk(torch.from_numpy(qkv), torch.from_numpy(mask),
                             0.125, causal, maybe_dead)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose((m + torch.log(l)).numpy(),
                               np.asarray(res[3])[0, :, :n, :], atol=1e-5,
                               rtol=0)
    args = mega_args(b=4, n=n, dim=128, heads=HEADS)
    ja = [jnp.asarray(a) for a in args[:5]] + [jnp.asarray(mask)]
    _, (_, _, (jqkv, attnout, _, stats)) = jmega._mega_fwd(
        *ja, HEADS, 64, 0.125, causal, True, maybe_dead, True)
    out, m, l, _ = _fwd_walk(torch.from_numpy(np.array(jqkv, np.float32)),
                             torch.from_numpy(mask), 0.125, causal,
                             maybe_dead)
    np.testing.assert_allclose(out.numpy(), np.asarray(attnout), atol=1e-5,
                               rtol=0)
    stats = np.asarray(stats)[:, :2 * HEADS].transpose(0, 2, 1)
    np.testing.assert_allclose(m.numpy(), stats[..., :HEADS], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), stats[..., HEADS:], atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["holes", "all"])
def test_k7_f32_walks_cover_every_nonzero_p_at_2304(causal, kind):
    """K7's mode walks the dq kernel's key tiles and the dk/dv kernel's
    query tiles as K6's with no dead row, reading each tile's mask word as
    it goes, so it has no length limit: at n = 2304 (36 key tiles) its
    walks and warp cuts reach every pair with a nonzero p; a row with no
    valid key has none (its lse is log 1e-30 and its p 0)."""
    n = 2304
    mask = torch.from_numpy(_mask(3, n, kind))
    dq, dkv = _f32_cuts(mask, causal, False)
    reach = _nonzero_p(mask, causal, False)
    assert not (reach & ~dq).any()
    assert not (reach & ~dkv).any()
    if kind == "all":
        assert not reach[-1].any()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["holes", "all"])
def test_k7_f32_walked_gradients_match_pallas(causal, kind):
    """The K7 backward with p and ds kept only on the pairs its walks and
    cuts reach (the dq kernel's ds, the dk/dv kernel's p and ds) is the
    plain version's bit for bit and JAX's `flash_attention` gradients of a
    sum of squares within 1e-4, at n = 200 (four tiles after padding)."""
    b, h, n = 3, 2, 200
    q, k, v, mask, _ = flash_args(b=b, h=h, n=n, mask_kind="holes")
    mask[-1] = mask[-1] & (kind != "all")
    (qf, kf, vf), mask_bh = flash.pad_flat(
        [torch.from_numpy(t) for t in (q, k, v)], torch.from_numpy(mask))
    out, lse = flash.flash_attention_fwd_plain(qf, kf, vf, mask_bh, causal)
    n_pad = qf.shape[1]
    do = torch.zeros_like(out)
    do[:, :n] = 2 * out[:, :n]   # d(sum out²) on the real rows
    dq_map, dkv_map = _f32_cuts(mask_bh, causal, False)
    delta = (do * out).sum(-1, keepdim=True)
    valid = flash._valid(mask_bh, n_pad, 0, n_pad, causal)
    p = torch.where(valid, torch.exp(flash.dot32(qf, kf.transpose(-1, -2))
                                     - lse[..., None]), 0.0)
    ds = p * (flash.dot32(do, vf.transpose(-1, -2)) - delta)
    zero = torch.zeros(())
    grads = (flash.dot32(torch.where(dq_map, ds, zero), kf),
             flash.dot32(torch.where(dkv_map, ds, zero).transpose(-1, -2),
                         qf),
             flash.dot32(torch.where(dkv_map, p, zero).transpose(-1, -2),
                         do))
    plain = flash.flash_attention_bwd_plain(qf, kf, vf, mask_bh, out, lse,
                                            do, causal)
    for got, want in zip(grads, plain):
        assert torch.equal(got, want)

    def f(*a):
        return jflash.flash_attention(*a, mask=jnp.asarray(mask),
                                      causal=causal, interpret=True)

    want = jax.grad(lambda *a: jnp.sum(f(*a) ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(t) for t in (q, k, v)))
    for got, w in zip(grads, want):
        got = got.reshape(b, h, n_pad, 64)[:, :, :n]
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)
