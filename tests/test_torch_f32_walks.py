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
* K7's fp32 forward, the same kernel in its K7 mode (separate (b·h, n,
  64) tensors, scale 1, no dead-row rule, each tile's mask word read as
  it is walked, lse = m_safe + log l): at n = 2304, past the 2048 the
  core's other modes take, its walk reaches every score a nonzero p
  needs and gives `flash_attention_fwd_plain`'s out and lse within 1e-5
  and its m bit for bit (a row with no valid key: out 0, lse log 1e-30),
  and JAX's `_flash_forward` (interpret mode, 64-key blocks) within 1e-5;
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
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

HEADS = 2
WARP_ROWS, GROUP = 8, 16   # the forward's warp: 8 query rows; key groups
NEG_INF = float("-inf")


def _walk(q, k, v, scores, mask, causal, maybe_dead):
    """The fp32 forward kernel's arithmetic over its walk, on q, k, v (b, H,
    n, 64) and their scaled scores (b, H, n, n) → (out (b, H, n, 64), m and
    l (b, H, n), the (b, N, N) map of the (query, key) pairs whose scores
    it computes, N the padded length). One key tile at a time, every block
    at once, so each block sees its tiles in its order; a row whose block
    does not walk the tile, or whose warp's cut leaves the tile out, reads
    it as -inf, which leaves its m, l and o as they were (correction 1, p
    0), as a skipped tile does."""
    b, heads, n, _ = q.shape
    tiles = -(-n // 64)
    _, first = _tile_bits(mask)
    walked = torch.zeros(b, tiles, tiles, dtype=torch.bool)
    for (bi, t), us in _walks(mask, causal, maybe_dead)[0].items():
        walked[bi, t, us] = True
    rows = torch.arange(n)
    dead_end = torch.tensor([
        ((min(int(f), n) if causal else (n if f >= n else 0))
         if maybe_dead else 0) for f in first])
    dead = rows[None] < dead_end[:, None]                  # (b, n)
    r0 = rows - rows % WARP_ROWS                           # each row's warp
    kend = (r0 + WARP_ROWS).clamp(max=n) if causal else torch.full_like(r0, n)
    m = torch.full((b, heads, n), NEG_INF)
    l = torch.zeros(b, heads, n)
    o = torch.zeros(b, heads, n, 64)
    computed = torch.zeros(b, 64 * tiles, 64 * tiles, dtype=torch.bool)
    for u in range(tiles):
        keys = torch.arange(64 * u, min(n, 64 * u + 64))
        col = torch.arange(len(keys))
        key_valid = mask[:, keys]                          # (b, keys)
        last = (key_valid * (col + 1)).amax(-1)            # 0: no valid key
        # the warp's columns: every real key for a warp holding a dead row,
        # else up to the tile's last valid key and, causal, its last row
        cols = torch.where(
            r0[None] < dead_end[:, None], min(64, n - 64 * u),
            torch.where(last[:, None] > 0,
                        torch.minimum(kend[None] - 64 * u, last[:, None]), 0))
        cols = torch.where(walked[:, rows // 64, u], cols, 0)
        comp = ((cols[..., None] > 0)
                & (col < (cols[..., None] + GROUP - 1) // GROUP * GROUP))
        future = ((keys[None] > rows[:, None]) if causal
                  else torch.zeros(n, len(keys), dtype=torch.bool))
        valid = torch.where(dead[..., None], (keys < n)[None, None],
                            key_valid[:, None] & ~future[None])
        use = (comp & valid)[:, None]                      # (b, 1, n, keys)
        row_dead = dead[:, None, :, None]
        x = torch.where(use, torch.where(row_dead, 0.0, scores[..., keys]),
                        NEG_INF)
        mn = torch.maximum(m, x.amax(-1))
        corr = torch.where(mn == m, 1.0, torch.exp(m - mn))
        p = torch.where(use, torch.where(row_dead, 1.0,
                                         torch.exp(x - mn[..., None])), 0.0)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + p @ v[:, :, keys]
        m = mn
        computed[:, :n, 64 * u:64 * u + len(keys)] |= comp
    l = l.clamp_min(1e-30)
    return o / l[..., None], m, l, computed


def _fwd_walk(qkv, mask, scale, causal, maybe_dead):
    """The forward's walk on the fused qkv (the megablock's and K6's modes)
    → (out (b, n, HEADS·64), m and l (b, n, HEADS), the pairs computed)."""
    b, n, _ = qkv.shape
    hd = HEADS * 64
    q, k, v = (mega._heads(qkv[..., i * hd:(i + 1) * hd], b, n, HEADS, 64)
               for i in range(3))
    # the scores as the plain versions take them (the kernel's are FMA
    # chains in column order: the same values up to summation order)
    out, m, l, computed = _walk(q, k, v, (q @ k.transpose(-1, -2)) * scale,
                                mask, causal, maybe_dead)
    out = out.transpose(1, 2).reshape(b, n, hd)
    return out, m.transpose(1, 2), l.transpose(1, 2), computed


def _k7_scores(q, k):
    """(bh, n, n) q · kᵀ as `flash_attention_fwd_plain` takes them, one
    64-key block at a time."""
    return torch.cat([flash.dot32(q, k[:, j0:j0 + 64].transpose(-1, -2))
                      for j0 in range(0, q.shape[1], 64)], -1)


def _k7_fwd_walk(q, k, v, mask, causal):
    """The forward's walk in K7's mode on (bh, n, 64) q (pre-scaled), k, v:
    one head, scale 1, no dead-row rule, the key tiles with a valid key
    (each tile's mask word read as it is walked) → (out (bh, n, 64), lse =
    m_safe + log l, m (bh, n), the pairs computed)."""
    out, m, l, computed = _walk(q[:, None], k[:, None], v[:, None],
                                _k7_scores(q, k)[:, None], mask, causal,
                                False)
    m = m[:, 0]
    lse = torch.where(m == NEG_INF, 0.0, m) + torch.log(l[:, 0])
    return out[:, 0], lse, m, computed


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


def _k7_inputs(n, kind):
    """(bh, n, 64) q (pre-scaled), k, v at b·h 4 and the (4, n) mask of
    `kind`: "holes" (key pads, two whole masked tiles between valid keys
    in row 2) or "all" (the same with the last row all masked)."""
    q, k, v, _, _ = flash_args(b=4, h=1, n=n)
    return [t[:, 0] for t in (q, k, v)], _mask(4, n, kind)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["holes", "all"])
def test_k7_f32_forward_walk_matches_plain_at_2304(causal, kind):
    """K7's mode of the forward walks the key tiles with a valid key up to
    the causal diagonal, reading each tile's mask word as it goes, so it
    has no length limit: at n = 2304 (36 key tiles) its walk and warp cuts
    reach every score a nonzero p needs, and its online softmax gives the
    plain version's out and lse (1e-5) and its m bit for bit (the row max
    of the valid scores, the skipped tiles holding none). A row with no
    valid key (the dead element; causal, the rows before row 1's first
    valid key) keeps m = -inf and gives out 0 and lse log 1e-30."""
    n = 2304
    (q, k, v), mask = _k7_inputs(n, kind)
    q, k, v = (torch.from_numpy(t) for t in (q, k, v))
    mask = torch.from_numpy(mask)
    out, lse, m, computed = _k7_fwd_walk(q, k, v, mask, causal)
    assert not (_nonzero_p(mask, causal, False) & ~computed).any()
    want_out, want_lse = flash.flash_attention_fwd_plain(q, k, v, mask,
                                                         causal)
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
    valid = flash._valid(mask, n, 0, n, causal)
    assert torch.equal(m, torch.where(valid, _k7_scores(q, k),
                                      NEG_INF).amax(-1))
    none = ~valid.any(-1).expand(-1, n)   # rows with no valid key
    assert none[-1].all() == (kind == "all")
    log_floor = torch.log(torch.tensor(1e-30))
    assert not out[none].any()
    assert torch.equal(lse[none], torch.full_like(lse[none], log_floor))
    assert torch.equal(want_lse[none], lse[none])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["holes", "all"])
def test_k7_f32_forward_walk_matches_pallas(causal, kind):
    """K7's forward walk against the JAX package's Pallas `_flash_forward`
    in interpret mode with 64-key blocks (the kernel's rounding point), at
    n = 256 (the holes two whole masked tiles): out and lse within 1e-5."""
    n = 256
    flat, mask = _k7_inputs(n, kind)
    want_out, want_lse = jflash._flash_forward(
        *(jnp.asarray(t) for t in flat),
        jnp.asarray(mask.reshape(4, 1, n).astype(np.int32)), causal, 64, 64,
        True)
    out, lse, _, _ = _k7_fwd_walk(*(torch.from_numpy(t) for t in flat),
                                  torch.from_numpy(mask), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               atol=1e-5, rtol=0)


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
