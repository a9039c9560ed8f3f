"""The attention megablock's core (`mega_core_fwd` / `mega_core_bwd` in
`xclip_tpu_torch.kernels.attention_megablock`), on the CPU.

In bf16 the CUDA kernels run it on the megablock mode of K6's mma.sync
kernels (`csrc/attention_block_sm90.cuh`), which skip 64-key tiles and
query tiles and keep the megablock's own cast order. These tests pin what
that design rests on:

* a tiled emulation of the kernels' walk (which key tiles the forward and
  the dq kernel visit for each 64-query tile, which query tiles the dk/dv
  kernel visits for each 64-key tile) with the kernels' per-element
  formulas gives the plain version's values bit for bit: every skipped
  tile holds exact zeros (key pads, whole masked tiles between valid keys,
  dead rows, causal, n = 257);
* the scale order: the megablock folds the scale into do (dp = T(do ·
  scale) · vᵀ, ds unscaled), as JAX's `_bwd_kernel_stored` does; at scale
  0.1 the plain version holds to it, and K6's order (ds scaled) rounds
  differently in bf16 (at a power of two the orders agree);
* the finer cuts (16-row warps past n, 8-key chunks and 16-deep slices
  past a warp's last key, full tiles without a mask) leave out only exact
  zeros;
* the core's plain versions against the JAX package's forward in
  interpret mode, the wrappers on CPU tensors, and the one length limit
  the megablock's and K6's wrappers read.

Tolerances: fp32 1e-4 of the largest magnitude (summation order only);
bf16 two storage ulps of it (both sides round at the same places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.kernels import attention_megablock as jmega
from xclip_tpu_torch.kernels import attention_block as core
from xclip_tpu_torch.kernels import attention_megablock as mega

from torch_port_inputs import _key_mask, core_args, mega_args, to_torch
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

HEADS = 2


def _mask(b, n, kind):
    """`_key_mask`'s kinds, and "all": key pads, whole masked tiles between
    valid keys (row 2) and a dead element (the last row)."""
    if kind != "all":
        return _key_mask(b, n, kind)
    mask = _key_mask(b, n, "holes")
    mask[-1] = False
    return mask


def _inputs(n, kind, dtype, b=4, seed=0):
    """qkv (b, n, 3·HEADS·64), mask, fp32 dattn and the forward's attnout
    and sm."""
    qkv, _, _ = core_args(b=b, n=n, heads=HEADS, seed=seed)
    dattn = np.random.RandomState(seed + 1).randn(b, n, HEADS * 64)
    qkv = torch.from_numpy(qkv).to(dtype)
    mask = torch.from_numpy(_mask(b, n, kind))
    attnout, sm = mega.mega_core_fwd_plain(qkv, mask, HEADS, 64, 0.125)
    return qkv, mask, torch.from_numpy(dattn).float(), attnout, sm


def _tile_bits(mask):
    """(b, tiles): whether each 64-key tile holds a valid key, and the
    first valid key of each element (n if none)."""
    b, n = mask.shape
    tiles = -(-n // 64)
    padded = torch.zeros(b, tiles * 64, dtype=torch.bool)
    padded[:, :n] = mask
    bits = padded.reshape(b, tiles, 64).any(-1)
    first = torch.where(mask.any(-1), mask.int().argmax(-1),
                        torch.full((b,), n))
    return bits, first


def _walks(mask, causal, maybe_dead):
    """The kernels' walks per batch element: {(bi, query tile): key tiles}
    for the forward and the dq kernel, {(bi, key tile): query tiles} for
    the dk/dv kernel (attention_block_sm90.cuh)."""
    b, n = mask.shape
    tiles = -(-n // 64)
    bits, first = _tile_bits(mask)
    fwd, dq, dkv = {}, {}, {}
    for bi in range(b):
        fv = int(first[bi])
        for t in range(tiles):
            q0 = 64 * t
            dead_block = maybe_dead and (fv > q0 if causal else fv >= n)
            last = (min(tiles, t + 1) if causal and not dead_block
                    else tiles)
            fwd[bi, t] = [u for u in range(last) if dead_block or bits[bi, u]]
            last = min(tiles, t + 1) if causal else tiles
            dq[bi, t] = [u for u in range(last) if bits[bi, u]]
            dead_end = ((min(fv, n) if causal else (n if fv >= n else 0))
                        if maybe_dead else 0)
            dkv[bi, t] = [u for u in range(tiles) if 64 * u < dead_end or (
                bits[bi, t] and not (causal and 64 * u + 63 < q0))]
    return fwd, dq, dkv


def _tiled(values, walk, transpose=False):
    """A (b, h, n, n) tensor rebuilt from the tiles a walk visits: tile
    (row tile, column tile) = (t, u), or (u, t) with `transpose`; every
    other element 0."""
    out = torch.zeros_like(values)
    for (bi, t), us in walk.items():
        for u in us:
            r, c = (u, t) if transpose else (t, u)
            out[bi, :, 64 * r:64 * r + 64, 64 * c:64 * c + 64] = \
                values[bi, :, 64 * r:64 * r + 64, 64 * c:64 * c + 64]
    return out


def _emulate(qkv, mask, dattn, attnout, sm, scale, causal, maybe_dead):
    """The megablock-mode kernels' arithmetic over their walks, in
    PyTorch → (the forward's row max and T(p / l) as its walk leaves them,
    T(p / l) over every tile, dqkv): p = (dead ? 1 : exp(s − m)) / l from
    the stored (m, l), ds = p (dp − Δ) with the scale on do (0 on a dead
    row); the dq kernel's ds and the dk/dv kernel's p and ds kept only on
    the tiles each walks; the products as the plain version takes them."""
    dtype = qkv.dtype
    b, n, _ = qkv.shape
    hd = HEADS * 64
    q, k, v = (mega._heads(qkv[..., i * hd:(i + 1) * hd], b, n, HEADS, 64)
               for i in range(3))
    fwd_walk, dq_walk, dkv_walk = _walks(mask, causal, maybe_dead)
    s, dead = mega._softmax_parts(q, k, mask, scale, causal, maybe_dead)
    if dead is None:
        dead = torch.zeros(b, HEADS, n, 1, dtype=torch.bool)
    walked = _tiled(torch.ones_like(s), fwd_walk) != 0
    m_fwd = torch.where(dead[..., 0], 0.0,
                        s.masked_fill(~walked, float("-inf")).amax(-1))
    m, l = (sm[..., i * HEADS:(i + 1) * HEADS].permute(0, 2, 1)[..., None]
            for i in range(2))
    p = torch.where(dead, 1.0, torch.exp(s - m)) / l
    do = mega._heads(dattn, b, n, HEADS, 64)
    delta = (do * mega._heads(attnout, b, n, HEADS, 64).float() * scale
             ).sum(-1, keepdim=True)
    dp = mega.dot32((do * scale).to(dtype), v.transpose(-1, -2))
    ds = torch.where(dead, 0.0, p * (dp - delta))
    ds_dq = _tiled(ds, dq_walk).to(dtype)
    # the dk/dv kernel: key tile t walks query tiles u (rows u, columns t)
    p_kv = _tiled(p, dkv_walk, transpose=True).to(dtype)
    ds_kv = _tiled(ds, dkv_walk, transpose=True).to(dtype)
    parts = (mega.dot32(ds_dq, k), mega.dot32(ds_kv.transpose(-1, -2), q),
             mega.dot32(p_kv.transpose(-1, -2), do.to(dtype)))
    dqkv = torch.cat([t.transpose(1, 2).reshape(b, n, hd) for t in parts],
                     dim=-1).to(dtype)
    return m_fwd, _tiled(p.to(dtype), fwd_walk), p.to(dtype), dqkv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind,n", [("keypad", 257), ("holes", 257),
                                    ("all", 257), ("all", 200),
                                    ("none", 130)])
def test_mega_core_skipped_tiles_change_nothing(dtype, causal, kind, n):
    """The kernels' walks visit every tile that holds a nonzero p or ds,
    so skipping the rest gives the plain version's values bit for bit:
    the forward's row max, its T(p / l) and the backward's dqkv."""
    maybe_dead = kind != "none"
    qkv, mask, dattn, _, _ = _inputs(n, kind, dtype)
    attnout, sm = mega.mega_core_fwd_plain(qkv, mask, HEADS, 64, 0.125,
                                           causal, maybe_dead)
    m_fwd, p_fwd, p_all, dqkv = _emulate(qkv, mask, dattn, attnout, sm,
                                         0.125, causal, maybe_dead)
    assert torch.equal(m_fwd, sm[..., :HEADS].permute(0, 2, 1))
    assert torch.equal(p_fwd, p_all)
    want = mega.mega_core_bwd_plain(qkv, mask, dattn, attnout, sm, HEADS, 64,
                                    0.125, causal, maybe_dead)
    assert torch.equal(dqkv, want)
    if kind == "all":   # a dead element: uniform weights, m = 0, l = n
        assert not sm[-1, :, :HEADS].any()
        assert torch.equal(sm[-1, :, HEADS:], torch.full((n, HEADS),
                                                         float(n)))


def _parts(cols, unit):
    """`tile_parts`: the 8-key chunks (unit 8) or 16-deep slices (unit 16)
    of a 64-key tile holding one of its first `cols` keys."""
    return min(64 // unit, max(0, -(-cols // unit)))


def _cuts(mask, causal, maybe_dead):
    """The bf16 kernels' cuts below the tile (csrc/attention_block_sm90.cuh),
    as (b, N, N) boolean maps over (query, key), N the padded length:
    `scored`, the chunks of 8 keys whose scores a forward warp (16 query
    rows) computes, and the dq kernel's, which cuts the same; `multiplied`,
    the 16-key slices a forward warp takes into p · v; `full`, the tiles a
    forward or dq warp takes without a per-element mask; `full_kv`, those
    a dk/dv warp (16 keys) takes so. A warp whose rows (or keys) all lie at
    or past n does nothing."""
    b, n = mask.shape
    tiles = -(-n // 64)
    size = 64 * tiles
    bits, first = _tile_bits(mask)
    padded = torch.zeros(b, size, dtype=torch.bool)
    padded[:, :n] = mask
    words_full = padded.reshape(b, tiles, 64).all(-1)
    scored, multiplied, full, full_kv = (
        torch.zeros(b, size, size, dtype=torch.bool) for _ in range(4))
    for bi in range(b):
        fv = int(first[bi])
        dead_end = ((min(fv, n) if causal else (n if fv >= n else 0))
                    if maybe_dead else 0)
        for r0 in range(0, n, 16):
            rows = slice(r0, r0 + 16)
            warp_dead = maybe_dead and (fv > r0 if causal else fv >= n)
            kend = min(n, r0 + 16) if causal else n
            pend = n if warp_dead else kend
            for t in range(tiles):
                k0 = 64 * t
                if bits[bi, t] and k0 < kend:
                    scored[bi, rows, k0:k0 + 8 * _parts(kend - k0, 8)] = True
                    if words_full[bi, t] and not (causal and k0 + 63 > r0):
                        full[bi, rows, k0:k0 + 64] = True
                if (k0 < n) if warp_dead else (k0 < kend and bits[bi, t]):
                    multiplied[bi, rows,
                               k0:k0 + 16 * _parts(pend - k0, 16)] = True
        for kw0 in range(0, n, 16):
            keys_full = bool(padded[bi, kw0:kw0 + 16].all())
            for t in range(tiles):
                q0 = 64 * t
                if (keys_full and q0 + 64 <= n and q0 >= dead_end
                        and not (causal and kw0 + 15 > q0)):
                    full_kv[bi, q0:q0 + 64, kw0:kw0 + 16] = True
    return scored, multiplied, full, full_kv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind,n", [("keypad", 257), ("holes", 257),
                                    ("all", 257), ("all", 200),
                                    ("none", 130), ("none", 32),
                                    ("keypad", 65)])
def test_warp_and_chunk_cuts_skip_only_zeros(causal, kind, n):
    """What the warp, chunk and full-tile cuts leave out is exact: every
    score a live row uses lies in a scored chunk, every nonzero p in a
    multiplied slice, and a full tile holds only valid keys (at or before
    every row, causal) and no dead row, in the forward and dq kernels'
    layout and in the dk/dv kernel's."""
    maybe_dead = kind != "none"
    qkv, mask, _, _, _ = _inputs(n, kind, torch.float32)
    b = qkv.shape[0]
    attnout, sm = mega.mega_core_fwd_plain(qkv, mask, HEADS, 64, 0.125,
                                           causal, maybe_dead)
    q, k, _ = (mega._heads(qkv[..., i * 128:(i + 1) * 128], b, n, HEADS, 64)
               for i in range(3))
    s, dead = mega._softmax_parts(q, k, mask, 0.125, causal, maybe_dead)
    if dead is None:
        dead = torch.zeros(b, HEADS, n, 1, dtype=torch.bool)
    m, l = (sm[..., i * HEADS:(i + 1) * HEADS].permute(0, 2, 1)[..., None]
            for i in range(2))
    p = torch.where(dead, 1.0, torch.exp(s - m)) / l
    valid = s != float("-inf")
    scored, multiplied, full, full_kv = (c[:, None, :n, :n] for c in
                                         _cuts(mask, causal, maybe_dead))
    assert not (valid & ~dead & ~scored).any()
    assert not ((p != 0) & ~multiplied).any()
    for cut in (full, full_kv):
        assert not (cut & ~valid).any()
        assert not (cut & dead).any()


def test_cuts_at_full_length_257():
    """At n = 257 with every key valid the forward's live warps (17 of
    20) score 33 chunks of 8 keys each (four whole tiles and the fifth
    tile's first chunk): 17.5 tile pairs of 64 x 64 in place of 25, and
    every tile but the fifth is full."""
    mask = torch.ones(1, 257, dtype=torch.bool)
    scored, multiplied, full, _ = _cuts(mask, False, True)
    assert int(scored.sum()) == 17 * 16 * 33 * 8
    assert int(multiplied.sum()) == 17 * 16 * (4 * 64 + 16)
    assert int(full.sum()) == 17 * 16 * 4 * 64


def _f32_cuts(mask, causal, maybe_dead):
    """The fp32 backward's cuts below the tile (csrc/attention_core.cuh), as
    (b, N, N) boolean maps over (query, key), N the padded length, on the
    tiles each kernel walks (the bf16 kernels' walks, `_walks`): `dq`, the
    pairs whose ds the dq kernel forms (a warp's 16 query rows below n,
    its keys in groups of 16 up to the tile's last valid key and, causal,
    its last row); `dkv`, the pairs whose p and ds the dk/dv kernel forms
    (16 keys below n holding a valid key, or any 16 below n on a query tile
    holding a dead row; the tile's queries in groups of 16 below n)."""
    b, n = mask.shape
    tiles = -(-n // 64)
    size = 64 * tiles
    _, first = _tile_bits(mask)
    _, dq_walk, dkv_walk = _walks(mask, causal, maybe_dead)
    padded = torch.zeros(b, size, dtype=torch.bool)
    padded[:, :n] = mask
    dq, dkv = (torch.zeros(b, size, size, dtype=torch.bool) for _ in range(2))
    for (bi, t), us in dq_walk.items():
        for u in us:
            valid = padded[bi, 64 * u:64 * u + 64].nonzero()
            last = int(valid.max()) + 1
            for r0 in range(64 * t, min(n, 64 * t + 64), 16):
                kend = min(n, r0 + 16) if causal else n
                cols = -(-min(kend - 64 * u, last) // 16) * 16
                dq[bi, r0:r0 + 16, 64 * u:64 * u + cols] = True
    for (bi, t), us in dkv_walk.items():
        fv = int(first[bi])
        dead_end = ((min(fv, n) if causal else (n if fv >= n else 0))
                    if maybe_dead else 0)
        for u in us:
            cols = -(-min(64, n - 64 * u) // 16) * 16
            for k0 in range(64 * t, min(n, 64 * t + 64), 16):
                if padded[bi, k0:k0 + 16].any() or 64 * u < dead_end:
                    dkv[bi, 64 * u:64 * u + cols, k0:k0 + 16] = True
    return dq, dkv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind,n", [("keypad", 257), ("holes", 257),
                                    ("all", 257), ("all", 200),
                                    ("none", 130), ("none", 33),
                                    ("keypad", 65)])
def test_f32_cuts_skip_only_zeros(causal, kind, n):
    """What the fp32 kernels' warp and column-group cuts leave out is
    exact: the dq kernel forms ds wherever a live row has a nonzero p, the
    dk/dv kernel p and ds wherever p is nonzero (a dead row's 1/n on every
    key included)."""
    maybe_dead = kind != "none"
    qkv, mask, _, _, _ = _inputs(n, kind, torch.float32)
    b = qkv.shape[0]
    attnout, sm = mega.mega_core_fwd_plain(qkv, mask, HEADS, 64, 0.125,
                                           causal, maybe_dead)
    q, k, _ = (mega._heads(qkv[..., i * 128:(i + 1) * 128], b, n, HEADS, 64)
               for i in range(3))
    s, dead = mega._softmax_parts(q, k, mask, 0.125, causal, maybe_dead)
    if dead is None:
        dead = torch.zeros(b, HEADS, n, 1, dtype=torch.bool)
    m, l = (sm[..., i * HEADS:(i + 1) * HEADS].permute(0, 2, 1)[..., None]
            for i in range(2))
    p = torch.where(dead, 1.0, torch.exp(s - m)) / l
    dq, dkv = (c[:, None, :n, :n] for c in _f32_cuts(mask, causal,
                                                     maybe_dead))
    assert not ((p != 0) & ~dead & ~dq).any()
    assert not ((p != 0) & ~dkv).any()


def test_f32_cuts_at_full_length_257():
    """At n = 257 with every key valid the dq kernel's live warps (17 of
    20) form ds over 4 whole key tiles and the fifth tile's first group of
    16 keys; the dk/dv kernel's (17 of 20 key warps) over the 4 whole query
    tiles and the fifth's first group: 17 x 16 x 272 pairs each, in place
    of 20 x 16 x 320."""
    mask = torch.ones(1, 257, dtype=torch.bool)
    dq, dkv = _f32_cuts(mask, False, True)
    assert int(dq.sum()) == int(dkv.sum()) == 17 * 16 * 272


def _jax_dqkv(monkeypatch, args, dtype, heads, scale, causal, maybe_dead,
              dout):
    """dqkv as JAX's `_bwd_kernel_stored` emits it (interpret mode): the
    operand of `_mega_bwd_vjp`'s dW_qkv = xnᵀ · dqkv product."""
    ja = [jnp.asarray(a, dtype) for a in args[:5]] + [jnp.asarray(args[5])]
    static = (heads, 64, scale, causal)
    _, res = jmega._mega_fwd_vjp(*ja, *static, True, maybe_dead, True)
    seen = []
    dot_general = jax.lax.dot_general

    def spy(a, b, dimension_numbers, *rest, **kw):
        if dimension_numbers == (((0, 1), (0, 1)), ((), ())):
            seen.append(np.asarray(b, np.float32))
        return dot_general(a, b, dimension_numbers, *rest, **kw)

    monkeypatch.setattr(jax.lax, "dot_general", spy)
    jmega._mega_bwd_vjp(*static, True, maybe_dead, True, res,
                        jnp.asarray(dout, dtype))
    monkeypatch.setattr(jax.lax, "dot_general", dot_general)
    assert len(seen) == 1
    return seen[0]


def _k6_order_dqkv(qkv, mask, dattn, attnout, sm, scale, causal,
                   maybe_dead):
    """The megablock's backward with K6's scale order: dp = T(do) · vᵀ,
    Δ = Σ do · attnout, ds = T(p (dp − Δ) scale)."""
    dtype = qkv.dtype
    b, n, _ = qkv.shape
    hd = HEADS * 64
    q, k, v = (mega._heads(qkv[..., i * hd:(i + 1) * hd], b, n, HEADS, 64)
               for i in range(3))
    s, dead = mega._softmax_parts(q, k, mask, scale, causal, maybe_dead)
    m, l = (sm[..., i * HEADS:(i + 1) * HEADS].permute(0, 2, 1)[..., None]
            for i in range(2))
    p = torch.where(dead, 1.0, torch.exp(s - m)) / l
    do = mega._heads(dattn, b, n, HEADS, 64)
    delta = (do * mega._heads(attnout, b, n, HEADS, 64).float()).sum(
        -1, keepdim=True)
    dp = mega.dot32(do.to(dtype), v.transpose(-1, -2))
    ds = torch.where(dead, 0.0, p * (dp - delta) * scale).to(dtype)
    parts = (mega.dot32(ds, k), mega.dot32(ds.transpose(-1, -2), q),
             mega.dot32(p.to(dtype).transpose(-1, -2), do.to(dtype)))
    return torch.cat([t.transpose(1, 2).reshape(b, n, hd) for t in parts],
                     dim=-1).to(dtype)


def _ulps2(want):
    top = float(np.abs(want).max())
    return 2 * 2.0 ** (np.floor(np.log2(max(top, 2.0 ** -20))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mega_scale_order_matches_pallas(monkeypatch, dtype):
    """At scale 0.1 the plain megablock backward (the scale on do) gives
    JAX's `_bwd_kernel_stored` dqkv: fp32 to summation order, bf16 within
    two ulps. In bf16 K6's order (the scale on ds) rounds ds differently
    and lands further from JAX; at scale 0.125 the two orders agree bit
    for bit."""
    b, n = 2, 70
    args = mega_args(b=b, n=n, dim=128, heads=HEADS, mask_kind="dead")
    dout = np.random.RandomState(3).randn(b, n, 128).astype(np.float32)
    tdt = getattr(torch, dtype)
    results = {}
    for scale in (0.1, 0.125):
        want = _jax_dqkv(monkeypatch, args, dtype, HEADS, scale, True, True,
                         dout).reshape(b * n, -1)
        ta = to_torch(args, tdt)
        _, stored = mega.attention_block_fwd_stored_plain(
            *ta, HEADS, 64, scale, True, True)
        got = mega.attention_block_bwd_plain(
            *ta, torch.from_numpy(dout).to(tdt), stored, HEADS, 64, scale,
            True, True)[5]
        atol = 1e-4 * max(1.0, float(np.abs(want).max())) \
            if dtype == "float32" else _ulps2(want)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=atol)
        results[scale] = (got, want, ta, stored)
    if dtype == "float32":
        return
    for scale, (got, want, ta, stored) in results.items():
        qkv, attnout, proj, sm, ln_stats = stored
        # the cotangent of the attention as the backward forms it
        x, g_pre, w_qkv, w_out, g_out, mask = ta
        mean_o, inv_o = ln_stats[2][:, None], ln_stats[3][:, None]
        xhat_o = (proj.float() - mean_o) * inv_o
        dproj, _ = mega.ln_bwd(torch.from_numpy(dout).reshape(b * n, -1)
                               .to(torch.bfloat16).float(), xhat_o, inv_o,
                               g_out.float())
        dattn = mega.dot32(dproj.to(torch.bfloat16), w_out.T)
        core_args3 = (qkv.reshape(b, n, -1), mask, dattn.reshape(b, n, -1),
                      attnout.reshape(b, n, -1), sm.reshape(b, n, -1),
                      scale, True, True)
        mine = mega.mega_core_bwd_plain(*core_args3[:5], HEADS, 64,
                                        *core_args3[5:]).reshape(b * n, -1)
        assert torch.equal(mine, got)
        k6 = _k6_order_dqkv(*core_args3).reshape(b * n, -1)
        if scale == 0.125:
            assert torch.equal(k6, mine)
        else:
            misses = (mine.float().numpy() != want).sum()
            k6_misses = (k6.float().numpy() != want).sum()
            assert (k6 != mine).any()
            assert k6_misses > 2 * misses, (k6_misses, misses)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,kind", [(False, "keypad"), (True, "dead")])
def test_mega_core_fwd_plain_matches_pallas(dtype, causal, kind):
    """The core's plain forward on JAX's stored qkv gives JAX's stored
    attnout and (m, l)."""
    b, n = 2, 33
    args = mega_args(b=b, n=n, dim=128, heads=HEADS, mask_kind=kind)
    ja = [jnp.asarray(a, dtype) for a in args[:5]] + [jnp.asarray(args[5])]
    _, (_, _, (qkv, attnout, _, stats)) = jmega._mega_fwd(
        *ja, HEADS, 64, 0.125, causal, True, True, True)
    tqkv = torch.from_numpy(np.asarray(qkv, np.float32)).to(
        getattr(torch, dtype))
    got, sm = mega.mega_core_fwd_plain(tqkv, torch.from_numpy(args[5]),
                                       HEADS, 64, 0.125, causal, True)
    want = np.asarray(attnout, np.float32)
    atol = 1e-5 if dtype == "float32" else _ulps2(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    stats = np.asarray(stats)[:, :2 * HEADS].transpose(0, 2, 1)
    np.testing.assert_allclose(sm.numpy(), stats, atol=1e-4, rtol=1e-4)


def test_mega_core_wrappers_on_cpu_are_plain_and_uncounted():
    qkv, mask, dattn, attnout, sm = _inputs(40, "all", torch.float32, b=4)
    before = (mega.mega_core_fwd.launches, mega.mega_core_bwd.launches)
    got = mega.mega_core_fwd(qkv, mask, HEADS, 64, 0.125)
    assert torch.equal(got[0], attnout) and torch.equal(got[1], sm)
    assert torch.equal(
        mega.mega_core_bwd(qkv, mask, dattn, attnout, sm, HEADS, 64, 0.125),
        mega.mega_core_bwd_plain(qkv, mask, dattn, attnout, sm, HEADS, 64,
                                 0.125))
    assert (mega.mega_core_fwd.launches,
            mega.mega_core_bwd.launches) == before


class _Limits:
    """A stand-in for the kernel library's two length queries."""

    def xclip_attention_block_max_n(self, dtype):
        return 40

    def xclip_attention_block_bwd_max_n(self, dtype):
        return 30


@pytest.mark.parametrize("training,n,ok", [(False, 40, True),
                                           (False, 41, False),
                                           (True, 30, True),
                                           (True, 31, False)])
def test_one_length_limit_for_the_megablock_and_k6(monkeypatch, training, n,
                                                   ok):
    """The megablock's wrappers, its core's and K6's read one limit (the
    library's, bf16 2048): the forward's, and in training the backward's
    too."""
    monkeypatch.setattr(mega._build, "library", _Limits)
    assert mega.seq_len_limit(torch.bfloat16, training) == (30 if training
                                                            else 40)
    qkv = torch.zeros(1, n, 3 * 128, dtype=torch.bfloat16)
    mask = torch.ones(1, n, dtype=torch.bool)
    block = [t.to(torch.bfloat16) for t in (
        torch.zeros(1, n, 128), torch.ones(128), torch.zeros(128, 384),
        torch.zeros(128, 128), torch.ones(128))]
    checks = [lambda: core._check("K6", qkv, mask, 2, 64, training),
              lambda: mega._check_core("core", qkv, mask, 2, 64, training),
              lambda: mega._check("megablock", tuple(block), mask, 2, 64,
                                  training)]
    for check in checks:
        if ok:
            check()
        else:
            with pytest.raises(ValueError, match="exceeds"):
                check()
