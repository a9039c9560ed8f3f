"""The port's objectives against the JAX package on the CPU:
`clip_contrastive_loss` over view pairs (multiview) on 'xla' and 'fused'
(K5's plain version here, JAX's Pallas kernel in interpret mode), with and
without DCL and the extra heads; similarity regularisation; FILIP dense
and column-blocked, their gradients, and an all-pad caption; the
downsampling latent head; and the whole CLIP with every objective (MLM,
SimSiam or SimCLR, multiview, sim-reg, DCL, extra heads; FILIP with
downsampling apart), its loss, every metric and every gradient, given
the draws JAX takes from its key (`torch_objectives_draws.jax_draws`).

The port runs its kernel routes (`attn_impl='fused'`, `ff_impl=
'block_stored'`: the kernels' plain versions on the CPU); the JAX side
runs its plain routes, jitted (its kernel routes, in interpret mode, are
held by `tests/data/torch_port_golden_objectives.npz`).

Tolerances (fp32): losses and metrics 1e-5 absolute and 1e-5 relative
(SimCLR's NT-Xent reaches ~130 on these latents); gradients rtol 1e-3
with atol 1e-5 of the leaf's largest magnitude; BatchNorm statistics 1e-6
absolute with 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xclip_tpu
from xclip_tpu import model as jmodel
from xclip_tpu.objectives import contrastive as jcon
from xclip_tpu.objectives import ssl as jssl
import xclip_tpu_torch
from xclip_tpu_torch import model as tmodel
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree
from xclip_tpu_torch.objectives import contrastive as tcon
from xclip_tpu_torch.objectives import ssl as tssl

from torch_objectives_draws import jax_draws
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

TINY = dict(dim_text=64, dim_image=64, dim_latent=64, num_text_tokens=100,
            text_enc_depth=2, text_seq_len=16, text_heads=2,
            visual_enc_depth=2, visual_heads=2, visual_image_size=48,
            visual_patch_size=16, visual_patch_dropout=0.5)
KERNEL_ROUTES = dict(attn_impl="fused", visual_attn_impl="xla",
                     ff_impl="block_stored")
PLAIN_ROUTES = dict(attn_impl="xla", visual_attn_impl="xla", ff_impl="xla")
# every objective that combines with the others (FILIP excludes sim-reg)
ALL = dict(use_mlm=True, decoupled_contrastive_learning=True,
           extra_latent_projection=True, sim_reg_loss_weight=0.1)
SSL_KW = dict(image_size=48, hidden_layer=-1, projection_size=32,
              projection_hidden_size=64)
METRICS = ("loss", "cl_loss", "text_ssl_loss", "image_ssl_loss",
           "multiview_cl_loss", "sim_reg_loss", "temperature")


# ------------------------------------------------------------- helpers

def leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def grads_close(got, want):
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=1e-3,
            atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=k)


def _ssl_pair(kind):
    if kind == "simsiam":
        return jssl.SimSiam(**SSL_KW), tssl.SimSiam(**SSL_KW)
    kw = dict(image_size=48, hidden_layer=-1, project_dim=32)
    return jssl.SimCLR(**kw), tssl.SimCLR(**kw)


def make_pair(ssl=None, seed=0, port_routes=KERNEL_ROUTES, **flags):
    """(jax CLIP on the plain routes, its params, the port's CLIP on
    `port_routes`) with identical weights; `ssl` "simsiam" / "simclr"
    (small heads) or None."""
    jssl_, tssl_ = _ssl_pair(ssl) if ssl else (None, None)
    config = {**TINY, **flags}
    tree = numpy_params({**config, "visual_ssl": jssl_}, seed)
    jclip = xclip_tpu.CLIP(**config, **PLAIN_ROUTES, visual_ssl=jssl_)
    params = jax.tree.map(jnp.asarray, tree)
    assert jax.tree.structure(params) == jax.tree.structure(jclip.params)
    tclip = xclip_tpu_torch.CLIP(**config, **port_routes, visual_ssl=tssl_,
                                 device="cpu")
    load_jax_params(tclip, tree)
    return jclip, params, tclip


def inputs(b=4, seed=0, image_size=48):
    npr = np.random.RandomState(seed)
    text = npr.randint(1, 100, (b, 16))
    for i in range(b):
        text[i, 16 - 3 * i:] = 0          # padded captions of mixed lengths
    aug_text = npr.randint(1, 100, (b, 16))
    image, aug_image = (npr.rand(b, 3, image_size, image_size)
                        .astype(np.float32) for _ in range(2))
    return text, image, aug_text, aug_image


def jax_value_and_grad(jclip, params, text, image, rng, **kw):
    """((loss, metrics), grads) of a jitted training `apply`."""
    def loss_fn(p):
        return jclip.model.apply(p, text, image, return_loss=True, rng=rng,
                                 training=True, return_metrics=True, **kw)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


def check_clip(jclip, params, tclip, rng, *, views=True, ssl=None,
               mlm=True, b=4, seed=0, image_size=48, num_patches=9):
    """The training forward's loss, metrics, gradients and BatchNorm
    statistics against JAX's."""
    text, image, aug_text, aug_image = inputs(b, seed, image_size)
    kw = dict(aug_text=(jnp.asarray(aug_text),),
              aug_image=(jnp.asarray(aug_image),)) if views else {}
    (_, want), want_grads = jax_value_and_grad(
        jclip, params, jnp.asarray(text), jnp.asarray(image), rng, **kw)
    prob = tclip.model.visual.patch_dropout
    draws = jax_draws(rng, b=b, views=2 if views else 1, mlm=mlm, ssl=ssl,
                      num_patches=num_patches, prob=prob)
    tkw = dict(aug_text=torch.from_numpy(aug_text),
               aug_image=torch.from_numpy(aug_image)) if views else {}
    loss, got = tclip(torch.from_numpy(text), torch.from_numpy(image),
                      return_loss=True, return_metrics=True, **tkw, **draws)
    loss.backward()
    for k in METRICS:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    grads_close(to_jax_tree(tclip, grads=True), want_grads)
    if ssl:
        check_bn(got["bn_updates"], want["bn_updates"]["visual_ssl"])
    return got, want


def check_bn(got, want):
    """Port bn_updates ({module path: (mean, var)}) against JAX's tree."""
    assert len(got) == len(leaves(want)) // 2
    for path, stats in got.items():
        node = want
        for part in path.split(".")[1:]:
            node = node[part]
        for g, key in zip(stats, ("mean", "var")):
            np.testing.assert_allclose(g.detach().numpy(),
                                       np.asarray(node[key]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{path} {key}")


# --------------------------------------------------- contrastive losses

def _latents(shape, seed):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _loss_pair(t, i, te, ie, temp, **kw):
    """Both packages' (cl_losses, sim_reg) and the port's gradients of
    cl_losses.sum() + sim_reg in every latent and the temperature, beside
    JAX's."""
    def jfn(t, i, te, ie, temp):
        cl, reg = jcon.clip_contrastive_loss(
            t, i, temp, text_latents_extra=te, image_latents_extra=ie, **kw)
        return cl.sum() + reg, (cl, reg)

    args = [jnp.asarray(a) if a is not None else None
            for a in (t, i, te, ie)] + [jnp.float32(temp)]
    argnums = tuple(k for k, a in enumerate(args) if a is not None)
    (_, want), want_g = jax.value_and_grad(jfn, argnums=argnums,
                                           has_aux=True)(*args)
    targs = [torch.from_numpy(a).requires_grad_(True) if a is not None
             else None for a in (t, i, te, ie)]
    targs.append(torch.tensor(temp, requires_grad=True))
    tkw = {k: (torch.from_numpy(np.asarray(v)) if k == "text_mask" else v)
           for k, v in kw.items()}
    cl, reg = tcon.clip_contrastive_loss(
        targs[0], targs[1], targs[4], text_latents_extra=targs[2],
        image_latents_extra=targs[3], **tkw)
    got_g = torch.autograd.grad(cl.sum() + reg,
                                [targs[k] for k in argnums])
    np.testing.assert_allclose(cl.detach().numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_allclose(reg.item(), float(want[1]), atol=1e-5)
    for g, w in zip(got_g, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))
    return cl, got_g


@pytest.mark.parametrize("loss_impl", ["xla", "fused"])
@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("dcl", [False, True])
def test_multiview_losses_match_jax(loss_impl, extra, dcl):
    """Two text views and three image views: six losses in (m n) order."""
    b, d = 6, 16
    t, i = _latents((2, b, d), 0), _latents((3, b, d), 1)
    te = _latents((2, b, d), 2) if extra else None
    ie = _latents((3, b, d), 3) if extra else None
    cl, _ = _loss_pair(t, i, te, ie, 2.5,
                       decoupled_contrastive_learning=dcl,
                       loss_impl=loss_impl)
    assert cl.shape == (6,)


@pytest.mark.parametrize("loss_impl", ["xla", "fused"])
@pytest.mark.parametrize("extra", [False, True])
def test_sim_reg_matches_jax(loss_impl, extra):
    """Sim-reg is computed before the loss is chosen, so 'fused' has it."""
    b, d = 5, 8
    t, i = _latents((2, b, d), 4), _latents((2, b, d), 5)
    te = _latents((2, b, d), 6) if extra else None
    ie = _latents((2, b, d), 7) if extra else None
    _loss_pair(t, i, te, ie, 1.7, sim_reg=True, loss_impl=loss_impl)


def _filip_inputs(m=2, n=1, b=4, t=5, i=3, d=8, seed=8):
    mask = np.ones((m * b, t), bool)
    mask[1, 2:] = False
    mask[2, :] = False                 # an all-pad caption
    mask[-1, 1:] = False
    return (_latents((m, b, t, d), seed), _latents((n, b, i, d), seed + 1),
            _latents((m, b, t, d), seed + 2), _latents((n, b, i, d), seed + 3),
            mask)


@pytest.mark.parametrize("block", [None, 2, 4])
@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("dcl", [False, True])
def test_filip_matches_jax(block, extra, dcl):
    """Two text views, one image view. The first text view holds an
    all-pad caption: its i2t row is the mean of −finfo.max over the image
    tokens, which overflows to −inf in both packages, so that view's loss
    is NaN (inf with DCL) as JAX's is (ROADMAP.md Queue 3); the other
    view's loss and every gradient stay finite."""
    t, i, te, ie, mask = _filip_inputs()
    cl, grads = _loss_pair(t, i, te if extra else None,
                           ie if extra else None, 1.3,
                           use_all_token_embeds=True, text_mask=mask,
                           filip_block=block,
                           decoupled_contrastive_learning=dcl)
    assert not torch.isfinite(cl[0]) and torch.isfinite(cl[1])
    assert all(torch.isfinite(g).all() for g in grads)


def test_filip_blocked_is_dense():
    """The column-blocked FILIP gives the dense loss and gradients, and its
    steps are recomputed in the backward (no (b, b, t, i) tensor kept)."""
    t, i, te, ie, mask = _filip_inputs(m=1, b=6, seed=20)
    results = []
    for block in (None, 3):
        lat = [torch.from_numpy(a).requires_grad_(True) for a in (t, i,
                                                               te, ie)]
        cl, _ = tcon.clip_contrastive_loss(
            lat[0], lat[1], torch.tensor(2.0), text_latents_extra=lat[2],
            image_latents_extra=lat[3], use_all_token_embeds=True,
            text_mask=torch.from_numpy(mask), filip_block=block)
        results.append((cl, torch.autograd.grad(cl.sum(), lat)))
    (want, want_g), (got, got_g) = results
    # NaN where the all-pad caption's view is NaN (see above) in both
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6, equal_nan=True)
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


def test_loss_assertions_are_jax_words():
    t, i, te, ie, mask = _filip_inputs(m=1)
    tt, ti = torch.from_numpy(t), torch.from_numpy(i)
    for kw, text in [
            (dict(use_all_token_embeds=True, text_mask=torch.from_numpy(mask),
                  filip_block=3), "must evenly divide"),
            (dict(use_all_token_embeds=True, sim_reg=True,
                  text_mask=torch.from_numpy(mask)), "sim_reg with fine"),
            (dict(row_valid=torch.ones(4, dtype=torch.bool),
                  loss_impl="fused"), "row_valid requires")]:
        lat = (tt, ti) if kw.get("use_all_token_embeds") else (tt[:, :, 0],
                                                               ti[:, :, 0])
        with pytest.raises(AssertionError, match=text):
            tcon.clip_contrastive_loss(*lat, torch.tensor(1.0), **kw)


def test_downsample_latent_matches_jax():
    """The depthwise 4×4 stride-2 and 1×1 convolutions on a 4 × 4 grid."""
    config = {**TINY, "use_all_token_embeds": True,
              "downsample_image_embeds": True}
    tree = numpy_params(config, 3)
    head = tmodel.DownsampleLatent(64, 64)
    with torch.no_grad():
        head.dw.w.copy_(torch.from_numpy(tree["to_visual_latent"]["dw"]["w"]))
        head.pw.w.copy_(torch.from_numpy(tree["to_visual_latent"]["pw"]["w"]))
        head.pw.b.copy_(torch.from_numpy(tree["to_visual_latent"]["pw"]["b"]))
    x = np.random.RandomState(9).randn(3, 16, 64).astype(np.float32)
    jm = jmodel.CLIPModel(None, None, dim_image=64, dim_latent=64,
                          use_all_token_embeds=True,
                          downsample_image_embeds=True)
    head_params = jax.tree.map(jnp.asarray, tree["to_visual_latent"])
    want, vjp = jax.vjp(lambda p, e: jm._visual_latent(p, e), head_params,
                        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = head(xt)
    assert got.shape == (3, 4, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    cot = np.random.RandomState(10).randn(*got.shape).astype(np.float32)
    dp, dx = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    for g, w in ((xt.grad, dx), (head.dw.w.grad, dp["dw"]["w"]),
                 (head.pw.w.grad, dp["pw"]["w"]), (head.pw.b.grad,
                                                   dp["pw"]["b"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    with pytest.raises(AssertionError, match="square token grid"):
        head(torch.zeros(1, 8, 64))


# ------------------------------------------------------ the whole CLIP

@pytest.mark.parametrize("loss_impl", ["xla", "fused"])
def test_clip_every_objective_matches_jax(loss_impl):
    """MLM, SimSiam, one augmented text and image view, sim-reg, DCL and
    the extra heads: the loss, every metric, every gradient and the
    BatchNorm statistics."""
    jclip, params, tclip = make_pair(ssl="simsiam", **ALL,
                                     loss_impl=loss_impl)
    got, _ = check_clip(jclip, params, tclip, jax.random.PRNGKey(3),
                        ssl="simsiam")
    assert all(got[k].item() != 0.0 for k in METRICS)


def test_clip_simclr_matches_jax():
    """Eight images: at four, NT-Xent over BatchNorm-normalised 32-wide
    projections at temperature 0.1 (logits near 300) left 2 of the 49,152
    patch-projection gradients 1.5× the rule's bound from JAX's."""
    jclip, params, tclip = make_pair(ssl="simclr", seed=1,
                                     extra_latent_projection=True)
    check_clip(jclip, params, tclip, jax.random.PRNGKey(4), ssl="simclr",
               mlm=False, views=False, b=8)


def test_clip_default_visual_ssl_flags_match_jax():
    """`use_visual_ssl=True` builds JAX's default SimSiam (projection 256,
    hidden 4096, the hidden layer −1)."""
    jclip, params, tclip = make_pair(seed=2, use_visual_ssl=True)
    assert tclip.model.visual_ssl.projector.l2.w.shape == (4096, 4096)
    check_clip(jclip, params, tclip, jax.random.PRNGKey(5), ssl="simsiam",
               mlm=False, views=False)


@pytest.mark.parametrize("block", [None, 2])
def test_clip_filip_downsample_matches_jax(block):
    """FILIP with the downsampling latent heads (patch dropout off: a
    4 × 4 grid, 4 latent tokens), the extra heads and a second text view;
    the training loss and gradients, and the (b, t, i) inference scores."""
    flags = dict(use_all_token_embeds=True, downsample_image_embeds=True,
                 extra_latent_projection=True, visual_image_size=64,
                 visual_patch_dropout=0.0, filip_block=block)
    jclip, params, tclip = make_pair(seed=3, **flags)
    check_clip(jclip, params, tclip, jax.random.PRNGKey(6), mlm=False,
               image_size=64, num_patches=16)
    text, image, _, _ = inputs(3, 4, 64)
    for t2i in (True, False):
        want = jclip(jnp.asarray(text), jnp.asarray(image), params=params,
                     text_to_image=t2i)
        got = tclip(torch.from_numpy(text), torch.from_numpy(image),
                    text_to_image=t2i)
        assert got.shape == (3, 16, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
