"""The port's visual SSL against the JAX package on the CPU: every
augmentation op and `default_augment` with the draws JAX takes from its
keys (`torch_objectives_draws.jax_augment_draws`), crop boxes at the image
edge, BatchNorm and its sequential running-statistics fold, the projector
and predictor MLPs, NT-Xent, and SimSiam and SimCLR over a 2-layer vision
tower at hidden layers −1, −2 and 0 (loss, every gradient, the folded
statistics), each given the patch indices JAX draws.

Tolerances (fp32): augmented images 1e-5 absolute (values O(1); the ops
differ from XLA's only in summation order), 5e-5 after `default_augment`'s
ImageNet normalisation, which divides by a std down to 0.224; losses 1e-5; gradients rtol
1e-3 with atol 1e-5 of the leaf's largest magnitude (the repo's rule);
BatchNorm statistics 1e-6 absolute with 1e-5 relative; SSL losses 1e-5
absolute with 1e-5 relative (SimCLR's NT-Xent over 3 per-image
representations at temperature 0.2 reaches ~40).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.nn import core as jcore
from xclip_tpu.nn.vision import VisionTransformer as JVision
from xclip_tpu.objectives import augment as jaug
from xclip_tpu.objectives import ssl as jssl
from xclip_tpu_torch.nn.core import BatchNorm1d
from xclip_tpu_torch.nn.vision import VisionTransformer
from xclip_tpu_torch.objectives import augment as taug
from xclip_tpu_torch.objectives import ssl as tssl

from torch_objectives_draws import jax_augment_draws, jax_ssl_draws
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

IMG_TOL = 1e-5


def _images(b=2, c=3, h=20, w=24, seed=0):
    return np.random.RandomState(seed).rand(b, c, h, w).astype(np.float32)


def _close(got, want, atol=IMG_TOL):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


# ------------------------------------------------------------ augmentations

@pytest.mark.parametrize("op,arg", [
    ("adjust_brightness", 1.37), ("adjust_contrast", 0.41),
    ("adjust_saturation", 1.72), ("adjust_hue", 0.17),
    ("adjust_hue", -0.19)])
def test_jitter_ops_match_jax(op, arg):
    x = _images(seed=1)
    want = getattr(jaug, op)(jnp.asarray(x), jnp.float32(arg))
    _close(getattr(taug, op)(torch.from_numpy(x), arg), want)


def test_hue_of_grey_and_saturated_pixels():
    """Pixels with max == min (hue 0), pure primaries and the `% 6`
    wrap-around of i."""
    x = np.zeros((1, 3, 2, 4), np.float32)
    x[0, :, 0, 0] = 0.5                       # grey
    x[0, :, 0, 1] = (1.0, 0.0, 0.0)           # red
    x[0, :, 0, 2] = (0.0, 1.0, 0.0)
    x[0, :, 0, 3] = (0.0, 0.0, 1.0)
    x[0, :, 1, 0] = (1.0, 0.0, 0.9999)        # h just under 1
    x[0, :, 1, 1:] = np.random.RandomState(2).rand(3, 3)
    for delta in (0.2, -0.2, 0.0):
        _close(taug.adjust_hue(torch.from_numpy(x), delta),
               jaug.adjust_hue(jnp.asarray(x), jnp.float32(delta)))


@pytest.mark.parametrize("seed", range(3))
def test_color_jitter_and_blur_match_jax(seed):
    """`color_jitter` and `gaussian_blur3` with the keys `default_augment`
    gives them (its split's keys 0 and 4)."""
    x = _images(seed=seed)
    key = jax.random.PRNGKey(seed)
    keys = jax.random.split(key, 8)
    draws = jax_augment_draws(key)
    _close(taug.color_jitter(torch.from_numpy(x), draws),
           jaug.color_jitter(keys[0], jnp.asarray(x)))
    _close(taug.gaussian_blur3(torch.from_numpy(x), draws["sigma"]),
           jaug.gaussian_blur3(keys[4], jnp.asarray(x)))


def _jax_crop(x, out, area, log_ratio, y, xx):
    """`random_resized_crop`'s resampling for a given box, as JAX computes
    it from its draws."""
    b, c, h, w = x.shape
    area = jnp.float32(area) * h * w
    aspect = jnp.exp(jnp.float32(log_ratio))
    crop_w = jnp.clip(jnp.sqrt(area * aspect), 1.0, w)
    crop_h = jnp.clip(jnp.sqrt(area / aspect), 1.0, h)
    y0 = jnp.float32(y) * (h - crop_h)
    x0 = jnp.float32(xx) * (w - crop_w)
    sy, sx = out / crop_h, out / crop_w
    return jax.image.scale_and_translate(
        jnp.asarray(x), (b, c, out, out), (2, 3), jnp.stack([sy, sx]),
        jnp.stack([-y0 * sy, -x0 * sx]), method="linear", antialias=False)


@pytest.mark.parametrize("area,log_ratio,y,x", [
    (1.0, 0.0, 0.0, 0.0),                     # the whole image
    (0.08, 0.0, 0.0, 0.0),                    # top-left corner
    (0.08, 0.0, 0.99999994, 0.99999994),      # bottom-right corner
    (0.5, np.log(4 / 3), 1.0, 0.0),           # wide, at the bottom edge
    (0.9, np.log(3 / 4), 0.3, 1.0),           # tall, clipped to the height
    (1.0, np.log(4 / 3), 0.5, 0.5),           # wider than the image
    (0.2, 0.1, 0.37, 0.81)])
def test_crop_boxes_at_the_edge_match_jax(area, log_ratio, y, x):
    img = _images(seed=3)
    draws = {"area": area, "log_ratio": log_ratio, "y": y, "x": x}
    for out in (16, 32):                      # down- and up-sampling
        _close(taug.random_resized_crop(torch.from_numpy(img), out, draws),
               _jax_crop(img, out, area, log_ratio, y, x))


def test_random_resized_crop_matches_jax():
    img = _images(seed=4)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        draws = jax_augment_draws(key)
        want = jaug.random_resized_crop(jax.random.split(key, 8)[6],
                                        jnp.asarray(img), 16)
        _close(taug.random_resized_crop(torch.from_numpy(img), 16, draws),
               want)


def _flags(d):
    return (d["jitter"] < 0.3, d["grey"] < 0.2, d["flip"] < 0.5,
            d["blur"] < 0.2)


@pytest.mark.parametrize("channels", [3, 1, 2])
def test_default_augment_matches_jax(channels):
    """Keys chosen so that every op is applied in some and skipped in
    others."""
    img = _images(b=2, c=channels, h=32, w=32, seed=5)
    seen = set()
    for seed in range(40):
        key = jax.random.PRNGKey(seed)
        draws = jax_augment_draws(key)
        flags = _flags(draws)
        if flags in seen and len(seen) < 12:
            continue
        seen.add(flags)
        want = jaug.default_augment(key, jnp.asarray(img), 24, channels)
        got = taug.default_augment(torch.from_numpy(img), 24, channels,
                                   draws=draws)
        assert got.dtype == torch.float32
        _close(got, want, 5e-5 if channels == 3 else IMG_TOL)
    for i in range(4):   # each op applied and skipped
        assert {f[i] for f in seen} == {True, False}


def test_bf16_batch_comes_out_fp32_as_in_jax():
    img = _images(b=1, h=16, w=16, seed=6)
    key = jax.random.PRNGKey(1)
    want = jaug.default_augment(key, jnp.asarray(img, jnp.bfloat16), 16)
    got = taug.default_augment(torch.from_numpy(img).bfloat16(), 16,
                               draws=jax_augment_draws(key))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32


def test_generator_draws_follow_jax_distributions():
    """The port's own draws in the distributions JAX draws from: over 4,000
    draws, each op's apply rate within 4 sigma of 0.3, 0.2, 0.5 and 0.2,
    each factor's mean within 4 sigma of its interval's middle, and all 24
    orders of the four jitter ops drawn."""
    g = torch.Generator().manual_seed(1)
    n = 4000
    draws = [taug.augment_draws(g) for _ in range(n)]
    for key, p in (("jitter", 0.3), ("grey", 0.2), ("flip", 0.5),
                   ("blur", 0.2)):
        rate = np.mean([d[key] < p for d in draws])
        assert abs(rate - p) <= 4 * np.sqrt(p * (1 - p) / n), key
    for key, lo, hi in (("brightness", 0.2, 1.8), ("hue", -0.2, 0.2),
                        ("sigma", 1.0, 2.0), ("area", 0.08, 1.0),
                        ("log_ratio", np.log(3 / 4), np.log(4 / 3))):
        mean = np.mean([d[key] for d in draws])
        assert abs(mean - (lo + hi) / 2) <= 4 * (hi - lo) / np.sqrt(12 * n)
    assert len({tuple(d["perm"]) for d in draws}) == 24


def test_draws_from_a_generator_are_in_range():
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        d = taug.augment_draws(g)
        assert sorted(d["perm"]) == [0, 1, 2, 3]
        assert 0.2 <= d["brightness"] <= 1.8 and -0.2 <= d["hue"] <= 0.2
        assert 1.0 <= d["sigma"] <= 2.0 and 0.08 <= d["area"] <= 1.0
        assert np.log(3 / 4) <= d["log_ratio"] <= np.log(4 / 3)
    out = taug.default_augment(torch.rand(2, 3, 32, 32), 16, generator=g)
    assert out.shape == (2, 3, 16, 16) and torch.isfinite(out).all()


# ------------------------------------------------------------- BatchNorm

def _bn_params(d, affine=True, seed=0):
    rs = np.random.RandomState(seed)
    p = {"mean": (0.1 * rs.randn(d)).astype(np.float32),
         "var": (1 + 0.1 * np.abs(rs.randn(d))).astype(np.float32)}
    if affine:
        p["scale"] = (1 + 0.1 * rs.randn(d)).astype(np.float32)
        p["bias"] = (0.1 * rs.randn(d)).astype(np.float32)
    return p


def _load(module, tree):
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(
                module.named_buffers()):
            node = tree
            for part in name.split("."):
                node = node[part]
            t.copy_(torch.from_numpy(np.asarray(node)))


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax(affine, training):
    p = _bn_params(12, affine)
    x = np.random.RandomState(1).randn(7, 12).astype(np.float32) * 3 + 1
    bn = BatchNorm1d(12, affine=affine)
    _load(bn, p)
    want, (wm, wv) = jcore.batch_norm_apply(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), training)
    got, (gm, gv) = bn(torch.from_numpy(x), training)
    _close(got, want, 1e-5)
    _close(gm, wm, 1e-6)
    _close(gv, wv, 1e-6)
    assert [n for n, _ in bn.named_buffers()] == ["mean", "var"]
    assert sorted(n for n, _ in bn.named_parameters()) == (
        ["bias", "scale"] if affine else [])


def test_sequential_fold_matches_jax():
    """Three calls through one BatchNorm fold in order from the stored
    statistics, with the unbiased batch variance."""
    p = _bn_params(6)
    bn = BatchNorm1d(6)
    _load(bn, p)
    jp = jax.tree.map(jnp.asarray, p)
    jupd, tupd = {}, {}
    rs = np.random.RandomState(2)
    for n in (5, 9, 1):
        x = rs.randn(n, 6).astype(np.float32)
        jssl._bn(jp, jnp.asarray(x), True, jupd, "bn1")
        tssl._bn(bn, torch.from_numpy(x), True, tupd, "bn1")
    for got, want in zip(tupd["bn1"], jupd["bn1"]):
        _close(got, want, 1e-6)


# ------------------------------------------------------------------ MLPs

def _tree_close(got, want):
    for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(want),
                                 jax.tree_util.tree_leaves_with_path(got)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            np.asarray(g, np.float32), w, rtol=1e-3,
            atol=1e-5 * max(1.0, float(np.abs(w).max())),
            err_msg=jax.tree_util.keystr(path))


def _module_tree(module, grads=False):
    tree = {}
    items = list(module.named_parameters())
    items += [(n, torch.zeros_like(b) if grads else b)
              for n, b in module.named_buffers()]
    for name, t in items:
        if grads and isinstance(t, torch.nn.Parameter):
            t = t.grad if t.grad is not None else torch.zeros_like(t)
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().numpy()
    return tree


@pytest.mark.parametrize("kind", ["mlp", "simsiam_mlp"])
def test_mlps_match_jax(kind):
    rs = np.random.RandomState(3)
    x = rs.randn(10, 16).astype(np.float32)
    if kind == "mlp":
        jp = jssl.mlp_init(jax.random.PRNGKey(0), 16, 8, 24)
        module = tssl.MLP(16, 8, 24)
        japply = jssl.mlp_apply
    else:
        jp = jssl.simsiam_mlp_init(jax.random.PRNGKey(0), 16, 8, 24)
        module = tssl.SimSiamMLP(16, 8, 24)
        japply = jssl.simsiam_mlp_apply
    jp = jax.tree.map(lambda a: a + 0.05 * jnp.sin(jnp.arange(a.size).reshape(
        a.shape)), jp)                       # statistics off (0, 1)
    _load(module, jax.tree.map(np.asarray, jp))
    cot = rs.randn(10, 8).astype(np.float32)

    def loss(p):
        upd = {}
        out = japply(p, jnp.asarray(x), True, upd, "p/")
        return (out * cot).sum(), upd

    (want, jupd), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jp)
    tupd = {}
    got = (module(torch.from_numpy(x), True, tupd, "p/")
           * torch.from_numpy(cot)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _tree_close(_module_tree(module, grads=True), jgrads)
    assert tupd.keys() == jupd.keys()
    for k in jupd:
        for g, w in zip(tupd[k], jupd[k]):
            _close(g, w, 1e-6)


def test_nt_xent_matches_jax():
    rs = np.random.RandomState(4)
    q, k = (rs.randn(5, 7).astype(np.float32) for _ in range(2))
    want, grads = jax.value_and_grad(jssl.nt_xent_loss, argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(k), 0.3)
    tq, tk = (torch.from_numpy(a).requires_grad_(True) for a in (q, k))
    got = tssl.nt_xent_loss(tq, tk, 0.3)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5)
    for g, w in zip((tq.grad, tk.grad), grads):
        _close(g, w, 1e-6)


def test_resolve_hidden_layer_names():
    for name in (-1, -2, 0, 3, "transformer", "norm_out", "transformer/1"):
        assert tssl.resolve_hidden_layer(name) == \
            jssl.resolve_hidden_layer(name)
    with pytest.raises(ValueError, match="unknown hidden layer"):
        tssl.resolve_hidden_layer("nope")


# ------------------------------------------------------- SimSiam / SimCLR

TOWER = dict(dim=64, image_size=32, patch_size=8, depth=2, heads=1,
             dim_head=64, patch_dropout=0.5)


def _tower_pair(ff_impl):
    jtower = JVision(**TOWER, ff_impl=ff_impl)
    tp = jtower.init(jax.random.PRNGKey(1))
    ttower = VisionTransformer(**TOWER, ff_impl=ff_impl)
    return jtower, tp, ttower


def _load_tower(ttower, tp):
    from xclip_tpu_torch.convert import _flatten, _unstack
    flat = _unstack(_flatten(jax.tree.map(np.asarray, tp)))
    state = ttower.state_dict()
    assert flat.keys() == state.keys()
    with torch.no_grad():
        for k, v in state.items():
            v.copy_(torch.from_numpy(np.asarray(flat[k])))


@pytest.mark.parametrize("kind", ["simsiam", "simclr"])
@pytest.mark.parametrize("hidden_layer", [-1, -2, 0])
def test_ssl_matches_jax(kind, hidden_layer):
    """The loss, the gradients of the tower and the heads, and the folded
    statistics, on the plain routes (the whole CLIP's objectives run the
    kernel routes, `test_torch_objectives.py`). Six images: at three, the
    BatchNorm over three per-image representations amplified fp32's
    summation-order differences past the 1e-3 rule in the projector's
    first BatchNorm bias (7e-2 relative on a few of 4096 entries)."""
    ff, attn = "xla", "xla"
    jtower, tp, ttower = _tower_pair(ff)
    _load_tower(ttower, tp)
    if kind == "simsiam":
        jhead = jssl.SimSiam(image_size=32, hidden_layer=hidden_layer,
                             projection_size=16, projection_hidden_size=32)
        thead = tssl.SimSiam(image_size=32, hidden_layer=hidden_layer,
                             projection_size=16, projection_hidden_size=32)
    else:
        jhead = jssl.SimCLR(image_size=32, hidden_layer=hidden_layer,
                            project_dim=16, temperature=0.2)
        thead = tssl.SimCLR(image_size=32, hidden_layer=hidden_layer,
                            project_dim=16, temperature=0.2)
    hp = jhead.init(jax.random.PRNGKey(2), jtower)
    thead.build(ttower)
    _load(thead, jax.tree.map(np.asarray, hp))
    x = _images(b=6, h=32, w=32, seed=7)
    rng = jax.random.PRNGKey(8)

    def loss(p):
        return jhead.apply(p["head"], jtower, p["tower"], jnp.asarray(x),
                           rng=rng, training=True, attn_impl=attn,
                           return_bn_updates=True)

    # eager, as jitting moves one of SimCLR's 16.7M projector gradients
    # past the rule (a 1.1e-4 difference at a 2.1e-3 element)
    (want, jbn), jgrads = jax.value_and_grad(loss, has_aux=True)(
        {"head": hp, "tower": tp})
    draws = jax_ssl_draws(rng, kind, 6, 16, 0.5)
    got, tbn = thead(ttower, torch.from_numpy(x), training=True,
                     attn_impl=attn, draws=draws)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                               atol=1e-5)
    _tree_close(_module_tree(thead, grads=True), jgrads["head"])
    from xclip_tpu_torch.convert import _restack
    tower_grads = _restack({   # JAX's zeros where no gradient reaches
        n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        for n, p in ttower.named_parameters()})
    flat_want = {".".join(str(k.key) for k in path): np.asarray(v)
                 for path, v in jax.tree_util.tree_leaves_with_path(
                     jgrads["tower"])}
    assert tower_grads.keys() == flat_want.keys()
    for k, w in flat_want.items():
        np.testing.assert_allclose(
            tower_grads[k], w, rtol=1e-3,
            atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=k)
    flat_bn = {"/".join(str(k.key) for k in path[:-1]): v
               for path, v in jax.tree_util.tree_leaves_with_path(jbn)
               if path[-1].key == "mean"}
    assert set(tbn) == set(flat_bn)
    for key, (mean, var) in tbn.items():
        node = jbn
        for part in key.split("/"):
            node = node[part]
        for got, want in ((mean, node["mean"]), (var, node["var"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("hidden_layer", [0, -2])
def test_hidden_tap_under_remat_is_bit_equal(hidden_layer):
    """`return_hidden` and `checkpoint_during_training` compose: the
    representation and every gradient bit for bit the tower without
    remat."""
    results = []
    for remat in (False, True):
        tower = VisionTransformer(**TOWER, checkpoint_during_training=remat,
                                  generator=torch.Generator().manual_seed(0))
        x = torch.from_numpy(_images(b=2, h=32, w=32, seed=9))
        keep = torch.tensor([list(range(0, 16, 2)), list(range(1, 16, 2))])
        rep = tssl.get_representation(tower, x, hidden_layer, keep_idx=keep)
        (rep * torch.arange(rep.shape[-1])).sum().backward()
        results.append((rep.detach(), [p.grad for p in tower.parameters()]))
    (r0, g0), (r1, g1) = results
    assert torch.equal(r0, r1)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(g0, g1))
