"""The port's (data, model) mesh across four gloo ranks on the CPU against
the JAX package's GSPMD step: `create_mesh`, `param_spec`, `shard_state`
(AdamW's moments sharded like their parameters), `shard_batch` over the
mesh and `make_train_step(mesh=)`, held to JAX's `make_train_step` over
`shard_state` and `shard_batch` on meshes of the 8 fake CPU devices.

  * a 2 × 2 mesh on the plain routes with DCL, the extra heads and patch
    dropout, the clip active and inactive;
  * a (1, 2) mesh on the kernel routes of the dryrun's stage 8 ('fused',
    'block_stored') and stage 9 ('fused_recompute', 'block', K5's loss),
    their plain versions on the CPU, against one JAX step on its plain
    routes (the same function, the same weights, batch and draws);
  * a (1, 2) mesh with MLM and SimCLR, where the port's `axis_name`
    semantics and GSPMD's agree (one data rank);
each compared by its metrics, `grad_norm`, every parameter after the
step and both AdamW moments, gathered to JAX's layout. Then the
placement (each TP-sharded tensor and its moments 1/tp of the whole on
every rank, before and after the step; the shards of `to_qkv` and `w_in`
are the per-third and per-half slices and gather back to JAX's tensors),
the draws shared across a model group, a (1, 1) mesh bit for bit the step
without one, and the errors. JAX's draws are replayed into the port
(`torch_objectives_draws`).

Tolerances (`tests/test_torch_dp_train.py`): metrics 1e-5 absolute and
relative; parameters and moments after the step 2e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import xclip_tpu
from xclip_tpu.objectives import ssl as jssl
from xclip_tpu.parallel import create_mesh
from xclip_tpu.parallel.sharding import param_spec as jax_param_spec
from xclip_tpu.train import trainer as jtrainer
import xclip_tpu_torch
from xclip_tpu_torch.convert import numpy_params
from xclip_tpu_torch.parallel import param_spec

from test_torch_distributed import MOCK, global_batch, rank_results
from torch_dist_worker import flat_tree, spawn
from torch_objectives_draws import jax_draws
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

WORLD = 4
B = 8
RNG = 1
METRICS = ("loss", "cl_loss", "text_ssl_loss", "image_ssl_loss",
           "multiview_cl_loss", "sim_reg_loss", "temperature", "grad_norm")
CLIP_ON, CLIP_OFF = 0.05, 1e3
STAGE8 = dict(attn_impl="fused", ff_impl="block_stored")
STAGE9 = dict(attn_impl="fused_recompute", ff_impl="block",
              loss_impl="fused")
SIMCLR = dict(image_size=16, hidden_layer=-1, project_dim=32)
# heads and inner widths that four model ranks divide
WIDE = dict(MOCK, text_heads=4, text_dim_head=8, visual_heads=4,
            visual_dim_head=8)


def _draws(over, mesh, ssl=None):
    """JAX's draws for its step's key, for each rank: its data shard's
    rows of the patch indices."""
    prob = over.get("visual_patch_dropout", 0.0)
    d = jax_draws(jax.random.PRNGKey(RNG), b=B, mlm=over.get("use_mlm"),
                  ssl=ssl, num_patches=4, prob=prob, seq=8, num_tokens=50)
    data, model = mesh
    out = []
    for r in range(WORLD):
        mine = dict(d)
        if "keep_idx" in d and r < data * model:
            rows = B // data
            i = r // model
            mine["keep_idx"] = d["keep_idx"][i * rows:(i + 1) * rows]
        out.append(mine)
    return out


def _case(name, mesh, over, seed, *, port=None, max_grad_norm=1.0,
          ssl=None, **extra):
    config = {**MOCK, **over}
    tree = numpy_params({**config, "visual_ssl": (
        jssl.SimCLR(**SIMCLR) if ssl else None)}, seed)
    text, image = global_batch(b=B, seed=seed)
    return dict(name=name, kind="tp_step", mesh=mesh,
                devices=list(range(mesh[0] * mesh[1])), over=over,
                seed=seed, config={**config, **(port or {})}, tree=tree,
                batch=dict(text=text, image=image),
                optimizer=dict(learning_rate=1e-4,
                               max_grad_norm=max_grad_norm),
                ssl=("simclr", SIMCLR) if ssl else None,
                draws=_draws(over, mesh, "simclr" if ssl else None),
                **extra)


# a stack of 4 heads of 8 (inner 128) over four model ranks, in training
STACK = dict(dim=32, depth=2, heads=4, dim_head=8)
STACKS = {"stack_dropout": {},
          "stack_rotary_causal_wide": dict(
              rotary=True, flags=dict(checkpoint_during_training=True,
                                      remat_policy="wide"))}


def _stack_case(name, rotary=False, flags=None, b=2, n=7):
    """`torch_dist_worker.tp_stack`: the stack's input, key mask,
    cotangent and each layer's whole-shaped keep masks (attention, FF)."""
    rs = np.random.RandomState(36)
    c = STACK
    mask = np.ones((b, n), bool)
    mask[1, 5:] = False
    keep = [[rs.rand(b, c["heads"], n, n) < 0.75,
             rs.rand(b, n, 4 * c["dim"]) < 0.75] for _ in range(c["depth"])]
    return dict(name=name, kind="tp_stack", stack=c, rotary=rotary,
                flags=flags or {}, keep=keep, mask=mask,
                x=rs.randn(b, n, c["dim"]).astype(np.float32),
                cot=(rs.randn(b, n, c["dim"]) / np.sqrt(b * n * c["dim"])
                     ).astype(np.float32))


FEATURES = dict(decoupled_contrastive_learning=True,
                extra_latent_projection=True, visual_patch_dropout=0.5)
CASES = {c["name"]: c for c in [
    _case("dp2tp2_clipped", (2, 2), FEATURES, 30, max_grad_norm=CLIP_ON),
    _case("dp2tp2", (2, 2), FEATURES, 30, max_grad_norm=CLIP_OFF),
    _case("stage8", (1, 2), dict(visual_patch_dropout=0.5), 31,
          port=STAGE8),
    _case("stage9", (1, 2), dict(visual_patch_dropout=0.5), 31,
          port=STAGE9),
    _case("mlm_simclr", (1, 2), dict(use_mlm=True), 32, ssl=True),
    dict(_case("shared_draws", (1, 2), dict(visual_patch_dropout=0.5), 33),
         draws=None, seed_by_rank=True),
    dict(_case("unsharded", (1, 1), dict(visual_patch_dropout=0.5), 34,
               port=STAGE8),
         kind="tp_unsharded", draws=None),
    dict(name="layout", kind="tp_layout", config=WIDE,
         tree=numpy_params(WIDE, 35)),
    *(_stack_case(name, **kw) for name, kw in STACKS.items()),
]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(list(CASES.values()), WORLD,
                 str(tmp_path_factory.mktemp("gloo")))


def _members(ranks, name):
    return [r for r in rank_results(ranks, name) if bool(r["member"])]


def _adam(opt_state):
    return next(x for x in jax.tree.leaves(
        opt_state, is_leaf=lambda y: isinstance(y, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))


def _jax_step(case):
    """JAX's GSPMD step on its mesh of the case's shape: (metrics, params,
    mu, nu) as flat numpy trees."""
    over = {k: v for k, v in case["over"].items() if k != "loss_impl"}
    jclip = xclip_tpu.CLIP(**{**MOCK, **over}, visual_ssl=(
        jssl.SimCLR(**SIMCLR) if case["ssl"] else None))
    params = jax.tree.map(jnp.asarray, case["tree"])
    shape = case["mesh"]
    mesh = create_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
    opt = jtrainer.default_optimizer(**case["optimizer"])
    state = jtrainer.shard_state(jtrainer.TrainState(
        params=params, opt_state=opt.init(params),
        step=jnp.zeros((), jnp.int32)), mesh)
    text, image = jtrainer.shard_batch(
        tuple(jnp.asarray(case["batch"][k]) for k in ("text", "image")),
        mesh)
    step = jtrainer.make_train_step(jclip.model, opt, donate=False)
    new, metrics = step(state, text, image, jax.random.PRNGKey(RNG))
    adam = _adam(new.opt_state)
    return (metrics, flat_tree(new.params), flat_tree(adam.mu),
            flat_tree(adam.nu))


def _check(results, want):
    """Metrics 1e-5; both moments on every element and the parameters on
    every element whose update the two gradients determine alike, 2e-6.

    One Adam step moves an element by lr · g / (|g| + eps): by ±lr
    whatever |g| is, once |g| >> eps. Where the port's and JAX's fp32
    gradients of an element differ by more than 1 % of it (a gradient at
    rounding noise, zero in exact arithmetic: a feature dead across the
    batch before SimCLR's BatchNorm, a kept patch's cancelling sums), the
    sign of that update is rounding's, on either side and without a mesh
    alike; those elements, whose gradients must be under 1e-3 of their
    leaf's largest, are held by their moments (mu = 0.1 g), which are
    compared everywhere."""
    metrics, params, mu, nu = want
    for r, res in enumerate(results):
        for k in METRICS:
            np.testing.assert_allclose(
                float(res[f"metric:{k}"]), float(metrics[k]), rtol=1e-5,
                atol=1e-5, err_msg=f"rank {r} {k}")
        check_state(res, params, mu, nu, f"rank {r}")


def check_state(res, params, mu, nu, where=""):
    """`_check`'s rule for the parameters and both moments of one result
    (`param:`, `mu:`, `nu:` keys) against flat trees."""
    got = {}
    for tag, tree in (("param", params), ("mu", mu), ("nu", nu)):
        got[tag] = {k[len(tag) + 1:]: v for k, v in res.items()
                    if k.startswith(tag + ":")}
        # JAX keeps moments of the BatchNorm statistics, zeros here
        extra = tree.keys() - got[tag].keys() if tag != "param" \
            else set()
        assert all(k.endswith((".mean", ".var")) and not tree[k].any()
                   for k in extra), extra
        assert got[tag].keys() == tree.keys() - extra
    for k, w in params.items():
        keep = np.ones(w.shape, bool)
        if k in got["mu"]:
            np.testing.assert_allclose(got["mu"][k], mu[k], rtol=0,
                                       atol=2e-6, err_msg=f"mu {k}")
            np.testing.assert_allclose(got["nu"][k], nu[k], rtol=0,
                                       atol=2e-6, err_msg=f"nu {k}")
            keep = (np.abs(got["mu"][k] - mu[k])
                    <= 0.01 * np.abs(mu[k]))
            assert (keep.all() or np.abs(mu[k][~keep]).max()
                    <= 1e-3 * np.abs(mu[k]).max()), k
        np.testing.assert_allclose(
            got["param"][k][keep], w[keep], rtol=0, atol=2e-6,
            err_msg=f"{where} param {k}")


def _sharded_count(res, tag):
    return {k[len(tag) + 1:]: v for k, v in res.items()
            if k.startswith(tag + ":")}


# ---------------------------------------------------------------- tests

def test_param_spec_matches_jax():
    """Every parameter of a tiny CLIP with every objective head (MLM,
    SimCLR, the extra heads): the port's spec on `layers.<i>.<leaf>` is
    JAX's on the stacked leaf without its depth axis."""
    config = dict(MOCK, use_mlm=True, extra_latent_projection=True)
    ssl = xclip_tpu_torch.SimCLR(**SIMCLR)
    clip = xclip_tpu_torch.CLIP(**config, visual_ssl=ssl, device="cpu")
    tree = numpy_params({**config, "visual_ssl": jssl.SimCLR(**SIMCLR)}, 0)
    want = {}
    for path, x in jax.tree_util.tree_leaves_with_path(tree):
        name = "/".join(str(k.key) for k in path)
        want[name.replace("/", ".")] = (tuple(jax_param_spec(name, x)),
                                        "layers" in name.split("/"))
    sharded = 0
    for name, p in clip.model.named_parameters():
        parts = name.split(".")
        if "layers" in parts:
            del parts[parts.index("layers") + 1]
        spec, stacked = want[".".join(parts)]
        got = tuple(param_spec(name, p))
        assert got == (spec[1:] if stacked else spec), name
        sharded += bool(got)
    # to_qkv, to_out, w_in, inner_norm, w_out of each tower's one layer
    assert sharded == 10


@pytest.mark.parametrize("name", ["dp2tp2_clipped", "dp2tp2"])
def test_dp_tp_step_matches_jax_gspmd(ranks, name):
    """A 2 × 2 mesh, the plain routes, DCL, the extra heads and patch
    dropout: every rank's metrics and `grad_norm`, the parameters and both
    moments after the step as JAX's (2, 2) step's, the clip active (the
    norm past `max_grad_norm`) or not."""
    results = _members(ranks, name)
    assert len(results) == WORLD
    want = _jax_step(CASES[name])
    _check(results, want)
    norm = float(want[0]["grad_norm"])
    assert (norm > CLIP_ON) if name == "dp2tp2_clipped" else norm < CLIP_OFF


def test_kernel_routes_on_a_model_axis_match_jax(ranks):
    """The kernel routes of the dryrun's stages 8 and 9 on a (1, 2) mesh
    (the layers' weights gathered around the kernels; their plain versions
    here) against JAX's (1, 2) step."""
    want = _jax_step(CASES["stage8"])
    for name in ("stage8", "stage9"):
        results = _members(ranks, name)
        assert len(results) == 2
        _check(results, want)


def test_mlm_simclr_on_a_model_axis_matches_jax(ranks):
    """MLM and SimCLR on a (1, 2) mesh, where tensor parallelism does not
    touch the batch and the port's objectives are GSPMD's."""
    results = _members(ranks, "mlm_simclr")
    assert len(results) == 2
    _check(results, _jax_step(CASES["mlm_simclr"]))


def test_placement_is_one_tp_th_before_and_after_the_step(ranks):
    """On every rank each TP-sharded parameter and its two moments hold
    1/tp of the whole tensor, before the step (the moments not made yet)
    and after it; at least 4 sharded tensors a layer."""
    case = CASES["dp2tp2"]
    whole = flat_tree(case["tree"])
    for res in _members(ranks, "dp2tp2"):
        before, after = (_sharded_count(res, t) for t in ("before",
                                                          "after"))
        assert before.keys() == after.keys()
        layers = {}
        for name, shapes in after.items():
            parts = name.split(".")
            i = parts.index("layers")
            leaf = ".".join(parts[:i + 1] + parts[i + 2:])
            layers.setdefault(".".join(parts[:i + 2]), []).append(leaf)
            full = whole[leaf].shape[1:]
            assert np.prod(shapes[0]) * 2 == np.prod(full), name
            assert (shapes == shapes[0]).all(), name
            assert (before[name][0] == shapes[0]).all()
            assert (before[name][1:] == -1).all()
        assert len(layers) == 2 and all(len(v) >= 4
                                        for v in layers.values())


def test_shards_are_per_head_and_per_half_and_gather_to_jax(ranks):
    """A JAX tree loaded into a model sharded over four model ranks: rank
    r's `to_qkv.w` is [q_r | k_r | v_r] of its heads, its `w_in.w` [value_r
    | gate_r] of its inner slice, and the tree gathers back unchanged;
    moments an optimizer held before `shard_state` are sharded as their
    parameters."""
    tree = flat_tree(CASES["layout"]["tree"])
    results = rank_results(ranks, "layout")
    for r, res in enumerate(results):
        assert bool(res["moments_follow"])
        got = {k[len("param:"):]: v for k, v in res.items()
               if k.startswith("param:")}
        assert got.keys() == tree.keys()
        for k, v in tree.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        for tower in ("text", "visual"):
            for leaf, parts in (("attn.to_qkv", 3), ("ff.w_in", 2)):
                w = tree[f"{tower}.transformer.layers.{leaf}.w"][0]
                want = np.concatenate([np.split(p, WORLD, axis=1)[r]
                                       for p in np.split(w, parts, axis=1)],
                                      axis=1)
                np.testing.assert_array_equal(
                    res[f"local:{tower}.{leaf.split('.')[1]}"], want)


def test_model_ranks_draw_alike(ranks):
    """Ranks of one model group seeded apart draw the same patch indices
    (the step shares the first rank's generator): the same metrics and
    parameters."""
    a, b = _members(ranks, "shared_draws")
    assert a.keys() == b.keys()
    for k in a:
        if k.startswith(("metric:", "param:", "mu:", "nu:")):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_unsharded_mesh_is_the_plain_step(ranks):
    """A (1, 1) mesh: the kernel-route step bit for bit the step without
    a mesh (metrics, parameters, moments)."""
    (res,) = _members(ranks, "unsharded")
    assert bool(res["metrics_equal"]) and bool(res["params_equal"])
    assert bool(res["moments_equal"])


def test_errors_are_jax_s(ranks):
    """An indivisible batch over the mesh's data axis raises JAX's
    ValueError; a grid that does not cover the world JAX's
    AssertionError."""
    devices = jax.devices()[:WORLD]
    with pytest.raises(ValueError) as indivisible:
        jtrainer.shard_batch((jnp.zeros((WORLD + 2, 3)),),
                             create_mesh((WORLD, 1), devices=devices))
    with pytest.raises(AssertionError) as uncovered:
        create_mesh((WORLD - 1, 1), devices=devices)
    for res in rank_results(ranks, "layout"):
        assert str(res["indivisible"]) == str(indivisible.value)
        assert str(res["uncovered"]) == str(uncovered.value)


@pytest.mark.parametrize("name", list(STACKS))
def test_sharded_stack_is_the_whole_stack(ranks, name):
    """A stack sharded over four model ranks (one head and a quarter of the
    inner width each) in training on the plain route, with attention and
    FF dropout masks given whole (each rank takes its block), and with
    rotary, causal and 'wide' remat: its output and every gradient,
    gathered, are the whole stack's (1e-6 absolute; gradients rtol 1e-5
    with atol 1e-6 times the leaf's largest)."""
    for r, res in enumerate(rank_results(ranks, name)):
        for k in ("out", "dx"):
            np.testing.assert_allclose(res[f"sharded:{k}"], res[f"whole:{k}"],
                                       rtol=0, atol=1e-6, err_msg=k)
        grads = [k[len("whole:grad:"):] for k in res
                 if k.startswith("whole:grad:")]
        assert len(grads) == 2 * 8 + 2
        for k in grads:
            w = res[f"whole:grad:{k}"]
            np.testing.assert_allclose(
                res[f"sharded:grad:{k}"], w, rtol=1e-5,
                atol=1e-6 * max(1.0, float(np.abs(w).max())),
                err_msg=f"rank {r} {k}")
