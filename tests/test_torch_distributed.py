"""The port's data-parallel loss across four gloo ranks on the CPU against
the JAX package's distributed loss: the feature matrix of
`tests/test_distributed.py` (plain; DCL + extra heads; sim-reg + extra
heads; FILIP + extra heads) under `gather_impl` 'sharded' and
'replicated' with pads across shards, `shard_batch`, and the collectives
with their backward.

One module fixture spawns the world once (`torch_dist_worker.spawn`; the
ranks import no JAX) and runs every case in it; each test reads its
case's results. JAX's side runs here: its `shard_map` loss on a 4-device
submesh of the 8 fake CPU devices (`_shard_map_loss` of
`tests/test_distributed.py`), and its single-device gradients on the
global batch, which the ranks' parameter gradients, summed (what the train
step's all-reduce does), must equal.

Tolerances (`tests/test_torch_train.py`): the loss 1e-5 absolute (every
rank's); gradients per leaf rtol 1e-3 with atol 1e-5 times max(1, the
leaf's largest magnitude).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import xclip_tpu
from xclip_tpu.parallel import create_mesh
from xclip_tpu.train import shard_batch as jax_shard_batch
from xclip_tpu_torch.convert import numpy_params

from torch_dist_worker import flat_tree, spawn
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")

WORLD = 4
# `tests/test_distributed.py:25-32`
MOCK = dict(dim_text=32, dim_image=32, dim_latent=32, num_text_tokens=50,
            text_enc_depth=1, text_seq_len=8, text_heads=2, text_dim_head=16,
            visual_enc_depth=1, visual_heads=2, visual_dim_head=16,
            visual_image_size=16, visual_patch_size=8,
            visual_patch_dropout=0.0)
# the port on its kernel routes (their plain versions on the CPU)
PORT_ROUTES = dict(attn_impl="fused", visual_attn_impl="xla",
                   ff_impl="block_stored")


# ------------------------------------------------------------- helpers

def global_batch(b=8, seed=0, pads=True):
    """`test_distributed.global_batch`, with pads across shards."""
    rng = np.random.RandomState(seed)
    text = rng.randint(1, 50, (b, 8))
    image = rng.randn(b, 3, 16, 16).astype(np.float32)
    if pads:
        text[2, 5:] = 0
        text[5, 3:] = 0
    return text, image


def loss_case(name, over, seed, batch, *, kwargs=None, draws=None,
              ssl=None, tree_ssl=None, port=None):
    """A `torch_dist_worker.loss` case: the port's CLIP for `MOCK` + `over`
    (+ `port`: its routes) with `numpy_params` weights."""
    config = {**MOCK, **over}
    tree = numpy_params({**config, "visual_ssl": tree_ssl}, seed)
    return dict(name=name, kind="loss", seed=seed, over=over,
                config={**config, **PORT_ROUTES, **(port or {})},
                tree=tree, batch=batch, kwargs=kwargs or {}, draws=draws,
                ssl=ssl)


def jax_clip(case, **extra):
    """(JAX CLIP on its plain routes, its params) for a loss case."""
    over = {k: v for k, v in case["over"].items() if k != "loss_impl"}
    jclip = xclip_tpu.CLIP(**MOCK, **over, **extra)
    return jclip, jax.tree.map(jnp.asarray, case["tree"])


def mesh4():
    return create_mesh((WORLD,), axis_names=("data",),
                       devices=jax.devices()[:WORLD])


def shard_map_loss(jclip, params, arrays, **kw):
    """JAX's `shard_map` loss (out_specs P()) with `arrays` (name → global
    numpy array) sharded over 'data' and `kw` replicated."""
    names = list(arrays)

    def local(p, *xs):
        a = dict(zip(names, xs))
        return jclip.model.apply(p, a.pop("text"), a.pop("image"),
                                 return_loss=True, axis_name="data", **a,
                                 **kw)

    fn = shard_map(local, mesh=mesh4(),
                   in_specs=(P(),) + (P("data"),) * len(names),
                   out_specs=P(), check_vma=False)
    return float(jax.jit(fn)(params, *(jnp.asarray(arrays[n])
                                       for n in names)))


def global_value_and_grad(jclip, params, arrays, **kw):
    """JAX's single-device loss and gradients on the global batch."""
    a = {k: jnp.asarray(v) for k, v in arrays.items()}
    text, image = a.pop("text"), a.pop("image")
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jclip.model.apply(
        p, text, image, return_loss=True, **a, **kw)))(params)
    return float(loss), flat_tree(grads)


def rank_results(ranks, name):
    out = [r.get(name) for r in ranks]
    for r, res in enumerate(out):
        assert res is not None, f"rank {r} left no results"
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return out


def check_losses(results, want):
    for r, res in enumerate(results):
        np.testing.assert_allclose(float(res["loss"]), want, rtol=0,
                                   atol=1e-5, err_msg=f"rank {r}")


def check_grads(results, want):
    """The ranks' gradients summed, leaf by leaf, against `want`."""
    assert {k[len("grad:"):] for k in results[0] if k.startswith("grad:")} \
        == set(want)
    for k, w in want.items():
        got = sum(res[f"grad:{k}"] for res in results)
        np.testing.assert_allclose(
            got, w, rtol=1e-3, atol=1e-5 * max(1.0, float(np.abs(w).max())),
            err_msg=k)


# ---------------------------------------------------------------- cases

MATRIX = {
    "plain": dict(),
    "dcl_extra": dict(decoupled_contrastive_learning=True,
                      extra_latent_projection=True),
    "simreg_extra": dict(sim_reg_loss_weight=0.1,
                         extra_latent_projection=True),
    "filip_extra": dict(use_all_token_embeds=True,
                        extra_latent_projection=True),
}
GATHERS = ("sharded", "replicated")


def _matrix_cases():
    text, image = global_batch(seed=3)
    batch = dict(text=text, image=image)
    return [loss_case(f"{over}-{g}", MATRIX[over], 3, batch,
                      kwargs=dict(gather_impl=g))
            for over in MATRIX for g in GATHERS]


def _shard_case():
    text, image = global_batch(b=16, seed=1)
    return dict(name="shard_batch", kind="shard_rows", indivisible=14,
                batch=dict(text=text, image=image))


CASES = {c["name"]: c for c in [*_matrix_cases(), _shard_case(),
                                 dict(name="collectives",
                                      kind="collectives")]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(list(CASES.values()), WORLD,
                 str(tmp_path_factory.mktemp("gloo")))


@functools.lru_cache(maxsize=None)
def _global(over):
    case = CASES[f"{over}-sharded"]
    jclip, params = jax_clip(case)
    return global_value_and_grad(jclip, params, case["batch"])


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize("gather_impl", GATHERS)
@pytest.mark.parametrize("over", list(MATRIX))
def test_sharded_loss_feature_matrix(ranks, over, gather_impl):
    """Every rank's loss equals JAX's shard_map loss under the same
    `gather_impl`, and the ranks' summed gradients equal JAX's
    single-device global gradients."""
    case = CASES[f"{over}-{gather_impl}"]
    results = rank_results(ranks, case["name"])
    jclip, params = jax_clip(case)
    want = shard_map_loss(jclip, params, case["batch"],
                          gather_impl=gather_impl)
    check_losses(results, want)
    global_loss, global_grads = _global(over)
    np.testing.assert_allclose(want, global_loss, rtol=0, atol=1e-5)
    check_grads(results, global_grads)


def test_shard_batch_rows_and_refusal(ranks):
    """Each rank's rows are its contiguous quarter of the global batch; a
    batch that does not divide raises JAX's ValueError, in its words."""
    case = CASES["shard_batch"]
    results = rank_results(ranks, "shard_batch")
    text, image = case["batch"]["text"], case["batch"]["image"]
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["text"], text[4 * r:4 * r + 4])
        np.testing.assert_array_equal(res["image"], image[4 * r:4 * r + 4])
    mesh = create_mesh((WORLD, 1), devices=jax.devices()[:WORLD])
    with pytest.raises(ValueError) as want:
        jax_shard_batch((jnp.asarray(text[:case["indivisible"]]),), mesh)
    assert "not divisible" in str(want.value)
    for res in results:
        assert str(res["message"]) == str(want.value)


def test_collectives_and_their_backward(ranks):
    results = rank_results(ranks, "collectives")
    xs = [res["x"] for res in results]
    ws = [res["w"] for res in results]
    for r, res in enumerate(results):
        assert int(res["rank"]) == r and int(res["world"]) == WORLD
        assert not bool(res["jax_imported"])   # the ranks run without JAX
        # tiled gather on dim 1 of (m, b, d), in rank order
        np.testing.assert_array_equal(res["gathered"],
                                      np.concatenate(xs, axis=1))
        # backward: the ranks' gradients of this rank's slice, summed
        want = sum(w[:, 3 * r:3 * r + 3] for w in ws)
        np.testing.assert_allclose(res["gather_grad"], want, rtol=1e-6,
                                   atol=1e-6)
        # psum: the sum of (rank + 1)^2; its backward the identity, so a
        # replicated loss's gradient is not world ×
        assert float(res["psum"]) == sum((k + 1) ** 2 for k in range(WORLD))
        assert float(res["psum_grad"]) == 2 * (r + 1)
        # the trap the port avoids: torch.distributed.nn's all_reduce
        # all-reduces the gradient too, world × the gradient here
        assert float(res["dnn_grad"]) == WORLD * 2 * (r + 1)
        assert float(res["pmean"]) == sum(
            (k + 1) ** 2 for k in range(WORLD)) / WORLD
        assert float(res["pmean_grad"]) == 2 * (r + 1) / WORLD
        assert float(res["replicated"]) == 9.0
        assert float(res["replicated_grad"]) == 6.0 / WORLD
        np.testing.assert_array_equal(
            res["gathered_mask"],
            np.concatenate([np.arange(4) % (k + 2) == 0
                            for k in range(WORLD)]))
        np.testing.assert_array_equal(
            res["flat0"], np.full((2, 3), float(sum(range(WORLD)))))
        np.testing.assert_array_equal(
            res["flat1"], np.arange(4.0) * sum(range(1, WORLD + 1)))
        assert res["flat2"].dtype == np.float64
        np.testing.assert_array_equal(
            res["flat2"], np.full(3, float(sum(range(1, WORLD + 1)))))
