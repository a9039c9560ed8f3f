"""The port's input pipeline (`xclip_tpu_torch.data`) against JAX's on the
CPU: `TextImageLoader(device='cpu')` against JAX's
`TextImageLoader(device_put=False)` on the same seeded dataset, every
batch's tokens, images (fp32 and bf16 compared as bits), `valid` and
`loader_state` equal; `ImageFolderDataset` and `load_image` bit for bit on
seeded PNGs; a tiny CLIP trained from each package's loader batch (loss
1e-5, gradients rtol 1e-3 with atol 1e-5 times the leaf's largest
magnitude, as `tests/test_torch_train.py` holds them); and a resume
through `CheckpointManager.save(..., loader_state=)` bit for bit the
uninterrupted run. Both loaders get one shared tokenizer each, so no case
reads the vocabulary again.
"""

import itertools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xclip_tpu
from xclip_tpu.data import ImageFolderDataset as JaxFolder
from xclip_tpu.data import load_image as jax_load_image
from xclip_tpu.data.pipeline import TextImageLoader as JaxLoader
from xclip_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
import xclip_tpu_torch
from xclip_tpu_torch.convert import load_jax_params, numpy_params, to_jax_tree
from xclip_tpu_torch.data import (ImageFolderDataset, SimpleTokenizer,
                                  TextImageLoader, load_image)
from xclip_tpu_torch.train import (CheckpointManager, default_optimizer,
                                   make_train_step)

from test_torch_train import _tree_close
import torch_one_thread  # noqa: F401

JAX_TOK = JaxTokenizer()
PORT_TOK = SimpleTokenizer()
WORDS = ["a", "photo", "of", "the", "cat", "dog's", "naïve", "日本", "42",
         "Straße", "!!", "don't", "<|endoftext|>", "\x1c"]


def make_examples(n=23, image=8, seed=0):
    """Unique seeded captions (a number and 3-12 words) and (3, image,
    image) fp32 images of unit scale, whose bf16 rounding is not exact."""
    npr = np.random.RandomState(seed)
    texts = [f"{i} " + " ".join(npr.choice(WORDS, npr.randint(3, 13)))
             for i in range(n)]
    images = [npr.randn(3, image, image).astype(np.float32)
              for _ in range(n)]
    return list(zip(texts, images))


def loaders(examples, **kw):
    return (JaxLoader(examples, tokenizer=JAX_TOK, device_put=False, **kw),
            TextImageLoader(examples, tokenizer=PORT_TOK, device="cpu", **kw))


def bits(x):
    """The array's bits as unsigned integers (NaN payloads and -0 count)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    return x.view({2: np.uint16, 4: np.uint32, 1: np.uint8}[x.itemsize])


def assert_same_batches(want, got):
    assert len(got) == len(want)
    for jb, tb in zip(want, got):
        assert set(tb) == set(jb)
        assert tb["loader_state"] == jb["loader_state"]
        assert tb["text"].dtype == torch.int32
        np.testing.assert_array_equal(tb["text"].numpy(), jb["text"])
        assert str(tb["image"].dtype).split(".")[-1] == str(jb["image"].dtype)
        np.testing.assert_array_equal(bits(tb["image"]), bits(jb["image"]))
        if "valid" in jb:
            assert tb["valid"].dtype == torch.bool
            np.testing.assert_array_equal(tb["valid"].numpy(), jb["valid"])


@pytest.mark.parametrize("image_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("remainder", ["drop", "pad", "keep"])
@pytest.mark.parametrize("shards", [(1, 0), (2, 1)])
@pytest.mark.parametrize("shuffle_seed", [None, 3])
def test_batches_match_jax(shuffle_seed, shards, remainder, num_workers,
                           image_dtype):
    kw = dict(batch_size=4, context_length=16, shuffle_seed=shuffle_seed,
              shard_count=shards[0], shard_index=shards[1],
              num_workers=num_workers, image_dtype=image_dtype, num_epochs=2,
              drop_remainder=remainder == "drop",
              pad_remainder=remainder == "pad")
    jl, tl = loaders(make_examples(), **kw)
    want = list(jl)
    assert_same_batches(want, list(tl))
    # resume after each batch of the first epoch: the rest of the run
    for b in want[:3]:
        jl, tl = loaders(make_examples(), resume_from=b["loader_state"], **kw)
        assert_same_batches(list(jl), list(tl))


def test_streamed_path_with_its_shuffle_buffer_matches_jax():
    examples = make_examples(19)
    for kw in (dict(shuffle_seed=1, shuffle_buffer=5, num_epochs=2),
               dict(drop_remainder=False), dict(shuffle_seed=4)):
        jl, tl = loaders(lambda: iter(examples), batch_size=4,
                         context_length=16, **kw)
        want = list(jl)
        assert want[0]["loader_state"] is None
        assert_same_batches(want, list(tl))


def test_pretokenized_input_matches_jax():
    examples = [(JAX_TOK.encode(t) + list(range(1, 20)), im)
                for t, im in make_examples(8)]
    jl, tl = loaders(examples, batch_size=4, context_length=16)
    assert_same_batches(list(jl), list(tl))


def test_construction_errors_match_jax():
    cases = [
        (make_examples(6), dict(batch_size=4, shard_count=2, shard_index=0)),
        (make_examples(1), dict(batch_size=1, shard_count=2, shard_index=1)),
        (make_examples(4), dict(batch_size=4, pad_remainder=True)),
        (make_examples(4), dict(batch_size=4, worker_backend="fork")),
        (iter(make_examples(4)), dict(batch_size=4, shard_count=2,
                                      shard_index=0)),
        (iter(make_examples(4)), dict(batch_size=4, num_epochs=2)),
        (iter(make_examples(4)), dict(batch_size=4, resume_from={
            "epoch": 0, "batch_index": 1})),
    ]
    for examples, kw in cases:
        with pytest.raises(ValueError) as want:
            JaxLoader(examples, tokenizer=JAX_TOK, **kw)
        with pytest.raises(ValueError) as got:
            TextImageLoader(examples, tokenizer=PORT_TOK, device="cpu", **kw)
        assert str(got.value) == str(want.value)


def test_defaults_follow_the_process_group(tmp_path):
    """Without a group a loader is shard 0 of 1; in a group its rank of the
    world size."""
    import torch.distributed as dist
    loader = TextImageLoader(make_examples(8), 4, tokenizer=PORT_TOK,
                             device="cpu")
    assert (loader.shard_count, loader.shard_index) == (1, 0)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        loader = TextImageLoader(make_examples(8), 4, tokenizer=PORT_TOK,
                                 device="cpu")
        assert (loader.shard_count, loader.shard_index) == (1, 0)
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            TextImageLoader(make_examples(8), 4, tokenizer=PORT_TOK)


def test_producer_exits_when_the_consumer_leaves():
    before = set(threading.enumerate())
    loader = TextImageLoader(make_examples(64), batch_size=4,
                             context_length=16, num_epochs=None, prefetch=2,
                             tokenizer=PORT_TOK, device="cpu", num_workers=2)
    it = iter(loader)
    next(it)
    it.close()
    deadline = time.time() + 5.0
    while time.time() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t not in before and t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, f"producer thread(s) still alive: {leaked}"


def test_errors_in_the_source_reach_the_consumer():
    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("example 5 is gone")
            return make_examples(1)[0]

    loader = TextImageLoader(Broken(), batch_size=4, tokenizer=PORT_TOK,
                             device="cpu")
    with pytest.raises(KeyError, match="example 5 is gone"):
        list(loader)


def test_process_workers_match_jax():
    """Spawned workers (the dataset shipped once to each) change neither
    the data nor its order."""
    kw = dict(batch_size=4, context_length=16, shuffle_seed=2)
    jl, _ = loaders(make_examples(12), **kw)
    tl = TextImageLoader(make_examples(12), tokenizer=PORT_TOK, device="cpu",
                         num_workers=2, worker_backend="process", **kw)
    assert_same_batches(list(jl), list(tl))


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("images")
    npr = np.random.RandomState(0)
    for i in range(7):
        sub = root / ("a" if i % 2 else "b")
        sub.mkdir(exist_ok=True)
        size = (20 + i, 17 + 2 * i)
        arr = (npr.rand(size[1], size[0], 3) * 255).astype("uint8")
        mode = "RGB" if i != 3 else "L"
        Image.fromarray(arr if mode == "RGB" else arr[..., 0]).convert(
            mode).save(sub / f"img{i}.png")
        if i != 6:
            (sub / f"img{i}.txt").write_text(f"a photo number {i}\n")
    (root / "notes.md").write_text("not an image")
    return root


def test_image_sources_match_jax_bit_for_bit(image_folder):
    for path in sorted(image_folder.rglob("*.png")):
        for normalize in (True, False):
            want = jax_load_image(str(path), 16, normalize=normalize)
            got = load_image(str(path), 16, normalize=normalize)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(bits(got), bits(want))
    for kw in (dict(shuffle_seed=3), dict(default_caption="no caption")):
        jds = JaxFolder(str(image_folder), 16, **kw)
        tds = ImageFolderDataset(str(image_folder), 16, **kw)
        assert len(tds) == len(jds) == (6 if "shuffle_seed" in kw else 7)
        for (jc, ji), (tc, ti) in zip(jds, tds):
            assert tc == jc
            np.testing.assert_array_equal(bits(ti), bits(ji))
        jl, tl = (JaxLoader(jds, batch_size=3, tokenizer=JAX_TOK,
                            device_put=False, context_length=16),
                  TextImageLoader(tds, batch_size=3, tokenizer=PORT_TOK,
                                  device="cpu", context_length=16))
        assert_same_batches(list(jl), list(tl))


TINY = dict(dim_text=64, dim_image=64, dim_latent=64, num_text_tokens=49408,
            text_enc_depth=1, text_seq_len=16, text_heads=2,
            visual_enc_depth=1, visual_heads=2, visual_image_size=16,
            visual_patch_size=8, visual_patch_dropout=0.0,
            attn_impl="fused", visual_attn_impl="xla",
            ff_impl="block_stored")


@pytest.fixture(scope="module")
def jax_value_and_grad():
    """JAX's loss and gradients of the tiny CLIP, jitted once."""
    jclip = xclip_tpu.CLIP(**TINY)

    def loss_fn(p, text, image):
        return jclip.model.apply(p, text, image, return_loss=True,
                                 rng=jax.random.PRNGKey(0), training=True)

    return jax.jit(jax.value_and_grad(loss_fn))


@pytest.mark.parametrize("image_dtype", ["float32", "bfloat16"])
def test_loader_batch_trains_the_tiny_clip_as_jax(jax_value_and_grad,
                                                  image_dtype):
    tree = numpy_params(TINY, 0)
    tclip = xclip_tpu_torch.CLIP(**TINY, device="cpu")
    load_jax_params(tclip, tree)
    kw = dict(batch_size=4, context_length=16, shuffle_seed=5,
              image_dtype=image_dtype)
    jl, tl = loaders(make_examples(12, image=16), **kw)
    jb, tb = next(iter(jl)), next(iter(tl))
    want_loss, want_grads = jax_value_and_grad(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(jb["text"]),
        jnp.asarray(jb["image"]))
    loss = tclip(tb["text"], tb["image"], return_loss=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    _tree_close(to_jax_tree(tclip, grads=True), want_grads, rtol=1e-3,
                atol_scale=1e-5)


def test_resume_through_the_checkpoint_manager_is_bit_equal(tmp_path):
    config = {**TINY, "visual_patch_dropout": 0.5}
    kw = dict(batch_size=4, context_length=16, shuffle_seed=7,
              num_epochs=None, tokenizer=PORT_TOK, device="cpu")
    examples = make_examples(10, image=16)

    def run(model, opt, loader, steps, start=0):
        step = make_train_step(model, opt)
        batches = itertools.islice(iter(loader), steps)
        for i, b in enumerate(batches, start=start):
            step(b["text"], b["image"],
                 generator=torch.Generator().manual_seed(100 + i))
        return b

    model = xclip_tpu_torch.CLIP(**config, device="cpu", seed=0)
    opt = default_optimizer(model.parameters(), learning_rate=1e-3)
    run(model, opt, TextImageLoader(examples, **kw), 4)

    first = xclip_tpu_torch.CLIP(**config, device="cpu", seed=0)
    first_opt = default_optimizer(first.parameters(), learning_rate=1e-3)
    last = run(first, first_opt, TextImageLoader(examples, **kw), 3)
    manager = CheckpointManager(str(tmp_path))
    manager.save(3, first, first_opt, loader_state=last["loader_state"])

    resumed = xclip_tpu_torch.CLIP(**config, device="cpu", seed=1)
    resumed_opt = default_optimizer(resumed.parameters(), learning_rate=1e-3)
    assert manager.restore_latest(resumed, resumed_opt) == 3
    state = manager.loader_state()
    assert state == {"epoch": 1, "batch_index": 1}
    run(resumed, resumed_opt, TextImageLoader(examples, resume_from=state,
                                              **kw), 1, start=3)
    for (name, p), q in zip(model.named_parameters(), resumed.parameters()):
        assert torch.equal(p, q), name
