"""The port's examples (`xclip_tpu_torch.examples`) against the JAX
package's (`examples/train.py`, `examples/zero_shot.py`) on the CPU.

  * `SyntheticPatterns` gives the JAX example's captions and pixels, bit
    for bit;
  * on the same weights (a JAX init carried across by
    `convert.load_jax_params`; fp32, plain routes) the training example's
    zero-shot classifier and top-1 are JAX's `eval_zero_shot`'s, and the
    zero-shot example's 3 × 2 prompt classifier and top-1 are JAX's;
  * `train.main` runs a few steps on the CPU, writes JAX's metric keys to
    its JSONL file and saves a checkpoint that a fresh CLIP restores to the
    same zero-shot logits;
  * the MLM trains on the loader's int32 token ids, as JAX's does.

JAX's `examples/train.py` parses `sys.argv` when imported, so it is loaded
under an argv of its own.

Tolerances: the classifiers 1e-5 absolute; top-1 exact.
"""

import importlib.util
import json
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xclip_tpu
from xclip_tpu import eval as jeval
from xclip_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
import xclip_tpu_torch
from xclip_tpu_torch.convert import load_jax_params
from xclip_tpu_torch.data.tokenizer import SimpleTokenizer
from xclip_tpu_torch.examples import train, zero_shot
import torch_one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    with mock.patch("sys.argv", [f"{name}.py"]):
        spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_examples():
    return _load("train"), _load("zero_shot")


@pytest.fixture(scope="module")
def weights():
    """A JAX CLIP of the examples' widths and its init as numpy."""
    jclip = xclip_tpu.CLIP(**train.CLIP_KWARGS, scan_layers=False)
    return jclip, jax.tree.map(np.asarray, jclip.params)


def _port(kwargs, tree):
    clip = xclip_tpu_torch.CLIP(**kwargs, device="cpu")
    load_jax_params(clip, tree)
    return clip


def test_synthetic_patterns_are_jax_s(jax_examples):
    jtrain, _ = jax_examples
    assert train.CLASSES == jtrain.CLASSES
    mine, theirs = train.SyntheticPatterns(), jtrain.SyntheticPatterns()
    assert len(mine) == len(theirs)
    for i in (0, 1, 15, 16, 17, 1000, 4095):
        (c, img), (jc, jimg) = mine[i], theirs[i]
        assert c == jc
        assert img.dtype == jimg.dtype
        np.testing.assert_array_equal(img, jimg)


def test_train_example_eval_is_jax_s(jax_examples, weights):
    """The 16-prompt classifier (1e-5) and zero-shot top-1 over the 256
    seeded eval images (exact) on JAX's weights."""
    jtrain, _ = jax_examples
    jclip, tree = weights
    params = jax.tree.map(jnp.asarray, tree)
    jtok = JaxTokenizer()
    want = jtrain.eval_zero_shot(jclip, params, jtok)
    class_tokens = jnp.asarray(jtok.tokenize(
        [jtrain.caption(c) for c in range(len(jtrain.CLASSES))],
        context_length=jtrain.SEQ, pad_to_context_length=True))
    want_classifier = jeval.build_zero_shot_classifier(jclip.model, params,
                                                       class_tokens)
    acc, classifier, logits = train.eval_zero_shot(
        _port(train.CLIP_KWARGS, tree), SimpleTokenizer())
    np.testing.assert_allclose(classifier.numpy(),
                               np.asarray(want_classifier), rtol=0,
                               atol=1e-5)
    assert acc["top1"] == want["top1"]
    assert logits.shape == (256, 16)


def test_zero_shot_example_is_jax_s(jax_examples, weights):
    """`zero_shot.classify`: the 3 classes × 2 templates classifier (1e-5)
    and top-1 over the 8 seeded images (exact), on JAX's weights."""
    _, jzero = jax_examples
    jclip, tree = weights
    params = jax.tree.map(jnp.asarray, tree)
    assert (zero_shot.CLASSES, zero_shot.TEMPLATES) == (jzero.CLASSES,
                                                        jzero.TEMPLATES)
    prompts = [t.format(c) for c in jzero.CLASSES for t in jzero.TEMPLATES]
    tokens = JaxTokenizer().tokenize(prompts, context_length=32,
                                     pad_to_context_length=True)
    want = jeval.build_zero_shot_classifier(
        jclip.model, params, tokens, templates_per_class=len(jzero.TEMPLATES))
    images = np.random.RandomState(0).randn(8, 3, 64, 64).astype(np.float32)
    labels = np.random.RandomState(1).randint(len(jzero.CLASSES), size=8)
    want_acc = jeval.zero_shot_accuracy(jclip.model, params, images, labels,
                                        want, topk=(1,))
    classifier, acc = zero_shot.classify(_port(zero_shot.CLIP_KWARGS, tree),
                                         SimpleTokenizer())
    assert classifier.shape == (3, 128)
    np.testing.assert_allclose(classifier.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert acc == want_acc


def test_train_main_runs_on_the_cpu(tmp_path):
    """Two steps (the first at the warmup's zero learning rate): JAX's
    metric keys in the JSONL file (those of `docs/run_metrics.jsonl`), the
    zero-shot top-1 risen, and the checkpoint restored by a fresh CLIP to
    the same logits."""
    path = tmp_path / "metrics.jsonl"
    out = train.main(2, str(path), device="cpu",
                     checkpoint_path=str(tmp_path / "ckpt"))
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    with open(ROOT / "docs" / "run_metrics.jsonl") as f:
        jax_keys = set(json.loads(f.readline()))
    assert [x["step"] for x in lines] == [0, 1]
    assert all(set(x) == jax_keys for x in lines)
    assert out["top1"] > out["top1_init"]
    assert out["restored_equal"] and (tmp_path / "ckpt").exists()
    state = torch.load(tmp_path / "ckpt", weights_only=True)
    assert state["step"] == 2 and state["optimizer"]["count"] == 2


def test_mlm_trains_on_int32_token_ids():
    """The loader's int32 ids and the same ids as int64 give the same MLM
    loss (PyTorch's cross entropy takes only int64 targets)."""
    config = dict(dim_text=32, dim_image=32, dim_latent=32,
                  num_text_tokens=50, text_enc_depth=1, text_seq_len=8,
                  text_heads=2, text_dim_head=16, visual_enc_depth=1,
                  visual_heads=2, visual_dim_head=16, visual_image_size=16,
                  visual_patch_size=8, use_mlm=True)
    clip = xclip_tpu_torch.CLIP(**config, device="cpu")
    rs = np.random.RandomState(0)
    text = torch.from_numpy(rs.randint(1, 50, (4, 8)).astype(np.int32))
    image = torch.from_numpy(rs.randn(4, 3, 16, 16).astype(np.float32))
    losses = []
    for t in (text, text.long()):
        loss, metrics = clip(t, image, return_loss=True, return_metrics=True,
                             generator=torch.Generator().manual_seed(0))
        losses.append((loss.item(), metrics["text_ssl_loss"].item()))
    assert losses[0] == losses[1] and losses[0][1] > 0
