"""End-to-end training example: tokenizer → input pipeline → train loop
with metrics, a checkpoint and a zero-shot eval that shows the model
learns — the counterpart of the JAX package's `examples/train.py`, on the
port.

The synthetic dataset is LEARNABLE: each of 16 classes is a distinct
(color × orientation) sinusoidal texture, captioned "a photo of a <color>
<orientation> pattern"; the same seed gives the JAX example's pixels. A
working CLIP rapidly aligns the two towers: the contrastive loss falls and
zero-shot classification over the 16 class prompts rises from chance
(~6%) towards near-perfect.

It runs on the card (bf16 compute, bf16 images from the loader) unless
`--device cpu` is given (fp32). Under a `torch.distributed` process group
of more than one rank, the batch is sharded over a (data, 1) mesh
(`create_mesh`, `shard_state`, `shard_batch`) and the checkpoint save is
collective. At the end the model is saved, a fresh CLIP restores the file,
and its zero-shot logits must equal the trained model's.

Usage:  python -m xclip_tpu_torch.examples.train [steps] [metrics.jsonl]
            [--aux|--filip] [--device cpu]

`--aux` adds the DeCLIP-style auxiliary objectives (MLM text SSL + SimCLR
visual SSL) to the training loss; `--filip` trains with fine-grained
token-level contrast (`use_all_token_embeds=True`), whose per-token
latents have no pooled zero-shot path, so that run is judged by its loss
curve. `main(steps, metrics_path, ..., **clip_kwargs)` runs it from
Python with other `CLIP` kwargs (the kernel routes, say) and returns what
it measured.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..api import CLIP
from ..data import TextImageLoader
from ..data.tokenizer import SimpleTokenizer
from ..eval import (build_zero_shot_classifier, zero_shot_accuracy,
                    zero_shot_logits)
from ..parallel import create_mesh
from ..train import (MetricsLogger, default_optimizer, make_train_step,
                     restore_checkpoint, save_checkpoint, shard_batch,
                     shard_state)

BATCH = 64
IMAGE_SIZE = 64
SEQ = 32

COLORS = {"red": (1.0, -1.0, -1.0), "green": (-1.0, 1.0, -1.0),
          "blue": (-1.0, -1.0, 1.0), "yellow": (1.0, 1.0, -1.0)}
ORIENTS = {"horizontal": 0, "vertical": 1, "diagonal": 2, "checkered": 3}
CLASSES = [(c, o) for c in COLORS for o in ORIENTS]          # 16 classes

# the JAX example's model (`examples/train.py:116-123`); compute dtype and
# device are set by `main`
CLIP_KWARGS = dict(
    dim_text=128, dim_image=128, dim_latent=128,
    num_text_tokens=49408,              # real BPE vocab
    text_enc_depth=2, text_seq_len=SEQ, text_heads=4,
    visual_enc_depth=2, visual_heads=4, visual_image_size=IMAGE_SIZE,
    visual_patch_size=16, visual_patch_dropout=0.5)


def class_image(cls_idx: int, rng: np.random.RandomState) -> np.ndarray:
    color, orient = CLASSES[cls_idx]
    y, x = np.mgrid[0:IMAGE_SIZE, 0:IMAGE_SIZE] / IMAGE_SIZE
    freq = 2 * np.pi * 4
    phase = rng.uniform(0, 2 * np.pi)                        # nuisance
    kind = ORIENTS[orient]
    base = [np.sin(freq * y + phase), np.sin(freq * x + phase),
            np.sin(freq * (x + y) + phase),
            np.sign(np.sin(freq * x + phase) * np.sin(freq * y + phase))][kind]
    img = np.stack([base * ch for ch in COLORS[color]]).astype(np.float32)
    return img + 0.3 * rng.randn(3, IMAGE_SIZE, IMAGE_SIZE).astype(np.float32)


def caption(cls_idx: int) -> str:
    color, orient = CLASSES[cls_idx]
    return f"a photo of a {color} {orient} pattern"


class SyntheticPatterns:
    """Indexable (caption, image) dataset — exercises the loader's worker
    pool and per-epoch shuffling like a real file-backed dataset would."""

    def __init__(self, n=4096, seed=0):
        self.n, self.seed = n, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed + int(i))
        cls = int(i) % len(CLASSES)
        return caption(cls), class_image(cls, rng)


def eval_set(tok, device, seed=123, n_eval=256):
    """The zero-shot eval's inputs: the 16 class prompts' tokens, `n_eval`
    fresh images and their labels (the JAX example's draws)."""
    class_tokens = torch.from_numpy(tok.tokenize(
        [caption(c) for c in range(len(CLASSES))], context_length=SEQ,
        pad_to_context_length=True)).to(device)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, len(CLASSES), n_eval)
    images = torch.from_numpy(np.stack([class_image(c, rng)
                                        for c in labels])).to(device)
    return class_tokens, images, labels


def eval_zero_shot(clip, tok, seed=123, n_eval=256):
    """Zero-shot top-1 over the class prompts: (accuracy dict, the
    classifier, the logits)."""
    class_tokens, images, labels = eval_set(
        tok, next(clip.parameters()).device, seed, n_eval)
    classifier = build_zero_shot_classifier(clip, class_tokens)
    acc = zero_shot_accuracy(clip, images, labels, classifier)
    return acc, classifier, zero_shot_logits(clip, images, classifier)


def main(steps: int = 200, metrics_path: str = None, *, aux: bool = False,
         filip: bool = False, device=None, checkpoint_path: str = None,
         **clip_kwargs) -> dict:
    """Train the example's CLIP for `steps` steps and check it learned.
    `clip_kwargs` update `CLIP_KWARGS` (routes, dtypes). Returns the
    zero-shot top-1 before and after (None under `filip`), the first and
    last step's metrics, the training seconds and pairs/s, and whether the
    restored checkpoint's zero-shot logits equal the trained model's."""
    device = torch.device(device or "cuda")
    tmp = tempfile.gettempdir()
    metrics_path = metrics_path or os.path.join(
        tmp, "xclip-torch-example-metrics.jsonl")
    checkpoint_path = checkpoint_path or os.path.join(
        tmp, "xclip-torch-example-ckpt")
    on_card = device.type == "cuda"
    extra = {}
    if aux:
        # DeCLIP-style auxiliary self-supervision over the SHARED towers:
        # MLM on the text side, SimCLR on the vision side, folded into the
        # total loss at their default weights
        extra = dict(use_mlm=True, use_visual_ssl=True,
                     visual_ssl_type="simclr", visual_ssl_hidden_layer=-1)
    if filip:
        # update, don't rebind: --aux --filip composes (MLM + SimCLR + FILIP)
        extra.update(use_all_token_embeds=True, visual_patch_dropout=0.0)
    kwargs = dict(CLIP_KWARGS,
                  compute_dtype="bfloat16" if on_card else None, **extra)
    kwargs.update(clip_kwargs)
    clip = CLIP(**kwargs, device=device, seed=0)
    tok = SimpleTokenizer()
    world = dist.get_world_size() if dist.is_initialized() else 1
    lead = world == 1 or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    if filip:
        acc0 = None
        say("FILIP run: per-token latents have no pooled zero-shot path; "
            "judged by the contrastive loss curve")
    else:
        acc0 = eval_zero_shot(clip, tok)[0]
        say(f"zero-shot top-1 at init: {acc0['top1']:.3f} (chance = "
            f"{1 / len(CLASSES):.3f})")

    optimizer = default_optimizer(clip.parameters(), learning_rate=3e-4,
                                  warmup_steps=20, total_steps=steps)
    mesh = None
    if world > 1:
        mesh = create_mesh((world, 1))
        shard_state(clip, optimizer, mesh)
    step = make_train_step(clip, optimizer, mesh=mesh)

    # every rank reads the global batch and keeps its rows (`shard_batch`)
    loader = TextImageLoader(
        SyntheticPatterns(), BATCH, context_length=SEQ, tokenizer=tok,
        device=device, num_workers=2, shuffle_seed=0, num_epochs=None,
        shard_count=1, shard_index=0,
        # bf16 training consumes bf16 pixels: collate them device-ready
        image_dtype="bfloat16" if on_card else "float32")
    generator = torch.Generator(device).manual_seed(1)
    first, t0 = None, None
    with MetricsLogger(metrics_path if lead else None, flush_every=5,
                       print_to=sys.stderr if lead else None) as logger:
        for i, batch in enumerate(loader):
            if i >= steps:
                break
            if i == 1:   # the first step builds and warms up
                if on_card:
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
            text, image = batch["text"], batch["image"]
            if mesh is not None:
                text, image = shard_batch((text, image), mesh)
            metrics = step(text, image, generator=generator)
            logger.log(i, metrics, batch_size=BATCH)
            if first is None:
                first = {k: float(v) for k, v in metrics.items()}
    if on_card:
        torch.cuda.synchronize(device)
    seconds = 0.0 if t0 is None else time.perf_counter() - t0
    last = {k: float(v) for k, v in metrics.items()}
    if aux:
        for k in ("cl_loss", "text_ssl_loss", "image_ssl_loss"):
            say(f"{k}: {first[k]:.4f} -> {last[k]:.4f}")
    acc1 = logits = None
    if filip:
        say(f"cl_loss: {first['cl_loss']:.4f} -> {last['cl_loss']:.4f}")
        assert last["cl_loss"] < first["cl_loss"], \
            "FILIP training did not reduce the contrastive loss"
    else:
        acc1, _, logits = eval_zero_shot(clip, tok)
        say(f"zero-shot top-1 after {steps} steps: {acc1['top1']:.3f}")
        assert acc1["top1"] > acc0["top1"], \
            "training did not improve zero-shot"

    save_checkpoint(checkpoint_path, clip, optimizer, step=steps)
    say(f"checkpoint saved to {checkpoint_path}")
    fresh = CLIP(**kwargs, device=device, seed=1)
    restored_step = restore_checkpoint(checkpoint_path, fresh)
    if filip:
        same = all(torch.equal(a, b) for a, b in zip(
            fresh.state_dict().values(), clip.state_dict().values()))
    else:
        same = torch.equal(eval_zero_shot(fresh, tok)[2], logits)
    assert restored_step == steps and same, \
        "the restored checkpoint does not reproduce the trained model"
    say("restored: the same zero-shot logits" if not filip
        else "restored: the same parameters")
    pairs = BATCH * (steps - 1)
    return {"top1_init": None if acc0 is None else acc0["top1"],
            "top1": None if acc1 is None else acc1["top1"],
            "first": first, "last": last, "steps": steps,
            "seconds": seconds,
            "pairs_per_s": pairs / seconds if seconds else None,
            "restored_equal": same, "metrics_path": metrics_path}


def cli(argv):
    flags = [a for a in argv if a.startswith("--")]
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    args = [a for a in argv if not a.startswith("--")]
    unknown = set(flags) - {"--aux", "--filip", "--device"}
    if unknown or len(args) > 2:
        raise SystemExit("usage: python -m xclip_tpu_torch.examples.train "
                         "[steps] [metrics.jsonl] [--aux|--filip] "
                         "[--device cpu]")
    main(int(args[0]) if args else 200, args[1] if len(args) > 1 else None,
         aux="--aux" in flags, filip="--filip" in flags, device=device)


if __name__ == "__main__":
    cli(sys.argv[1:])
