"""Zero-shot classification example: build a prompt-ensemble classifier
from class names and score a batch of images (synthetic here) — the
standard CLIP inference recipe through the single-tower encoders, the
counterpart of the JAX package's `examples/zero_shot.py` on the port.

Usage:  python -m xclip_tpu_torch.examples.zero_shot [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..api import CLIP
from ..eval import build_zero_shot_classifier, zero_shot_accuracy

CLASSES = ["dog", "cat", "car"]
TEMPLATES = ["a photo of a {}.", "a blurry photo of a {}."]
CLIP_KWARGS = dict(dim_text=128, dim_image=128, dim_latent=128,
                   num_text_tokens=49408,
                   text_enc_depth=2, text_seq_len=32, text_heads=4,
                   visual_enc_depth=2, visual_heads=4, visual_image_size=64,
                   visual_patch_size=16, visual_patch_dropout=0.0)


def classify(clip, tokenizer=None):
    """The 3 classes × 2 templates classifier of `clip` and its top-1 over
    8 seeded images: (classifier, accuracy dict)."""
    if tokenizer is None:
        from ..data import tokenizer    # the shared one, built at first use
    device = next(clip.parameters()).device
    prompts = [t.format(c) for c in CLASSES for t in TEMPLATES]
    tokens = torch.from_numpy(tokenizer.tokenize(
        prompts, context_length=32, pad_to_context_length=True)).to(device)
    classifier = build_zero_shot_classifier(
        clip, tokens, templates_per_class=len(TEMPLATES))
    images = torch.from_numpy(np.random.RandomState(0).randn(
        8, 3, 64, 64).astype(np.float32)).to(device)
    labels = np.random.RandomState(1).randint(len(CLASSES), size=8)
    acc = zero_shot_accuracy(clip, images, labels, classifier, topk=(1,))
    return classifier, acc


def main(device=None, **clip_kwargs):
    """Build the example's CLIP (random weights) on `device` (default the
    card) and print its classifier's shape and top-1; returns them."""
    clip = CLIP(**{**CLIP_KWARGS, **clip_kwargs}, device=device or "cuda")
    classifier, acc = classify(clip)
    print("classifier:", tuple(classifier.shape), " top-1 (random init):",
          acc)
    return classifier, acc


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv not in ([], ["--device", "cpu"], ["--device", "cuda"]):
        raise SystemExit("usage: python -m xclip_tpu_torch.examples.zero_shot"
                         " [--device cpu]")
    main(argv[1] if argv else None)
