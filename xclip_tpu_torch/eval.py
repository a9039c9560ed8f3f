"""Zero-shot classification and retrieval metrics — the counterparts of
`xclip_tpu/eval.py`. `model` is a `CLIP` or a `CLIPModel`; the parameters
live in it, so no params argument is passed. The zero-shot helpers take
pooled (b, d) latents only: given a FILIP model (`use_all_token_embeds`,
whose latents are per token) they raise JAX's `ValueError`
(`_require_pooled`)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _core(model):
    return getattr(model, "model", model)


def _require_pooled(model, what: str):
    """JAX's refusal of a FILIP model, in its words (`eval.py:25-34`)."""
    if getattr(_core(model), "use_all_token_embeds", False):
        raise ValueError(
            f"{what} requires pooled (b, d) latents, but this model has "
            "use_all_token_embeds=True (FILIP) and encodes per-token "
            "(b, n, d) latents. Mean-pool them yourself if that is really "
            "what you want, or evaluate with a pooled-latent model.")


@torch.no_grad()
def build_zero_shot_classifier(model, class_tokens, *,
                               templates_per_class: int = 1):
    """`class_tokens`: (num_classes · templates_per_class, seq) token ids,
    prompts grouped by class. Returns (num_classes, dim_latent) l2-normed
    class embeddings (template latents averaged per class, re-normed)."""
    _require_pooled(model, "build_zero_shot_classifier")
    latents = _core(model).encode_text(class_tokens)
    latents = latents.reshape(-1, templates_per_class, latents.shape[-1])
    mean = latents.mean(dim=1)
    return mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True)


@torch.no_grad()
def zero_shot_logits(model, images, classifier):
    """(b, num_classes) similarity logits × exp(temperature)."""
    _require_pooled(model, "zero_shot_logits")
    core = _core(model)
    temp = core.temperature.float().exp()
    return core.encode_image(images) @ classifier.T * temp


def zero_shot_accuracy(model, images, labels, classifier, *,
                       topk: Sequence[int] = (1,)) -> dict:
    logits = zero_shot_logits(model, images, classifier)
    order = torch.argsort(-logits, dim=-1, stable=True)
    labels = torch.as_tensor(labels, device=order.device)
    out = {}
    for k in topk:
        hit = (order[:, :k] == labels[:, None]).any(dim=-1)
        out[f"top{k}"] = float(hit.float().mean())
    return out


def retrieval_metrics(text_latents, image_latents, *,
                      ks: Sequence[int] = (1, 5, 10)) -> dict:
    """Paired-batch retrieval recall@k in both directions (row i of each
    side is a positive pair)."""
    if text_latents.ndim != 2 or image_latents.ndim != 2:
        raise ValueError(
            "retrieval_metrics takes pooled (b, d) latents; got shapes "
            f"{tuple(text_latents.shape)} / {tuple(image_latents.shape)}")
    sims = (text_latents @ image_latents.T).float().cpu().numpy()
    n = sims.shape[0]
    gold = np.arange(n)
    out = {}
    for name, s in (("t2i", sims), ("i2t", sims.T)):
        rank = (-s).argsort(axis=-1)
        pos = (rank == gold[:, None]).argmax(axis=-1)
        for k in ks:
            out[f"{name}_r@{k}"] = float((pos < k).mean())
    return out
