"""CLIP core — the counterpart of `xclip_tpu/model.py`'s `CLIPModel`:
single-tower encoders, encodings, l2-normed fp32 latents, paired
similarity scores × exp(temperature), and the training forward with the
contrastive loss (`return_loss=True`). A causal text tower (no CLS) is
pooled at its first EOS token, moved to position 0 (`_eos_reorder`).

Mixed precision follows the JAX model: with `compute_dtype`, every float
parameter and the images are cast to it on entry (the modules cast each
parameter as they apply it); latents are normalised in fp32 and
exp(temperature) is taken in fp32.

Inference (training False) runs under `torch.no_grad()` through the
kernels' lean forwards. Training (the default when `return_loss`) runs the
stored-backward kernel routes with autograd, FLIP patch dropout in the
vision tower and custom encoders' dropout; their randomness comes from a
`torch.Generator` or from injected `keep_idx` and keep masks. The LiT
freeze flags detach a tower's encodings.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional

import torch
from torch import nn

from .nn.core import Linear
from .objectives.contrastive import clip_contrastive_loss
from .utils import l2norm


def as_dtype(d) -> Optional[torch.dtype]:
    """torch dtype from a torch dtype, a name ('bfloat16') or None."""
    if isinstance(d, str):
        name, d = d, getattr(torch, d, None)
        if not isinstance(d, torch.dtype):
            raise ValueError(f"unknown dtype name {name!r}")
    return d


class CLIPModel(nn.Module):
    def __init__(self, text_encoder, visual_encoder, *, dim_text: int = 512,
                 dim_image: int = 512, dim_latent: int = 512,
                 text_pad_id: int = 0, text_causal_mask: bool = False,
                 text_eos_id: Optional[int] = None,
                 text_encode_without_mask: bool = False,
                 extra_latent_projection: bool = False,
                 decoupled_contrastive_learning: bool = False,
                 attn_impl: str = "xla",
                 visual_attn_impl: Optional[str] = None,
                 loss_impl: str = "xla",
                 compute_dtype=None, generator=None, dtype=torch.float32):
        super().__init__()
        if text_causal_mask and text_eos_id is None:   # JAX's assertion
            raise AssertionError("text EOS token id must be given if using "
                                 "causal mask in text transformer")
        self.text = text_encoder
        self.visual = visual_encoder
        self.text_pad_id = text_pad_id
        self.text_causal_mask, self.text_eos_id = text_causal_mask, text_eos_id
        self.text_encode_without_mask = text_encode_without_mask
        self.extra_latent_projection = extra_latent_projection
        self.decoupled_contrastive_learning = decoupled_contrastive_learning
        self.attn_impl = attn_impl
        self.visual_attn_impl = visual_attn_impl or attn_impl
        self.loss_impl = loss_impl
        self.compute_dtype = as_dtype(compute_dtype)
        self.to_text_latent = Linear(dim_text, dim_latent,
                                     generator=generator, dtype=dtype)
        self.to_visual_latent = Linear(dim_image, dim_latent,
                                       generator=generator, dtype=dtype)
        # always allocated, initialised as copies of the main heads
        self.to_text_latent_extra = copy.deepcopy(self.to_text_latent)
        self.to_visual_latent_extra = copy.deepcopy(self.to_visual_latent)
        self.temperature = nn.Parameter(torch.ones((), dtype=dtype))

    def _dtype(self):
        return self.compute_dtype or self.temperature.dtype

    def _encode_text(self, text, training=False, generator=None,
                     dropout_keep=None):
        mask = None if self.text_encode_without_mask else text != self.text_pad_id
        enc = self.text(text, mask, attn_impl=self.attn_impl,
                        dtype=self._dtype(), training=training,
                        generator=generator, dropout_keep=dropout_keep)
        return self._eos_reorder(enc, text) if self.text_causal_mask else enc

    def _eos_reorder(self, enc_text, text):
        """Causal-text pooling (`xclip_tpu/model.py:157-181`): the FIRST EOS
        position's embedding moves to index 0, the other positions follow in
        their order (the stable argsort of the one-hot, cut to n − 1). A row
        with no EOS pools its last non-pad token (and, its one-hot being
        empty, drops its last position from the rest); an all-pad row pools
        position n − 1."""
        n, dim = text.shape[-1], enc_text.shape[-1]
        eos_mask = text == self.text_eos_id
        eos_onehot = (eos_mask.cumsum(dim=-1) == 1) & eos_mask
        nonpad = (text != self.text_pad_id).int()
        last_valid = n - 1 - nonpad.flip(-1).argmax(dim=-1)
        eos_idx = torch.where(eos_mask.any(dim=-1),
                              eos_onehot.int().argmax(dim=-1), last_valid)
        rest = torch.argsort(eos_onehot.int(), dim=-1, stable=True)[:, :n - 1]
        order = torch.cat([eos_idx[:, None], rest], dim=1)
        return enc_text.gather(1, order[..., None].expand(-1, -1, dim))

    def _encode_image(self, image, training=False, generator=None,
                      keep_idx=None, dropout_keep=None):
        if self.compute_dtype is not None:
            image = image.to(self.compute_dtype)
        return self.visual(image, attn_impl=self.visual_attn_impl,
                           training=training, generator=generator,
                           keep_idx=keep_idx, dropout_keep=dropout_keep)

    @staticmethod
    def _latent(head, embeds):
        return l2norm(head(embeds).float())

    @torch.no_grad()
    def encode_text(self, text):
        """(b, n) token ids → (b, dim_latent) l2-normed fp32 latents."""
        return self._latent(self.to_text_latent, self._encode_text(text)[:, 0])

    @torch.no_grad()
    def encode_image(self, image):
        """(b, c, H, W) images → (b, dim_latent) l2-normed fp32 latents."""
        return self._latent(self.to_visual_latent,
                            self._encode_image(image)[:, 0])

    def forward(self, text, image, *, return_loss: bool = False,
                return_encodings: bool = False,
                return_latents: bool = False, text_to_image: bool = True,
                freeze_image_encoder: bool = False,
                freeze_text_encoder: bool = False, training=None,
                return_metrics: bool = False, generator=None,
                keep_idx=None, dropout_keep=None, row_valid=None):
        """As `xclip_tpu.model.CLIPModel.apply` for one view per side.
        `training` defaults to `return_loss`; `generator` / `keep_idx` feed
        the patch dropout of a training forward, and `generator` /
        `dropout_keep` (a dict of each tower's per-layer keep masks, keys
        'text' and 'visual') the dropout of custom encoders. `row_valid`
        (b,) bool marks the rows of a padded short batch that count: the
        others leave the contrastive loss (`clip_contrastive_loss`), so the
        loss is the truncated batch's. With `return_loss`,
        returns the loss (and, with `return_metrics`, JAX's dict: `loss`,
        `cl_loss`, `temperature` = exp(temperature), and `text_ssl_loss`,
        `image_ssl_loss`, `multiview_cl_loss`, `sim_reg_loss`, 0 for the
        features the port leaves out)."""
        training = return_loss if training is None else training
        if return_loss and not training:
            raise ValueError("loss cannot be used if not training")
        with contextlib.nullcontext() if training else torch.no_grad():
            keep = dropout_keep or {}
            enc_text = self._encode_text(text, training, generator,
                                         keep.get("text"))
            if freeze_text_encoder:
                enc_text = enc_text.detach()
            enc_image = self._encode_image(image, training, generator,
                                           keep_idx, keep.get("visual"))
            if freeze_image_encoder:
                enc_image = enc_image.detach()
            if return_encodings:
                return enc_text, enc_image
            text_embeds, image_embeds = enc_text[:, 0], enc_image[:, 0]
            tl = self._latent(self.to_text_latent, text_embeds)
            il = self._latent(self.to_visual_latent, image_embeds)
            tl_extra, il_extra = tl, il
            if self.extra_latent_projection:
                tl_extra = self._latent(self.to_text_latent_extra, text_embeds)
                il_extra = self._latent(self.to_visual_latent_extra,
                                        image_embeds)
            if return_latents:
                if self.extra_latent_projection:
                    return tl, il, tl_extra, il_extra
                return tl, il
            temp = self.temperature.to(self._dtype()).float().exp()
            if not return_loss:
                if self.extra_latent_projection and not text_to_image:
                    tl, il = tl_extra, il_extra
                return (tl * il).sum(dim=-1) * temp
            extra = self.extra_latent_projection
            dcl = self.decoupled_contrastive_learning
            cl_loss = clip_contrastive_loss(
                tl, il, temp, decoupled_contrastive_learning=dcl,
                text_latents_extra=tl_extra if extra else None,
                image_latents_extra=il_extra if extra else None,
                row_valid=row_valid, loss_impl=self.loss_impl)
            loss = cl_loss  # cl_loss_weight 1: no MLM, visual SSL or multiview
            if return_metrics:   # JAX's keys; the features left out give 0
                zero = torch.zeros((), dtype=torch.float32,
                                   device=loss.device)
                return loss, {"loss": loss, "cl_loss": cl_loss,
                              "text_ssl_loss": zero, "image_ssl_loss": zero,
                              "multiview_cl_loss": zero,
                              "sim_reg_loss": zero, "temperature": temp}
            return loss
