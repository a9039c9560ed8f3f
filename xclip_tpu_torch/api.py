"""User-facing `CLIP` — the constructor kwargs and defaults of
`xclip_tpu.CLIP` (minus the JAX-only `key`), around `CLIPModel`.

Port additions (keyword-only): `device=` (where the parameters live: the
card, "cuda", unless the caller asks for "cpu"; a CUDA device that is not
there raises, nothing falls back to the CPU), `seed=` /
`generator=` (a `torch.Generator` for initialisation; `seed` makes one).
`forward` adds `generator=` and `keep_idx=` (the randomness of a training
forward's patch dropout; by default the model's own call generator, as
the JAX `CLIP` folds a call counter into its key) and `return_metrics=`.

The port serves inference and trains (`return_loss=True`, and
`train.make_train_step`). A flag whose behaviour is not ported raises
`NotImplementedError` naming the ROADMAP.md module that will port it, at
construction or, for flags that only act in training
(`checkpoint_during_training`, `sim_reg_loss_weight`, augmented views),
when a training forward meets them. `remat_policy` only qualifies
`checkpoint_during_training`. `scan_layers` is a JAX compilation choice:
layers are always an `nn.ModuleList` here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .model import CLIPModel, as_dtype
from .nn.layers import check_impls
from .nn.text import TextTransformer
from .nn.vision import VisionTransformer


# where ROADMAP.md queues FILIP, MLM, SSL, multiview and sim-reg
OBJECTIVES = "Queue 1, the objectives and heads"


def _not_ported(what: str, where: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md {where}")


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested (the default) but "
                           "CUDA is not available; the port does not fall "
                           "back to the CPU: pass device='cpu' to run there")
    return device


class CLIP(nn.Module):
    def __init__(
        self,
        *,
        image_encoder=None,
        text_encoder=None,
        dim_text=512,
        dim_image=512,
        dim_latent=512,
        num_text_tokens=10000,
        text_enc_depth=6,
        text_seq_len=256,
        text_heads=8,
        text_dim_head=64,
        text_has_cls_token=True,
        text_pad_id=0,
        text_rotary_pos_emb=False,
        text_causal_mask=False,
        text_eos_id=None,
        text_encode_without_mask=False,
        visual_enc_depth=6,
        visual_heads=8,
        visual_dim_head=64,
        visual_image_size=256,
        visual_patch_size=32,
        visual_patch_dropout=0.5,
        visual_has_cls_token=True,
        channels=3,
        use_all_token_embeds=False,
        downsample_image_embeds=False,
        decoupled_contrastive_learning=False,
        extra_latent_projection=False,
        use_mlm=False,
        text_ssl_loss_weight=0.05,
        use_visual_ssl=False,
        visual_ssl=None,
        visual_ssl_type='simsiam',
        visual_ssl_hidden_layer=-1,
        simclr_temperature=0.1,
        image_ssl_loss_weight=0.05,
        multiview_loss_weight=0.1,
        checkpoint_during_training=False,
        sim_reg_loss_weight=0.,
        # extras shared with xclip_tpu.CLIP (keyword-only, optional)
        param_dtype=torch.float32,
        attn_impl: str = "xla",
        visual_attn_impl: Optional[str] = None,
        loss_impl: str = "xla",
        filip_block: Optional[int] = None,
        remat_policy: Optional[str] = None,
        scan_layers: bool = True,
        ff_impl: str = "xla",
        compute_dtype: Optional[str] = None,
        # port extras
        device="cuda",
        seed: int = 0,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        super().__init__()
        if kwargs:
            raise TypeError(f"unexpected CLIP kwargs: {sorted(kwargs)}")
        if use_all_token_embeds or downsample_image_embeds or filip_block:
            _not_ported("FILIP (use_all_token_embeds, downsample_image_embeds,"
                        " filip_block)", OBJECTIVES)
        if use_mlm or use_visual_ssl or visual_ssl is not None:
            _not_ported("use_mlm / use_visual_ssl", OBJECTIVES)
        if loss_impl not in ("xla", "fused"):
            raise ValueError(f"unknown loss_impl {loss_impl!r}")
        check_impls(attn_impl, ff_impl)
        check_impls(visual_attn_impl or attn_impl, ff_impl)
        assert visual_has_cls_token or text_has_cls_token, (
            "CLS token must be included on both vision and text transformers "
            "if you are not using fine-grained contrastive learning loss")

        device = _resolve_device(device)
        dtype = as_dtype(param_dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        if text_encoder is None:
            text_encoder = TextTransformer(
                dim=dim_text, num_tokens=num_text_tokens,
                max_seq_len=text_seq_len, depth=text_enc_depth,
                heads=text_heads, dim_head=text_dim_head,
                rotary_pos_emb=text_rotary_pos_emb, causal=text_causal_mask,
                ff_impl=ff_impl,
                checkpoint_during_training=checkpoint_during_training,
                generator=generator, dtype=dtype)
        if image_encoder is None:
            image_encoder = VisionTransformer(
                dim=dim_image, image_size=visual_image_size,
                patch_size=visual_patch_size, channels=channels,
                patch_dropout=visual_patch_dropout, depth=visual_enc_depth,
                heads=visual_heads, dim_head=visual_dim_head,
                ff_impl=ff_impl,
                checkpoint_during_training=checkpoint_during_training,
                generator=generator, dtype=dtype)
        self.model = CLIPModel(
            text_encoder, image_encoder, dim_text=dim_text,
            dim_image=dim_image, dim_latent=dim_latent,
            text_pad_id=text_pad_id, text_causal_mask=text_causal_mask,
            text_eos_id=text_eos_id,
            text_encode_without_mask=text_encode_without_mask,
            extra_latent_projection=extra_latent_projection,
            decoupled_contrastive_learning=decoupled_contrastive_learning,
            attn_impl=attn_impl, visual_attn_impl=visual_attn_impl,
            loss_impl=loss_impl, compute_dtype=compute_dtype,
            generator=generator, dtype=dtype)
        self.sim_reg_loss_weight = sim_reg_loss_weight
        self.to(device)
        # patch-dropout draws of training calls that bring no generator
        call_seed = int(torch.randint(2 ** 62, (1,), generator=generator))
        self.call_generator = torch.Generator(device).manual_seed(call_seed)

    # reference-style attribute aliases
    @property
    def text_transformer(self):
        return self.model.text

    @property
    def visual_transformer(self):
        return self.model.visual

    @property
    def temperature(self):
        return self.model.temperature

    def forward(self, text, image,
                return_loss=False,
                return_encodings=False,
                return_latents=False,
                freeze_image_encoder=False,
                freeze_text_encoder=False,
                text_to_image=True,
                aug_text=None,
                aug_image=None,
                *,
                training=None,
                return_metrics=False,
                generator=None,
                keep_idx=None):
        """Inference scores, encodings or latents; with `return_loss` (which
        makes `training` default to True) the contrastive loss of a training
        forward, differentiable in every parameter. The freeze flags stop
        gradients only, so at inference they change nothing."""
        training = return_loss if training is None else training
        if aug_text is not None or aug_image is not None:
            if not training:
                raise ValueError("do not pass in augmented texts or images "
                                 "if not training")
            _not_ported("augmented views in training (aug_text / aug_image,"
                        " the multiview loss)", OBJECTIVES)
        if training and return_loss and self.sim_reg_loss_weight > 0:
            _not_ported("sim_reg_loss_weight > 0", OBJECTIVES)
        if training and generator is None and keep_idx is None:
            generator = self.call_generator
        return self.model(text, image, return_loss=return_loss,
                          return_encodings=return_encodings,
                          return_latents=return_latents,
                          text_to_image=text_to_image,
                          freeze_image_encoder=freeze_image_encoder,
                          freeze_text_encoder=freeze_text_encoder,
                          training=training, return_metrics=return_metrics,
                          generator=generator, keep_idx=keep_idx)
