"""User-facing `CLIP` — the constructor kwargs and defaults of
`xclip_tpu.CLIP` (minus the JAX-only `key`), around `CLIPModel`.

Port additions (keyword-only): `device=` (where the parameters live: the
card, "cuda", unless the caller asks for "cpu"; a CUDA device that is not
there raises, nothing falls back to the CPU), `seed=` /
`generator=` (a `torch.Generator` for initialisation; `seed` makes one).
`forward` adds `generator=` (the randomness of a training forward: patch
dropout, custom encoders' dropout, the MLM's and the visual SSL's draws; by
default the model's own call generator, as the JAX `CLIP` folds a call
counter into its key), `keep_idx=`, `dropout_keep=`, `mlm_draws=` and
`ssl_draws=` (injected draws, see `CLIPModel.forward`), `row_valid=`,
`return_metrics=`, and JAX's `axis_name=` (here a `torch.distributed`
`ProcessGroup`) and `gather_impl=` for data parallelism. `save(path)` / `load(path)` keep and restore the
parameters and the SSL heads' BatchNorm statistics (`train.checkpoint`).

The port serves inference and trains (`return_loss=True`, and
`train.make_train_step`) with every objective of the JAX `CLIP`: FILIP
(`use_all_token_embeds`, `filip_block`, `downsample_image_embeds`), DCL,
the extra latent heads, DeCLIP's MLM (`use_mlm` and the `mlm_*` kwargs),
SimSiam or SimCLR (`use_visual_ssl`, `visual_ssl_type`, or the port's own
`objectives.ssl.SimSiam` / `SimCLR` as `visual_ssl`), multiview
(`aug_text` / `aug_image`) and similarity regularisation; and remat
(`checkpoint_during_training`, whose `remat_policy` is None, 'dots' or
'wide'; `nn.layers`). `scan_layers` is a JAX compilation choice: layers
are always an `nn.ModuleList` here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .model import CLIPModel, as_dtype
from .nn.layers import check_impls
from .nn.text import TextTransformer
from .nn.vision import VisionTransformer
from .objectives.mlm import MLM
from .objectives.ssl import SimCLR, SimSiam
from .train.checkpoint import restore_checkpoint, save_checkpoint


def groupby_prefix_and_trim(prefix: str, d: dict):
    """kwargs routing helper (`xclip_tpu/api.py:52-56`)."""
    with_prefix = {k[len(prefix):]: v for k, v in d.items()
                   if k.startswith(prefix)}
    without = {k: v for k, v in d.items() if not k.startswith(prefix)}
    return with_prefix, without


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
        mlm_kwargs = {}
        if use_mlm:
            mlm_kwargs, kwargs = groupby_prefix_and_trim("mlm_", kwargs)
        use_visual_ssl = use_visual_ssl or (visual_ssl is not None)
        if visual_ssl is None and use_visual_ssl:
            if visual_ssl_type == 'simsiam':
                visual_ssl = SimSiam(
                    image_size=visual_image_size, channels=channels,
                    hidden_layer=visual_ssl_hidden_layer)
            elif visual_ssl_type == 'simclr':
                visual_ssl = SimCLR(
                    image_size=visual_image_size, channels=channels,
                    temperature=simclr_temperature,
                    hidden_layer=visual_ssl_hidden_layer)
            else:
                raise ValueError('unknown visual_ssl_type')
        if kwargs:
            raise TypeError(f"unexpected CLIP kwargs: {sorted(kwargs)}")
        if loss_impl not in ("xla", "fused"):
            raise ValueError(f"unknown loss_impl {loss_impl!r}")
        check_impls(attn_impl, ff_impl, remat_policy)
        check_impls(visual_attn_impl or attn_impl, ff_impl)

        device = _resolve_device(device)
        dtype = as_dtype(param_dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        if text_encoder is None:
            text_encoder = TextTransformer(
                dim=dim_text, num_tokens=num_text_tokens + (1 if use_mlm
                                                            else 0),
                max_seq_len=text_seq_len, depth=text_enc_depth,
                heads=text_heads, dim_head=text_dim_head,
                rotary_pos_emb=text_rotary_pos_emb, causal=text_causal_mask,
                ff_impl=ff_impl,
                checkpoint_during_training=checkpoint_during_training,
                remat_policy=remat_policy, generator=generator, dtype=dtype)
        if image_encoder is None:
            image_encoder = VisionTransformer(
                dim=dim_image, image_size=visual_image_size,
                patch_size=visual_patch_size, channels=channels,
                patch_dropout=visual_patch_dropout, depth=visual_enc_depth,
                heads=visual_heads, dim_head=visual_dim_head,
                ff_impl=ff_impl,
                checkpoint_during_training=checkpoint_during_training,
                remat_policy=remat_policy, generator=generator, dtype=dtype)
        mlm = None
        if use_mlm:
            if 'mask_ignore_token_ids' in mlm_kwargs:
                mlm_kwargs['mask_ignore_token_ids'] = tuple(
                    mlm_kwargs['mask_ignore_token_ids'])
            mlm = MLM(dim=dim_text, num_tokens=num_text_tokens, **mlm_kwargs,
                      generator=generator, dtype=dtype)
        self.model = CLIPModel(
            text_encoder, image_encoder, dim_text=dim_text,
            dim_image=dim_image, dim_latent=dim_latent,
            text_pad_id=text_pad_id, text_has_cls_token=text_has_cls_token,
            visual_has_cls_token=visual_has_cls_token,
            text_causal_mask=text_causal_mask, text_eos_id=text_eos_id,
            text_encode_without_mask=text_encode_without_mask,
            use_all_token_embeds=use_all_token_embeds,
            downsample_image_embeds=downsample_image_embeds,
            extra_latent_projection=extra_latent_projection,
            decoupled_contrastive_learning=decoupled_contrastive_learning,
            mlm=mlm, text_ssl_loss_weight=text_ssl_loss_weight if use_mlm
            else 0, visual_ssl=visual_ssl,
            image_ssl_loss_weight=(image_ssl_loss_weight if use_visual_ssl
                                   else 0),
            multiview_loss_weight=multiview_loss_weight,
            sim_reg_loss_weight=sim_reg_loss_weight,
            attn_impl=attn_impl, visual_attn_impl=visual_attn_impl,
            loss_impl=loss_impl, filip_block=filip_block,
            compute_dtype=compute_dtype, generator=generator, dtype=dtype)
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

    def save(self, path: str) -> None:
        """Keep the parameters in `path` (`xclip_tpu/api.py:238-243`)."""
        save_checkpoint(path, self)

    def load(self, path: str) -> None:
        """Restore parameters kept by `save` into this model, in place, on
        its device."""
        restore_checkpoint(path, self)

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
                keep_idx=None,
                dropout_keep=None,
                row_valid=None,
                mlm_draws=None,
                ssl_draws=None,
                axis_name=None,
                gather_impl="sharded"):
        """Inference scores, encodings or latents; with `return_loss` (which
        makes `training` default to True) the loss of a training forward
        with every objective the model has, differentiable in every
        parameter. The freeze flags stop gradients only, so at inference
        they change nothing."""
        training = return_loss if training is None else training
        if training and generator is None:
            generator = self.call_generator
        return self.model(text, image, return_loss=return_loss,
                          return_encodings=return_encodings,
                          return_latents=return_latents,
                          text_to_image=text_to_image,
                          freeze_image_encoder=freeze_image_encoder,
                          freeze_text_encoder=freeze_text_encoder,
                          aug_text=aug_text, aug_image=aug_image,
                          training=training, return_metrics=return_metrics,
                          generator=generator, keep_idx=keep_idx,
                          dropout_keep=dropout_keep, row_valid=row_valid,
                          mlm_draws=mlm_draws, ssl_draws=ssl_draws,
                          axis_name=axis_name, gather_impl=gather_impl)
