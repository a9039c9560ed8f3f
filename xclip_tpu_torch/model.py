"""CLIP core — the counterpart of `xclip_tpu/model.py`'s `CLIPModel`:
single-tower encoders, encodings, l2-normed fp32 latents, paired
similarity scores × exp(temperature), and the training forward with the
full objective (`return_loss=True`): the contrastive loss over every view
pair (multiview), FILIP's token matching, similarity regularisation,
DeCLIP's MLM and the visual SSL (SimSiam / SimCLR) over the shared towers.
A causal text tower (no CLS) is pooled at its first EOS token, moved to
position 0 (`_eos_reorder`).

Mixed precision follows the JAX model: with `compute_dtype`, the images
are cast to it on entry and every float parameter, BatchNorm statistics
included, is rounded to it before it meets an activation (the forward
and the encoders run under `nn.core.computing_in(compute_dtype)`; the
modules cast each rounded parameter to the dtype of the activation they
are given, which is fp32 on the SSL views); latents are normalised in
fp32 and exp(temperature) is taken in fp32. Augmented views are
concatenated as given (an fp32 view promotes the batch, as
`jnp.concatenate` does).

Inference (training False) runs under `torch.no_grad()` through the
kernels' lean forwards. Training (the default when `return_loss`) runs the
kernels' training routes with autograd, FLIP patch dropout in the vision
tower and custom encoders' dropout; the LiT freeze flags detach a tower's
encodings. The order of the objective is JAX's (`model.py:226-440`): the
MLM pass, then the visual SSL passes, then the multiview concat and the
two towers, then the losses; the loss is
  cl_loss · (1 − text_ssl_w − image_ssl_w − multiview_w)
  + text_ssl_loss · text_ssl_w + image_ssl_loss · image_ssl_w
  + mean(multiview losses) · multiview_w + sim_reg_loss · sim_reg_w,
each weight 0 where its feature is off.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .nn.core import Linear, _uniform, cast, computing_in
from .objectives.contrastive import clip_contrastive_loss
from .parallel.collectives import pmean
from .utils import cast_tuple, l2norm


def as_dtype(d) -> Optional[torch.dtype]:
    """torch dtype from a torch dtype, a name ('bfloat16') or None."""
    if isinstance(d, str):
        name, d = d, getattr(torch, d, None)
        if not isinstance(d, torch.dtype):
            raise ValueError(f"unknown dtype name {name!r}")
    return d


class ConvWeights(nn.Module):
    """A convolution's weight `w` (out, in / groups, k, k) and optional
    bias `b`, U(±1/sqrt(fan_in)) as `_conv_init`."""

    def __init__(self, out_c, in_c_per_group, k, *, bias=False,
                 generator=None, dtype=torch.float32):
        super().__init__()
        bound = 1.0 / math.sqrt(in_c_per_group * k * k)
        self.w = nn.Parameter(_uniform((out_c, in_c_per_group, k, k), bound,
                                       generator, dtype))
        self.b = (nn.Parameter(_uniform((out_c,), bound, generator, dtype))
                  if bias else None)


class DownsampleLatent(nn.Module):
    """`downsample_image_embeds`'s latent head (`model.py:137-155`): the
    square token grid through a depthwise 4×4 convolution, stride 2,
    padding 1, then a 1×1 convolution with bias: (b, h·h, d) → (b,
    (h/2)², dim_latent)."""

    def __init__(self, dim_image, dim_latent, *, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.dw = ConvWeights(dim_image, 1, 4, generator=generator,
                              dtype=dtype)
        self.pw = ConvWeights(dim_latent, dim_image, 1, bias=True,
                              generator=generator, dtype=dtype)

    def forward(self, image_embeds):
        b, i, d = image_embeds.shape
        h = int(math.sqrt(i))
        if h * h != i:
            raise AssertionError("downsample_image_embeds requires a square "
                                 "token grid (disable patch dropout on this "
                                 "path)")
        dt = image_embeds.dtype
        x = image_embeds.transpose(1, 2).reshape(b, d, h, h)
        x = F.conv2d(x, cast(self.dw.w, dt), stride=2, padding=1, groups=d)
        x = F.conv2d(x, cast(self.pw.w, dt)) + cast(self.pw.b, dt)[
            None, :, None, None]
        return x.reshape(b, x.shape[1], -1).transpose(1, 2)


class CLIPModel(nn.Module):
    def __init__(self, text_encoder, visual_encoder, *, dim_text: int = 512,
                 dim_image: int = 512, dim_latent: int = 512,
                 text_pad_id: int = 0, text_has_cls_token: bool = True,
                 visual_has_cls_token: bool = True,
                 text_causal_mask: bool = False,
                 text_eos_id: Optional[int] = None,
                 text_encode_without_mask: bool = False,
                 use_all_token_embeds: bool = False,
                 downsample_image_embeds: bool = False,
                 decoupled_contrastive_learning: bool = False,
                 extra_latent_projection: bool = False,
                 mlm=None, text_ssl_loss_weight: float = 0.0,
                 visual_ssl=None, image_ssl_loss_weight: float = 0.0,
                 multiview_loss_weight: float = 0.1,
                 sim_reg_loss_weight: float = 0.0,
                 attn_impl: str = "xla",
                 visual_attn_impl: Optional[str] = None,
                 loss_impl: str = "xla", filip_block: Optional[int] = None,
                 compute_dtype=None, generator=None, dtype=torch.float32):
        """`mlm`: an `objectives.mlm.MLM` or None; `visual_ssl`: an
        `objectives.ssl.SimSiam` / `SimCLR` (its heads built here for
        `visual_encoder` when it has none) or None."""
        super().__init__()
        # JAX's assertions (`model.py:88-96`), in its words
        if not (use_all_token_embeds or visual_has_cls_token
                or text_has_cls_token):
            raise AssertionError(
                "CLS token must be included on both vision and text "
                "transformers if you are not using fine-grained "
                "contrastive learning loss")
        if text_causal_mask and text_eos_id is None:
            raise AssertionError(
                "text EOS token id must be given if using causal mask in "
                "text transformer")
        if downsample_image_embeds and not use_all_token_embeds:
            raise AssertionError(
                "must be using all token embeds for contrastive learning in "
                "order to downsampling")
        self.text = text_encoder
        self.visual = visual_encoder
        self.text_pad_id = text_pad_id
        self.text_has_cls_token = text_has_cls_token
        self.visual_has_cls_token = visual_has_cls_token
        self.text_causal_mask, self.text_eos_id = text_causal_mask, text_eos_id
        self.text_encode_without_mask = text_encode_without_mask
        self.use_all_token_embeds = use_all_token_embeds
        self.extra_latent_projection = extra_latent_projection
        self.decoupled_contrastive_learning = decoupled_contrastive_learning
        self.text_ssl_loss_weight = text_ssl_loss_weight
        self.image_ssl_loss_weight = image_ssl_loss_weight
        self.multiview_loss_weight = multiview_loss_weight
        self.sim_reg_loss_weight = sim_reg_loss_weight
        self.attn_impl = attn_impl
        self.visual_attn_impl = visual_attn_impl or attn_impl
        self.loss_impl, self.filip_block = loss_impl, filip_block
        self.compute_dtype = as_dtype(compute_dtype)
        kw = dict(generator=generator, dtype=dtype)
        self.to_text_latent = Linear(dim_text, dim_latent, **kw)
        self.to_visual_latent = (
            DownsampleLatent(dim_image, dim_latent, **kw)
            if downsample_image_embeds else Linear(dim_image, dim_latent,
                                                   **kw))
        # always allocated, initialised as copies of the main heads
        self.to_text_latent_extra = copy.deepcopy(self.to_text_latent)
        self.to_visual_latent_extra = copy.deepcopy(self.to_visual_latent)
        self.temperature = nn.Parameter(torch.ones((), dtype=dtype))
        self.mlm = mlm
        if visual_ssl is not None and visual_ssl.projector is None:
            visual_ssl.build(visual_encoder, **kw)
        self.visual_ssl = visual_ssl

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
        return self.visual(image, attn_impl=self.visual_attn_impl,
                           training=training, generator=generator,
                           keep_idx=keep_idx, dropout_keep=dropout_keep)

    def _cast_image(self, image):
        if self.compute_dtype is not None:
            image = image.to(self.compute_dtype)
        return image

    def _embeds(self, enc, has_cls):
        """FILIP's token embeddings (past the CLS), else the CLS's."""
        if self.use_all_token_embeds:
            return enc[:, 1:] if has_cls else enc
        return enc[:, 0]

    @staticmethod
    def _latent(head, embeds):
        return l2norm(head(embeds).float())

    @torch.no_grad()
    def encode_text(self, text):
        """(b, n) token ids → (b, dim_latent) l2-normed fp32 latents ((b,
        n, dim_latent) per token with FILIP)."""
        with computing_in(self.compute_dtype):
            return self._latent(self.to_text_latent, self._embeds(
                self._encode_text(text), self.text_has_cls_token))

    @torch.no_grad()
    def encode_image(self, image):
        """(b, c, H, W) images → (b, dim_latent) l2-normed fp32 latents (per
        token with FILIP)."""
        with computing_in(self.compute_dtype):
            return self._latent(self.to_visual_latent, self._embeds(
                self._encode_image(self._cast_image(image)),
                self.visual_has_cls_token))

    def forward(self, text, image, *, return_loss: bool = False,
                return_encodings: bool = False,
                return_latents: bool = False, text_to_image: bool = True,
                freeze_image_encoder: bool = False,
                freeze_text_encoder: bool = False, aug_text=None,
                aug_image=None, training=None, return_metrics: bool = False,
                generator=None, keep_idx=None, dropout_keep=None,
                row_valid=None, mlm_draws=None, ssl_draws=None,
                axis_name=None, gather_impl: str = "sharded"):
        """As `xclip_tpu.model.CLIPModel.apply`. `training` defaults to
        `return_loss`. `aug_text` / `aug_image`: augmented views (a tensor
        or a tuple of them, each the shape of `text` / `image`), training
        only; their losses are the multiview ones. `row_valid` (b,) bool
        marks the rows of a padded short batch that count (plain InfoNCE
        only). With `return_loss`, returns the loss, and with
        `return_metrics` also JAX's dict: `loss`, `cl_loss`,
        `text_ssl_loss`, `image_ssl_loss`, `multiview_cl_loss`,
        `sim_reg_loss` (0 where the feature is off), `temperature` =
        exp(temperature), and with a visual SSL head `bn_updates`, its
        BatchNorm statistics' new values ({module path: (mean, var)}, which
        `fold_bn_updates` writes into the buffers).

        Data parallelism (`model.py:237-238`, `:394-407`): under
        `axis_name`, a `torch.distributed` `ProcessGroup` whose ranks each
        hold an equal shard of the global batch (`train.shard_batch`), the
        contrastive loss brings in the other ranks' latents as
        `gather_impl` says ('sharded': local rows against gathered
        columns; 'replicated': the whole batch on every rank;
        `objectives.contrastive`) and is the global batch's; the MLM and
        visual SSL losses are this shard's, averaged over the ranks
        (`parallel.pmean`). Summing the ranks' parameter gradients then
        gives the gradient of that loss (`train.make_train_step`).

        The randomness of a training forward comes from `generator` (by
        default PyTorch's), or is injected, as JAX's and PyTorch's random
        numbers never agree:
          * `keep_idx`: the main vision pass's patch indices ((b·views,
            kept));
          * `dropout_keep`: custom encoders' dropout keep masks, a dict with
            'text' and 'visual', each a list per layer of its sites' masks;
          * `mlm_draws`: the MLM's draws, a dict of (b, n) tensors
            `subset`, `replace` and, with random-token corruption, `random`
            and `random_tokens` (`objectives.mlm`);
          * `ssl_draws`: the visual SSL's draws, a dict with `augment` (the
            two views' augmentation draws, `objectives.augment`) and
            `keep_idx` (the patch indices of its tower passes in order:
            SimSiam's online one, online two, target one, target two;
            SimCLR's queries, keys) (`objectives.ssl`).
        """
        training = return_loss if training is None else training
        if return_loss and not training:
            raise ValueError("loss cannot be used if not training")
        if row_valid is not None and (self.mlm is not None
                                      or self.visual_ssl is not None):
            raise AssertionError(   # JAX's assertion, in its words
                "row_valid only masks the contrastive loss; disable "
                "use_mlm / use_visual_ssl or drop the final short batch")
        with contextlib.nullcontext() if training else torch.no_grad(), \
                computing_in(self.compute_dtype):
            return self._forward(
                text, image, return_loss, return_encodings, return_latents,
                text_to_image, freeze_image_encoder, freeze_text_encoder,
                aug_text, aug_image, training, return_metrics, generator,
                keep_idx, dropout_keep or {}, row_valid, mlm_draws,
                ssl_draws, axis_name, gather_impl)

    def _forward(self, text, image, return_loss, return_encodings,
                 return_latents, text_to_image, freeze_image_encoder,
                 freeze_text_encoder, aug_text, aug_image, training,
                 return_metrics, generator, keep_idx, keep, row_valid,
                 mlm_draws, ssl_draws, axis_name, gather_impl):
        image = self._cast_image(image)
        text_mask = text != self.text_pad_id
        zero = torch.zeros((), dtype=torch.float32, device=text.device)
        text_ssl_loss = image_ssl_loss = zero
        if return_loss and self.mlm is not None:
            text_ssl_loss = self.mlm(
                self.text, text, mask=text_mask, training=training,
                attn_impl=self.attn_impl, dtype=self._dtype(),
                generator=generator, draws=mlm_draws)
        bn_updates = None
        if return_loss and self.visual_ssl is not None:
            image_ssl_loss, bn_updates = self.visual_ssl(
                self.visual, image, training=training,
                attn_impl=self.visual_attn_impl, generator=generator,
                draws=ssl_draws, dtype=self._dtype())

        # the multiview concat (`model.py:290-305`)
        num_texts = num_images = 1
        if aug_text is not None:
            aug_text = cast_tuple(aug_text)
            if any(t.shape != text.shape for t in aug_text):
                raise AssertionError("augmented texts must have the shape "
                                     "of the texts")
            num_texts = len(aug_text) + 1
            text = torch.cat([text, *aug_text], dim=0)
            text_mask = text != self.text_pad_id
        if aug_image is not None:
            aug_image = cast_tuple(aug_image)
            if any(i.shape != image.shape for i in aug_image):
                raise AssertionError("augmented images must have the shape "
                                     "of the images")
            num_images = len(aug_image) + 1
            image = torch.cat([image, *aug_image], dim=0)
        multiview = num_texts > 1 or num_images > 1
        if not return_loss and multiview:
            raise ValueError("do not pass in augmented texts or images if "
                             "not training")
        if self.multiview_loss_weight == 0 and multiview:
            raise AssertionError("multiview loss weight cannot be 0 if "
                                 "augmented text or images passed in")

        enc_text = self._encode_text(text, training, generator,
                                     keep.get("text"))
        if freeze_text_encoder:
            enc_text = enc_text.detach()
        enc_image = self._encode_image(image, training, generator, keep_idx,
                                       keep.get("visual"))
        if freeze_image_encoder:
            enc_image = enc_image.detach()
        if return_encodings:
            return enc_text, enc_image
        text_embeds = self._embeds(enc_text, self.text_has_cls_token)
        image_embeds = self._embeds(enc_image, self.visual_has_cls_token)
        tl = self._latent(self.to_text_latent, text_embeds)
        il = self._latent(self.to_visual_latent, image_embeds)
        tl_extra, il_extra = tl, il
        extra = self.extra_latent_projection
        if extra:
            tl_extra = self._latent(self.to_text_latent_extra, text_embeds)
            il_extra = self._latent(self.to_visual_latent_extra,
                                    image_embeds)
        if return_latents:
            return (tl, il, tl_extra, il_extra) if extra else (tl, il)
        temp = self.temperature.to(self._dtype()).float().exp()
        if not return_loss:
            if extra and not text_to_image:
                tl, il = tl_extra, il_extra
            if self.use_all_token_embeds:
                return torch.einsum("btd,bid->bti", tl, il) * temp
            return (tl * il).sum(dim=-1) * temp

        def views(t, m):
            return t.reshape(m, t.shape[0] // m, *t.shape[1:])

        cl_losses, sim_reg_loss = clip_contrastive_loss(
            views(tl, num_texts), views(il, num_images), temp,
            text_mask=text_mask if self.use_all_token_embeds else None,
            use_all_token_embeds=self.use_all_token_embeds,
            decoupled_contrastive_learning=(
                self.decoupled_contrastive_learning),
            text_latents_extra=views(tl_extra, num_texts) if extra else None,
            image_latents_extra=(views(il_extra, num_images) if extra
                                 else None),
            sim_reg=self.sim_reg_loss_weight > 0.0, row_valid=row_valid,
            loss_impl=self.loss_impl, filip_block=self.filip_block,
            axis_name=axis_name, gather_impl=gather_impl)
        cl_loss, multiview_cl_loss = cl_losses[0], cl_losses[1:]
        if axis_name is not None:   # this shard's SSL losses, averaged
            text_ssl_loss = pmean(text_ssl_loss, axis_name)
            image_ssl_loss = pmean(image_ssl_loss, axis_name)

        # the weighted total (`model.py:412-421`)
        text_ssl_w = self.text_ssl_loss_weight if self.mlm is not None else 0.0
        image_ssl_w = (self.image_ssl_loss_weight
                       if self.visual_ssl is not None else 0.0)
        multiview_w = self.multiview_loss_weight if multiview else 0.0
        cl_loss_weight = 1.0 - (text_ssl_w + image_ssl_w + multiview_w)
        loss = (cl_loss * cl_loss_weight + text_ssl_loss * text_ssl_w
                + image_ssl_loss * image_ssl_w)
        if multiview:
            loss = loss + multiview_cl_loss.mean() * multiview_w
        if self.sim_reg_loss_weight > 0.0:
            loss = loss + sim_reg_loss * self.sim_reg_loss_weight
        if not return_metrics:
            return loss
        metrics = {"loss": loss, "cl_loss": cl_loss,
                   "text_ssl_loss": text_ssl_loss,
                   "image_ssl_loss": image_ssl_loss,
                   "multiview_cl_loss": (multiview_cl_loss.mean()
                                         if multiview else zero),
                   "sim_reg_loss": sim_reg_loss, "temperature": temp}
        if bn_updates is not None:
            metrics["bn_updates"] = {f"visual_ssl.{k.replace('/', '.')}": v
                                     for k, v in bn_updates.items()}
        return loss, metrics

    @torch.no_grad()
    def fold_bn_updates(self, bn_updates):
        """Write `bn_updates` ({BatchNorm module path: (mean, var)}) into
        the modules' running statistics, in their stored dtype
        (`trainer.py:44-56`)."""
        for path, (mean, var) in bn_updates.items():
            bn = self.get_submodule(path)
            bn.mean.copy_(mean.to(bn.mean.dtype))
            bn.var.copy_(var.to(bn.var.dtype))
