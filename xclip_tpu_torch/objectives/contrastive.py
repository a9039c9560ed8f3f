"""Contrastive objective — the counterpart of the local dense path of
`xclip_tpu/objectives/contrastive.py` (`clip_contrastive_loss` with
`axis_name=None`, `_infonce_from_sims`): coarse InfoNCE over CLS latents in
log space, with decoupled contrastive learning (DCL) and the CLOOB extra
latent heads.

One text view and one image view: t2i = text_latents · image_latentsᵀ ·
temp; i2t is its transpose, or the extra heads' product when they are
given. Each direction's loss is the batch mean of −pos + logsumexp(row);
DCL sets the diagonal to finfo.min before the logsumexp. The CL loss is
the mean of both directions.

`loss_impl='fused'` (`_fused_infonce`, the counterpart of the JAX
`_fused_pair_losses` for one view pair) takes each direction's
log-sum-exp from K5, `kernels/fused_infonce.streaming_lse`, without the
(b, b) similarity matrix: t2i has the text rows against the image
columns, i2t the extra image rows against the extra text columns (the
mains when there are no extra heads). The rows are multiplied by the
temperature before the kernel, so its gradient flows by autograd; DCL
drops the diagonal inside the kernel.

Not ported yet (each raises `NotImplementedError` naming ROADMAP.md
Queue 1, the objectives and heads): multiview (more than one view), FILIP
token matching, similarity regularisation, the `row_valid` pad-and-mask
option. The cross-device paths are Queue 1, the row-sharded loss.
"""

from __future__ import annotations

import torch

from ..kernels.fused_infonce import streaming_lse


def _not_ported(what):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md "
                              "Queue 1, the objectives and heads")


def infonce_from_sims(text_to_image, image_to_text, decoupled: bool):
    """(b, b) paired similarity matrices (already × temp) → scalar CL loss
    (`_infonce_from_sims` for one view pair)."""
    b = text_to_image.shape[-1]
    t2i_pos = text_to_image.diagonal(dim1=-2, dim2=-1)
    i2t_pos = image_to_text.diagonal(dim1=-2, dim2=-1)
    if decoupled:
        eye = torch.eye(b, dtype=torch.bool, device=text_to_image.device)
        neg = torch.finfo(text_to_image.dtype).min
        text_to_image = text_to_image.masked_fill(eye, neg)
        image_to_text = image_to_text.masked_fill(eye, neg)
    t2i = (-t2i_pos + torch.logsumexp(text_to_image, dim=-1)).mean(dim=-1)
    i2t = (-i2t_pos + torch.logsumexp(image_to_text, dim=-1)).mean(dim=-1)
    return (t2i + i2t) / 2


def _fused_infonce(rows_lat, cols_lat, temp, decoupled):
    """One direction's InfoNCE loss through K5; positives on the diagonal
    (row offset 0: one device holds every column)."""
    xs = rows_lat * temp
    lse = streaming_lse(xs, cols_lat, 0, decoupled)
    pos = torch.einsum("bd,bd->b", xs, cols_lat)
    return (-pos + lse).sum() / xs.shape[0]


def clip_contrastive_loss(text_latents, image_latents, temp, *,
                          decoupled_contrastive_learning: bool = False,
                          text_latents_extra=None, image_latents_extra=None,
                          use_all_token_embeds: bool = False,
                          sim_reg: bool = False, row_valid=None,
                          loss_impl: str = "xla"):
    """text_latents, image_latents: (b, d) l2-normed fp32 latents; temp:
    scalar exp(temperature). Returns the scalar CL loss."""
    if text_latents.ndim != 2 or image_latents.ndim != 2:
        _not_ported("multiview and FILIP (latents other than (b, d))")
    if use_all_token_embeds:
        _not_ported("FILIP (use_all_token_embeds)")
    if sim_reg:
        _not_ported("similarity regularisation (sim_reg_loss_weight > 0)")
    if row_valid is not None:
        _not_ported("the row_valid pad-and-mask option")
    if loss_impl == "fused":
        if text_latents_extra is None:
            text_latents_extra, image_latents_extra = (text_latents,
                                                       image_latents)
        dcl = decoupled_contrastive_learning
        t2i = _fused_infonce(text_latents, image_latents, temp, dcl)
        i2t = _fused_infonce(image_latents_extra, text_latents_extra, temp,
                             dcl)
        return (t2i + i2t) / 2
    if loss_impl != "xla":
        raise ValueError(f"unknown loss_impl {loss_impl!r}")
    t2i = text_latents @ image_latents.T * temp
    if text_latents_extra is not None:
        i2t = image_latents_extra @ text_latents_extra.T * temp
    else:
        i2t = t2i.T
    return infonce_from_sims(t2i, i2t, decoupled_contrastive_learning)
