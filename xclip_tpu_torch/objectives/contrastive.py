"""Contrastive objectives — the counterpart of the local path of
`xclip_tpu/objectives/contrastive.py` (`clip_contrastive_loss` with
`axis_name=None`): InfoNCE in log space with decoupled contrastive
learning (DCL) and the CLOOB extra latent heads, DeCLIP's multiview,
FILIP's token matching, and similarity regularisation.

Latents come as views: (m, b, d) texts and (n, b, d) images, or per token
(m, b, t, d) and (n, b, i, d) for FILIP. Every (text view, image view)
pair gives one CL loss, in JAX's (m n) order; `cl_losses[0]` is the main
pair's, the rest are the multiview losses. t2i = text · imageᵀ · temp; i2t
its transpose, or the extra heads' product when they are given. Each
direction's loss is the batch mean of −pos + logsumexp(row); DCL sets the
diagonal to finfo.min before the logsumexp; the pair's loss is the mean of
both directions.

`loss_impl='fused'` (`_fused_pair_losses`) takes each direction's
log-sum-exp from K5, `kernels/fused_infonce.streaming_lse`, without the
(b, b) similarity matrix: for every view pair, t2i has the text rows
against the image columns, i2t the extra image rows against the extra
text columns (the mains when there are no extra heads). The rows are
multiplied by the temperature before the kernel, so its gradient flows by
autograd; DCL drops the diagonal inside the kernel.

FILIP (`use_all_token_embeds`, `contrastive.py:484-503`): t2i is the mean
over the text's unpadded tokens of each token's max over the image's
tokens; i2t the mean over image tokens of each one's max over the text's
unpadded tokens (pads filled with −finfo.max; JAX's orientation: both
(text row, image column)). Max reductions split a tie's gradient evenly,
as JAX's do (`amax`). With `filip_block`, the image columns are taken a
block at a time, each block reduced straight to (b, block) under
non-reentrant `torch.utils.checkpoint` (JAX's `jax.checkpoint` step), so
neither direction keeps a (b, b, t, i) score tensor; with extra heads each
direction is computed once, from its own latents.

Similarity regularisation (`sim_reg`): the mean squared difference of the
off-diagonal text-text and image-image self-similarities, averaged over
the main and extra latents; computed before the loss is chosen, so it also
holds with `loss_impl='fused'`; not with FILIP.

`row_valid` (b,) bool, the pad-and-mask option for a final short batch
(`contrastive.py:251-262`): invalid columns leave every denominator,
invalid rows the mean, which divides by the count of valid rows. Only the
plain loss takes it (`loss_impl='xla'`, no FILIP, no sim-reg), as in JAX.

The cross-device paths (`axis_name`) are ROADMAP.md Queue 1, the
row-sharded loss.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.fused_infonce import streaming_lse
from ..utils import masked_mean


def infonce_from_sims(text_to_image, image_to_text, decoupled: bool,
                      valid=None):
    """(v, b, b) paired similarity matrices (already × temp) → (v,) CL
    losses (`_infonce_from_sims`); `valid` (b,) bool as `row_valid`. The
    positives are taken before any masking."""
    b = text_to_image.shape[-1]
    t2i_pos = text_to_image.diagonal(dim1=-2, dim2=-1)
    i2t_pos = image_to_text.diagonal(dim1=-2, dim2=-1)
    neg = torch.finfo(text_to_image.dtype).min
    if decoupled:
        eye = torch.eye(b, dtype=torch.bool, device=text_to_image.device)
        text_to_image = text_to_image.masked_fill(eye, neg)
        image_to_text = image_to_text.masked_fill(eye, neg)
    if valid is not None:
        text_to_image = torch.where(valid[None, None, :], text_to_image, neg)
        image_to_text = torch.where(valid[None, None, :], image_to_text, neg)
    t2i = -t2i_pos + torch.logsumexp(text_to_image, dim=-1)
    i2t = -i2t_pos + torch.logsumexp(image_to_text, dim=-1)
    if valid is None:
        return (t2i.mean(dim=-1) + i2t.mean(dim=-1)) / 2
    w = valid.to(t2i.dtype)[None, :]
    count = w.sum()
    return ((t2i * w).sum(dim=-1) / count + (i2t * w).sum(dim=-1) / count) / 2


def _fused_infonce(rows_lat, cols_lat, temp, decoupled):
    """One direction's InfoNCE loss through K5; positives on the diagonal
    (row offset 0: one device holds every column)."""
    xs = rows_lat * temp
    lse = streaming_lse(xs, cols_lat, 0, decoupled)
    pos = torch.einsum("bd,bd->b", xs, cols_lat)
    return (-pos + lse).sum() / xs.shape[0]


def _fused_pair_losses(text_latents, image_latents, text_latents_extra,
                       image_latents_extra, temp, decoupled):
    """Every (m × n) view pair's CL loss through K5, in JAX's (m n) order
    (`contrastive.py:65-81`); i2t takes the extra latents (the mains when
    there are no extra heads)."""
    cl = []
    for mi in range(text_latents.shape[0]):
        for ni in range(image_latents.shape[0]):
            t2i = _fused_infonce(text_latents[mi], image_latents[ni], temp,
                                 decoupled)
            i2t = _fused_infonce(image_latents_extra[ni],
                                 text_latents_extra[mi], temp, decoupled)
            cl.append((t2i + i2t) / 2)
    return torch.stack(cl)


def _filip_t2i(sim, tmask):
    """(…, x, y, t, i) scores → (…, x, y): the masked mean over text tokens
    of the max over image tokens; tmask broadcasts as (…, x, 1, t)."""
    return masked_mean(torch.amax(sim, dim=-1), tmask, dim=-1)


def _filip_i2t(sim, tmask):
    """(…, x, y, t, i) scores → (…, x, y): the mean over image tokens of
    the max over the unpadded text tokens."""
    neg = -torch.finfo(sim.dtype).max
    masked = torch.where(tmask[..., None], sim, neg)
    return torch.amax(masked, dim=-2).mean(dim=-1)


def _filip_block_step(text_tok, y_blk, tmask, temp, directions):
    sim = torch.einsum("xtd,yid->xyti", text_tok, y_blk) * temp
    outs = []
    if directions in ("both", "t2i"):
        outs.append(_filip_t2i(sim, tmask[:, None, :]))
    if directions in ("both", "i2t"):
        outs.append(_filip_i2t(sim, tmask[:, None, :]))
    return tuple(outs)


def filip_sims_blocked(text_tok, img_tok, tmask, temp, block,
                       directions: str = "both"):
    """FILIP's (b, B) t2i and i2t matrices (None for a direction not in
    `directions`: "both", "t2i" or "i2t") from text tokens (b, t, d), image
    tokens (B, i, d) and the text mask (b, t), the image columns `block` at
    a time, each step recomputed in the backward (`_filip_sims_blocked`)."""
    B = img_tok.shape[0]
    if B % block:
        raise AssertionError(f"filip_block ({block}) must evenly divide the "
                             f"gathered batch ({B})")
    steps = [checkpoint(_filip_block_step, text_tok,
                        img_tok[j:j + block], tmask, temp, directions,
                        use_reentrant=False)
             for j in range(0, B, block)]
    outs = [torch.cat(parts, dim=1) for parts in zip(*steps)]
    t2i = outs[0] if directions in ("both", "t2i") else None
    i2t = outs[-1] if directions in ("both", "i2t") else None
    return t2i, i2t


def _sim_reg(text_latents, image_latents, text_latents_extra,
             image_latents_extra):
    """`contrastive.py:443-461`."""
    batch = text_latents.shape[1]
    off_diag = ~torch.eye(batch, dtype=torch.bool,
                          device=text_latents.device)
    count = off_diag.sum()

    def self_sim(t):
        return torch.einsum("mid,mjd->mij", t, t)

    def off_diag_mse(a, b):
        diff2 = torch.where(off_diag[None], (self_sim(a) - self_sim(b)) ** 2,
                            0.0)
        return diff2.sum() / (a.shape[0] * count)

    return (off_diag_mse(text_latents, image_latents)
            + off_diag_mse(text_latents_extra, image_latents_extra)) / 2


def clip_contrastive_loss(text_latents, image_latents, temp, *,
                          text_mask=None,
                          decoupled_contrastive_learning: bool = False,
                          text_latents_extra=None, image_latents_extra=None,
                          use_all_token_embeds: bool = False,
                          sim_reg: bool = False, row_valid=None,
                          loss_impl: str = "xla", filip_block=None):
    """text_latents (m, b, d) or (m, b, t, d), image_latents (n, b, d) or
    (n, b, i, d): l2-normed fp32 latents; temp: scalar exp(temperature);
    text_mask (m·b, t) for FILIP. Returns ((m·n,) CL losses, the sim-reg
    loss)."""
    if row_valid is not None:
        if use_all_token_embeds or sim_reg or loss_impl == "fused":
            raise AssertionError(   # JAX's assertion, in its words
                "row_valid requires the plain InfoNCE loss (loss_impl="
                "'xla', no FILIP, no sim_reg)")
        row_valid = row_valid.to(text_latents.device, torch.bool)
    if loss_impl not in ("xla", "fused"):
        raise ValueError(f"unknown loss_impl {loss_impl!r}")
    dcl = decoupled_contrastive_learning
    has_extra = text_latents_extra is not None
    if not has_extra:
        text_latents_extra, image_latents_extra = text_latents, image_latents
    num_batch_texts, batch = text_latents.shape[:2]

    sim_reg_loss = torch.zeros((), dtype=text_latents.dtype,
                               device=text_latents.device)
    if sim_reg:
        if use_all_token_embeds:
            raise AssertionError(
                "sim_reg with fine-grained token latents is undefined "
                "(text/image token counts differ); the reference path is "
                "broken there too")
        sim_reg_loss = _sim_reg(text_latents, image_latents,
                                text_latents_extra, image_latents_extra)

    if use_all_token_embeds:
        if text_mask is None:
            raise AssertionError("FILIP loss requires the text padding mask")
        if filip_block is not None:
            tmask = text_mask.reshape(num_batch_texts, batch, -1)
            t2i_rows, i2t_rows = [], []
            for mi in range(num_batch_texts):
                for ni in range(image_latents.shape[0]):
                    t2i, i2t = filip_sims_blocked(
                        text_latents[mi], image_latents[ni], tmask[mi], temp,
                        filip_block, "t2i" if has_extra else "both")
                    if has_extra:
                        _, i2t = filip_sims_blocked(
                            text_latents_extra[mi], image_latents_extra[ni],
                            tmask[mi], temp, filip_block, "i2t")
                    t2i_rows.append(t2i)
                    i2t_rows.append(i2t)
            return infonce_from_sims(torch.stack(t2i_rows),
                                     torch.stack(i2t_rows), dcl), \
                sim_reg_loss
        sim_t2i = torch.einsum("mxtd,nyid->mnxyti", text_latents,
                               image_latents) * temp
        sim_i2t = sim_t2i
        if has_extra:
            sim_i2t = torch.einsum("mxtd,nyid->mnxyti", text_latents_extra,
                                   image_latents_extra) * temp
        tmask = text_mask.reshape(num_batch_texts, 1, batch, 1, -1)
        text_to_image = _filip_t2i(sim_t2i, tmask).reshape(-1, batch, batch)
        image_to_text = _filip_i2t(sim_i2t, tmask).reshape(-1, batch, batch)
    elif loss_impl == "fused":
        return _fused_pair_losses(text_latents, image_latents,
                                  text_latents_extra, image_latents_extra,
                                  temp, dcl), sim_reg_loss
    else:
        t2i = torch.einsum("mtd,nid->mnti", text_latents, image_latents) * temp
        i2t = t2i.transpose(-1, -2)
        if has_extra:
            i2t = torch.einsum("mtd,nid->mnit", text_latents_extra,
                               image_latents_extra) * temp
        text_to_image = t2i.reshape(-1, batch, batch)
        image_to_text = i2t.reshape(-1, batch, batch)
    return infonce_from_sims(text_to_image, image_to_text, dcl,
                             row_valid), sim_reg_loss
