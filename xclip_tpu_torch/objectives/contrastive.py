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

Across ranks (`axis_name`, a `torch.distributed` `ProcessGroup` whose
every rank holds b_local rows of the global batch B = b_local · world, in
rank order; `parallel.collectives`):
  * `gather_impl='sharded'` (`_sharded_contrastive_loss`,
    `contrastive.py:223-350`): this rank's rows against the gathered
    columns, (b_local, B) blocks; the positive of local row r is global
    column row_offset + r, row_offset = rank · b_local; each direction's
    sum over the rows is psum'd and divided by B (by the psum of the valid
    rows with `row_valid`, whose gathered copy masks the columns). K5
    takes the row offset for its DCL diagonal; FILIP has the local texts
    as rows and the gathered images as columns in both directions, and
    `filip_block` must divide B; sim-reg takes the local rows of the
    self-similarities against the gathered columns over B·(B − 1) pairs.
  * `gather_impl='replicated'` (`contrastive.py:404-436`): the four
    latents, `row_valid` and FILIP's `text_mask` are gathered, and every
    rank runs the local loss on the whole batch; its gradient is divided
    by the world size (`parallel.replicated`), as JAX's shard_map divides
    the cotangent of a replicated output.
Either way the loss is the same on every rank, and the gradients that
reach this rank's latents (the gathers' backward sums every rank's
contribution) are those of the global loss.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.fused_infonce import streaming_lse
from ..parallel.collectives import (all_gather, axis_index, axis_size, psum,
                                    replicated)
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


def _fused_infonce(rows_lat, cols_lat, temp, decoupled, row_offset=0,
                   global_batch=None, axis_name=None):
    """One direction's InfoNCE loss through K5 (`contrastive.py:47-62`):
    `rows_lat` (b, d) against `cols_lat` (C, d), the positive of row r at
    column `row_offset + r`; the sum over the rows psum'd over `axis_name`
    and divided by `global_batch` (default b: one rank holds every
    column)."""
    xs = rows_lat * temp
    b = xs.shape[0]
    lse = streaming_lse(xs, cols_lat, row_offset, decoupled)
    pos = torch.einsum("bd,bd->b", xs, cols_lat[row_offset:row_offset + b])
    total = (-pos + lse).sum()
    if axis_name is not None:
        total = psum(total, axis_name)
    return total / (b if global_batch is None else global_batch)


def _fused_pair_losses(text_rows, image_cols, image_rows_x, text_cols_x,
                       temp, decoupled, row_offset=0, global_batch=None,
                       axis_name=None):
    """Every (m × n) view pair's CL loss through K5, in JAX's (m n) order
    (`contrastive.py:65-81`): t2i has the text rows against the image
    columns, i2t the extra image rows against the extra text columns (the
    mains when there are no extra heads)."""
    cl = []
    for mi in range(text_rows.shape[0]):
        for ni in range(image_rows_x.shape[0]):
            t2i = _fused_infonce(text_rows[mi], image_cols[ni], temp,
                                 decoupled, row_offset, global_batch,
                                 axis_name)
            i2t = _fused_infonce(image_rows_x[ni], text_cols_x[mi], temp,
                                 decoupled, row_offset, global_batch,
                                 axis_name)
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


def _filip_dense(text_rows, image_cols, text_rows_x, image_cols_x,
                 text_mask, temp):
    """FILIP's (m·n, r, C) t2i and i2t from text rows (m, r, t, d) and
    image columns (n, C, i, d), both (text row, image column); the extra
    latents give i2t when `text_rows_x` is not None. `text_mask` (m·r,
    t)."""
    m, r = text_rows.shape[:2]
    cols = image_cols.shape[1]
    sim_t2i = torch.einsum("mxtd,nyid->mnxyti", text_rows, image_cols) * temp
    sim_i2t = sim_t2i
    if text_rows_x is not None:
        sim_i2t = torch.einsum("mxtd,nyid->mnxyti", text_rows_x,
                               image_cols_x) * temp
    tmask = text_mask.reshape(m, 1, r, 1, -1)
    return (_filip_t2i(sim_t2i, tmask).reshape(-1, r, cols),
            _filip_i2t(sim_i2t, tmask).reshape(-1, r, cols))


def _filip_blocked(text_rows, image_cols, text_rows_x, image_cols_x,
                   text_mask, temp, block):
    """`_filip_dense` a block of image columns at a time
    (`filip_sims_blocked`): the stacked (m·n, r, C) t2i and i2t."""
    m, r = text_rows.shape[:2]
    tmask = text_mask.reshape(m, r, -1)
    extra = text_rows_x is not None
    t2i_rows, i2t_rows = [], []
    for mi in range(m):
        for ni in range(image_cols.shape[0]):
            t2i, i2t = filip_sims_blocked(
                text_rows[mi], image_cols[ni], tmask[mi], temp, block,
                "t2i" if extra else "both")
            if extra:
                _, i2t = filip_sims_blocked(
                    text_rows_x[mi], image_cols_x[ni], tmask[mi], temp,
                    block, "i2t")
            t2i_rows.append(t2i)
            i2t_rows.append(i2t)
    return torch.stack(t2i_rows), torch.stack(i2t_rows)


def _infonce_from_blocks(text_to_image, image_to_text, row_offset,
                         global_batch, decoupled, axis_name, row_valid=None,
                         col_valid=None):
    """Row-sharded InfoNCE (`contrastive.py:132-176`): (v, b_local, B)
    blocks (already × temp) whose rows are this rank's and whose columns
    are the gathered batch → the (v,) global-batch CL losses. The positive
    of local row r sits at column `row_offset + r`, taken before any
    masking; DCL masks that column; `col_valid` (B,) masks the columns,
    `row_valid` (b_local,) float weighs the rows, and the mean divides by
    the psum of the valid rows."""
    b_local = text_to_image.shape[-2]
    cols = row_offset + torch.arange(b_local, device=text_to_image.device)
    denom_count = global_batch
    if row_valid is not None:
        denom_count = psum(row_valid.sum(), axis_name)

    def direction_loss(sims):
        v = sims.shape[0]
        pos = sims.gather(-1, cols[None, :, None].expand(v, -1, 1))[..., 0]
        neg = torch.finfo(sims.dtype).min
        if decoupled:
            hit = (torch.arange(sims.shape[-1], device=sims.device)[None, :]
                   == cols[:, None])
            sims = sims.masked_fill(hit[None], neg)
        if col_valid is not None:
            sims = torch.where(col_valid[None, None, :], sims, neg)
        term = -pos + torch.logsumexp(sims, dim=-1)
        if row_valid is not None:
            term = term * row_valid[None, :]
        return psum(term.sum(dim=-1), axis_name) / denom_count

    return (direction_loss(text_to_image) + direction_loss(image_to_text)) / 2


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


def _sharded_sim_reg(text_latents, image_latents, text_latents_extra,
                     image_latents_extra, row_offset, global_batch, gather,
                     axis_name):
    """Row-sharded sim-reg (`contrastive.py:263-281`): the local rows of
    the self-similarities against the gathered columns, each rank's
    diagonal at `row_offset`, over global_batch · (global_batch − 1)
    pairs."""
    b_local = text_latents.shape[1]
    dev = text_latents.device
    cols_hit = (torch.arange(global_batch, device=dev)[None, :]
                == (row_offset + torch.arange(b_local, device=dev))[:, None])
    count = global_batch * (global_batch - 1)

    def off_diag_mse(a, b):
        d_t = torch.einsum("mrd,mCd->mrC", a, gather(a))
        d_i = torch.einsum("mrd,mCd->mrC", b, gather(b))
        diff2 = torch.where(cols_hit[None], 0.0, (d_t - d_i) ** 2)
        return psum(diff2.sum(), axis_name) / (a.shape[0] * count)

    return (off_diag_mse(text_latents, image_latents)
            + off_diag_mse(text_latents_extra, image_latents_extra)) / 2


def _check_sim_reg(use_all_token_embeds):
    if use_all_token_embeds:
        raise AssertionError(
            "sim_reg with fine-grained token latents is undefined "
            "(text/image token counts differ); the reference path is "
            "broken there too")


def _sharded_contrastive_loss(text_latents, image_latents, temp, *,
                              text_mask, use_all_token_embeds, dcl,
                              text_latents_extra, image_latents_extra,
                              sim_reg, axis_name, loss_impl, filip_block,
                              row_valid):
    """This rank's rows against the gathered columns (see the module
    docstring); `contrastive.py:223-350`."""
    has_extra = text_latents_extra is not None
    if not has_extra:
        text_latents_extra, image_latents_extra = text_latents, image_latents
    b_local = text_latents.shape[1]
    global_batch = b_local * axis_size(axis_name)
    row_offset = axis_index(axis_name) * b_local

    def gather(x):
        return all_gather(x, axis_name, dim=1)

    col_valid = None
    if row_valid is not None:
        row_valid = row_valid.float()
        col_valid = all_gather(row_valid, axis_name, dim=0).bool()

    sim_reg_loss = torch.zeros((), dtype=text_latents.dtype,
                               device=text_latents.device)
    if sim_reg:
        _check_sim_reg(use_all_token_embeds)
        sim_reg_loss = _sharded_sim_reg(
            text_latents, image_latents, text_latents_extra,
            image_latents_extra, row_offset, global_batch, gather, axis_name)

    if use_all_token_embeds:
        if text_mask is None:
            raise AssertionError("FILIP loss requires the text padding mask")
        g_img = gather(image_latents)
        g_img_x = gather(image_latents_extra) if has_extra else None
        x_rows = text_latents_extra if has_extra else None
        if filip_block is not None:
            t2i, i2t = _filip_blocked(text_latents, g_img, x_rows, g_img_x,
                                      text_mask, temp, filip_block)
            return _infonce_from_blocks(t2i, i2t, row_offset, global_batch,
                                        dcl, axis_name), sim_reg_loss
        t2i, i2t = _filip_dense(text_latents, g_img, x_rows, g_img_x,
                                text_mask, temp)
    elif loss_impl == "fused":
        return _fused_pair_losses(
            text_latents, gather(image_latents), image_latents_extra,
            gather(text_latents_extra), temp, dcl, row_offset, global_batch,
            axis_name), sim_reg_loss
    else:
        t2i = torch.einsum("mrd,nCd->mnrC", text_latents,
                           gather(image_latents)) * temp
        i2t = torch.einsum("nrd,mCd->mnrC", image_latents_extra,
                           gather(text_latents_extra)) * temp
        t2i = t2i.reshape(-1, b_local, global_batch)
        i2t = i2t.reshape(-1, b_local, global_batch)
    return _infonce_from_blocks(t2i, i2t, row_offset, global_batch, dcl,
                                axis_name, row_valid, col_valid), sim_reg_loss


def clip_contrastive_loss(text_latents, image_latents, temp, *,
                          text_mask=None,
                          decoupled_contrastive_learning: bool = False,
                          text_latents_extra=None, image_latents_extra=None,
                          use_all_token_embeds: bool = False,
                          sim_reg: bool = False, row_valid=None,
                          loss_impl: str = "xla", filip_block=None,
                          axis_name=None, gather_impl: str = "sharded"):
    """text_latents (m, b, d) or (m, b, t, d), image_latents (n, b, d) or
    (n, b, i, d): l2-normed fp32 latents; temp: scalar exp(temperature);
    text_mask (m·b, t) for FILIP. `axis_name`: None, or the
    `ProcessGroup` whose ranks hold the global batch in equal shards;
    `gather_impl` 'sharded' or 'replicated' (see the module docstring).
    Returns ((m·n,) CL losses, the sim-reg loss), the same on every
    rank."""
    if row_valid is not None:
        if use_all_token_embeds or sim_reg or loss_impl == "fused":
            raise AssertionError(   # JAX's assertion, in its words
                "row_valid requires the plain InfoNCE loss (loss_impl="
                "'xla', no FILIP, no sim_reg)")
        row_valid = row_valid.to(text_latents.device, torch.bool)
    if loss_impl not in ("xla", "fused"):
        raise ValueError(f"unknown loss_impl {loss_impl!r}")
    if gather_impl not in ("sharded", "replicated"):
        raise ValueError(f"unknown gather_impl {gather_impl!r}")
    dcl = decoupled_contrastive_learning
    if axis_name is not None and gather_impl == "sharded":
        return _sharded_contrastive_loss(
            text_latents, image_latents, temp, text_mask=text_mask,
            use_all_token_embeds=use_all_token_embeds, dcl=dcl,
            text_latents_extra=text_latents_extra,
            image_latents_extra=image_latents_extra, sim_reg=sim_reg,
            axis_name=axis_name, loss_impl=loss_impl,
            filip_block=filip_block, row_valid=row_valid)
    if axis_name is not None:   # replicated: every rank the whole batch
        cl_losses, sim_reg_loss = _replicated_contrastive_loss(
            text_latents, image_latents, temp, text_mask=text_mask,
            use_all_token_embeds=use_all_token_embeds, dcl=dcl,
            text_latents_extra=text_latents_extra,
            image_latents_extra=image_latents_extra, sim_reg=sim_reg,
            axis_name=axis_name, loss_impl=loss_impl,
            filip_block=filip_block, row_valid=row_valid)
        return (replicated(cl_losses, axis_name),
                replicated(sim_reg_loss, axis_name))
    return _local_contrastive_loss(
        text_latents, image_latents, temp, text_mask=text_mask,
        use_all_token_embeds=use_all_token_embeds, dcl=dcl,
        text_latents_extra=text_latents_extra,
        image_latents_extra=image_latents_extra, sim_reg=sim_reg,
        loss_impl=loss_impl, filip_block=filip_block, row_valid=row_valid)


def _replicated_contrastive_loss(text_latents, image_latents, temp, *,
                                 text_mask, text_latents_extra,
                                 image_latents_extra, axis_name, row_valid,
                                 **kw):
    """The whole batch gathered on every rank, then the local loss
    (`contrastive.py:425-436`)."""
    def gather(x):
        return all_gather(x, axis_name, dim=1)

    if text_latents_extra is not None:
        text_latents_extra = gather(text_latents_extra)
        image_latents_extra = gather(image_latents_extra)
    if row_valid is not None:
        row_valid = all_gather(row_valid, axis_name, dim=0)
    if text_mask is not None:
        tm = text_mask.reshape(text_latents.shape[0], -1,
                               text_mask.shape[-1])
        text_mask = gather(tm).reshape(-1, text_mask.shape[-1])
    return _local_contrastive_loss(
        gather(text_latents), gather(image_latents), temp,
        text_mask=text_mask, text_latents_extra=text_latents_extra,
        image_latents_extra=image_latents_extra, row_valid=row_valid, **kw)


def _local_contrastive_loss(text_latents, image_latents, temp, *, text_mask,
                            use_all_token_embeds, dcl, text_latents_extra,
                            image_latents_extra, sim_reg, loss_impl,
                            filip_block, row_valid):
    """One rank holds every row and every column."""
    has_extra = text_latents_extra is not None
    if not has_extra:
        text_latents_extra, image_latents_extra = text_latents, image_latents
    batch = text_latents.shape[1]

    sim_reg_loss = torch.zeros((), dtype=text_latents.dtype,
                               device=text_latents.device)
    if sim_reg:
        _check_sim_reg(use_all_token_embeds)
        sim_reg_loss = _sim_reg(text_latents, image_latents,
                                text_latents_extra, image_latents_extra)

    if use_all_token_embeds:
        if text_mask is None:
            raise AssertionError("FILIP loss requires the text padding mask")
        x_rows, x_cols = ((text_latents_extra, image_latents_extra)
                          if has_extra else (None, None))
        if filip_block is not None:
            return infonce_from_sims(*_filip_blocked(
                text_latents, image_latents, x_rows, x_cols, text_mask,
                temp, filip_block), dcl), sim_reg_loss
        text_to_image, image_to_text = _filip_dense(
            text_latents, image_latents, x_rows, x_cols, text_mask, temp)
    elif loss_impl == "fused":
        return _fused_pair_losses(text_latents, image_latents,
                                  image_latents_extra, text_latents_extra,
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
