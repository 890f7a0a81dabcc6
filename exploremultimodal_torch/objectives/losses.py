"""The pretraining and downstream objectives as fixed-shape functions.

Counterpart of `exploremultimodal_tpu/objectives/losses.py`: `_gather_cap`,
`masked_cross_entropy`, `gather_masked_positions`, `compute_mlm`,
`compute_itc` and `itc_losses` (in-batch, or against the momentum
encoder's features and the negative queues), `patch_pooling`, `in_batch_g2l_loss`, `itm_sample_pairs`,
`itm_loss_from_co`, `compute_itm`, `compute_mim`, `_bce_with_logits`,
`compute_vqa_score`, `compute_vqa` (with ISDA and R-Drop),
`compute_nlvr2`, `compute_mpp`, `patchify`, `compute_mae`, `compute_imgcls`,
`box_iou_giou`, `compute_refcoco` and `compute_irtr`. Each `compute_*` takes
the task module, the model batch and the step's `StepRng` (None:
deterministic) and returns `<name>_task_loss` plus metrics. ITC runs first;
its below-fusion hidden states (`itc_h_img`, `itc_h_txt`) feed MLM's fused
forward and ITM's pairs.

On more than one process each takes the `DataAxis` of the step
(`parallel/collectives.py`; None at one process). With its `global_batch`
(`train.global_reduce: false`) the losses are JAX's step over the whole
batch: ITC against every process's features (gathered with their
gradient), ITM's negatives from the whole batch (their below-fusion states
gathered with their gradient), and every loss and metric a mean over the
whole batch, the same on every process: the count-weighted ones (MLM, MIM,
MPP, ITM, MAE) from numerators and counts summed over the processes, the
others (equal rows on every process) as the sum of the processes' means
over their number; counts and `*_dropped_positions` summed. Without it
(`train.global_reduce: true`, JAX's `shard_map` step) each process keeps
its own losses, ITC against the gathered features with its rows first.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.profiler import record_function

from exploremultimodal_torch.models import heads
from exploremultimodal_torch.ops.stochastic import StepRng
from exploremultimodal_torch.parallel.collectives import DataAxis, all_gather_with_grad

ITC_TEMP_MAX = 4.6052  # log(100)


def _gather_cap(cap: float, length: int) -> int:
    """Static gather width for masked-position heads: ceil(cap * L), >= 1."""
    if cap >= 1.0:
        return length
    return max(1, min(length, int(math.ceil(cap * length))))


def _global(axis: DataAxis | None) -> DataAxis | None:
    """The axis where the losses are the whole batch's, else None."""
    return axis if axis is not None and axis.global_batch else None


def _ranks_mean(axis: DataAxis | None, *values):
    """Per-process means over equally many rows as the whole batch's
    (`DataAxis.mean`); as they are without a global axis."""
    axis = _global(axis)
    return values if axis is None else axis.mean(*values)


def _ranks_count(axis: DataAxis | None, count: torch.Tensor) -> torch.Tensor:
    axis = _global(axis)
    return count if axis is None else axis.sum(count.detach())


def masked_cross_entropy(logits, labels, valid, axis: DataAxis | None = None):
    """Mean CE and accuracy over `valid` positions, as logit[label] - lse
    (over every process's positions with a global `axis`). Returns (loss,
    mean_acc, count)."""
    valid_f = valid.to(torch.float32)
    count = valid_f.sum()
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    label_logit = torch.gather(lf, -1, safe[..., None])[..., 0]
    num = -((label_logit - lse) * valid_f).sum()
    correct = ((logits.argmax(dim=-1) == safe) * valid_f).sum()
    if _global(axis) is not None:
        num, correct, count = axis.sum(torch.stack([num, correct, count])).unbind()
    denom = count.clamp_min(1.0)
    return num / denom, correct / denom, count


def gather_masked_positions(feats, labels, valid, k: int):
    """Up to `k` valid positions per row, in sequence order, to the front."""
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)[:, :k]
    g_feats = torch.gather(feats, 1, order[..., None].expand(-1, -1, feats.shape[-1]))
    return g_feats, torch.gather(labels, 1, order), torch.gather(valid, 1, order)


def _capped(feats, labels, valid, cap: float, name: str, axis: DataAxis | None = None):
    k = _gather_cap(cap, labels.shape[1])
    extra = {}
    if k < labels.shape[1]:
        # masked positions beyond the cap fall out of the loss; counted
        extra[f"{name}_dropped_positions"] = _ranks_count(
            axis, (valid.sum(dim=1) - k).clamp_min(0).sum().to(torch.float32))
        feats, labels, valid = gather_masked_positions(feats, labels, valid, k)
    return feats, labels, valid, extra


# ------------------------------------------------------------------- MLM


def compute_mlm(task, batch: dict, rng: StepRng | None = None,
                shared: dict | None = None, axis: DataAxis | None = None) -> dict:
    """Masked-language-modeling CE over the masked text positions. With ITC's
    below-fusion image hidden in `shared`, only the masked text stream runs
    below the fusion layer."""
    has_img = batch.get("image") is not None
    if has_img and shared is not None and "itc_h_img" in shared:
        t = task.transformer
        h_txt = t.stream_below_fusion(txt=batch["text_ids_mlm"],
                                      txt_mask=batch["text_mask"], rng=rng)
        co_feats, _ = t.fuse_from_hidden(shared["itc_h_img"], h_txt,
                                         batch["text_mask"], rng=rng)
        txt_feats = co_feats[:, : task.config.max_text_len]
        labels = batch["text_labels_mlm"]
    else:
        infer = task.infer(batch, "img-txt" if has_img else "txt_only",
                           mask_txt=True, rng=rng)
        txt_feats, labels = infer["txt_feats"], infer["txt_labels"]
    labels = labels.long()
    txt_feats, labels, valid, extra = _capped(
        txt_feats, labels, labels != -100, task.config.mlm_gather_cap, "mlm", axis)
    loss, acc, count = masked_cross_entropy(task.mlm_logits(txt_feats), labels, valid,
                                            axis)
    return {"mlm_task_loss": loss, "mlm_mean_acc": acc, "mlm_count": count, **extra}


# ------------------------------------------------------------------- ITC


def compute_itc(task, batch: dict, rng: StepRng | None = None,
                momentum_feats: dict | None = None, queue: dict | None = None,
                pos_offset: int = 0, axis: DataAxis | None = None) -> dict:
    """Image-text contrastive loss (`itc_losses` on the batch's projected
    global features). The single-modality streams split at the fusion
    layer, and the below-fusion hidden states are returned for MLM and
    ITM."""
    temp = torch.exp(task.itc_temp.clamp(0.0, ITC_TEMP_MAX))
    t = task.transformer
    h_img = t.stream_below_fusion(img=batch["image"], rng=rng)
    h_txt = t.stream_below_fusion(txt=batch["text_ids"], txt_mask=batch["text_mask"],
                                  rng=rng)
    img_feats = t.continue_single_stream(h_img, None, "v", rng=rng)
    txt_feats = t.continue_single_stream(h_txt, batch["text_mask"], "l", rng=rng)
    i_feat = task.itc_head(img_feats[:, 0], "v").float()
    t_feat = task.itc_head(txt_feats[:, 0], "l").float()
    with record_function("itc/sims"):
        ret = itc_losses(i_feat, t_feat, temp, batch["text_mask"], momentum_feats, queue,
                         pos_offset, axis)
    ret.update({"itc_i_feat": i_feat, "itc_t_feat": t_feat, "itc_h_img": h_img,
                "itc_h_txt": h_txt})
    return ret


def itc_losses(i_feat, t_feat, temp, text_mask, momentum_feats: dict | None = None,
               queue: dict | None = None, pos_offset: int = 0,
               axis: DataAxis | None = None) -> dict:
    """The ITC losses, accuracies and sims of normalised global features
    `i_feat` / `t_feat` (B, itc_dim) at the logit scale `temp`, in their
    dtype (fp32 in training).

    Without `momentum_feats`, in-batch similarities. With them (the momentum
    encoder's {'i_feat_m', 't_feat_m', and optionally 'i_feat_l_m',
    't_feat_l_m', 't_mask_m'}, `VlmoTask.itc_momentum_feats`), each row is
    contrasted against the momentum features, then `queue`'s columns
    ({'img', 'txt'}, (itc_dim, Q)) where given, with the in-modal i2i / t2t
    losses and, with the locals, the global-to-local i2i_l / t2t_l ones
    (the text locals masked by `t_mask_m`, else by `text_mask[:, 1:]`).
    Under gradient accumulation the momentum features cover the full batch
    and the features are one microbatch's, whose rows start at
    `pos_offset` in it: the positives sit on that offset diagonal, and the
    accuracies are taken over the momentum columns only.

    On more than one process (`axis`): without `global_batch`, JAX's
    `global_reduce` branch, which comes before the momentum one: each row
    against every process's features, this process's first. With it, in
    batch, each row against every process's features in rank order, its
    positive at its global row; against the momentum encoder, the trainer
    hands in the whole batch's momentum features and the microbatch's
    offset in them. `itc_cols` tells ITM which columns of the sims are the
    (micro)batch's."""
    bs = i_feat.shape[0]
    rows = torch.arange(bs, device=i_feat.device)
    targets, n_pos_cols = rows, bs
    in_modal = local_g2l = None
    cols = None
    if axis is not None and not axis.global_batch:
        i_all, t_all = (all_gather_with_grad(f, axis.group) for f in (i_feat, t_feat))
        sim_i2t = i_feat @ t_all.T * temp
        sim_t2i = t_feat @ i_all.T * temp
        cols = rows
    elif momentum_feats is None and axis is not None:
        i_all, t_all = axis.gather(i_feat), axis.gather(t_feat)
        sim_i2t = i_feat @ t_all.T * temp
        sim_t2i = t_feat @ i_all.T * temp
        targets, n_pos_cols = rows + axis.rank * bs, axis.size * bs
        cols = torch.arange(n_pos_cols, device=i_feat.device)
    elif momentum_feats is None:
        sim_i2t = i_feat @ t_feat.T * temp
        sim_t2i = sim_i2t.T
    else:
        mf = momentum_feats
        i_all, t_all = (mf[k].to(i_feat.dtype).T for k in ("i_feat_m", "t_feat_m"))
        targets, n_pos_cols = rows + pos_offset, i_all.shape[1]
        if axis is not None:
            # the (micro)batch's rows in the whole batch's columns: each
            # process's bs rows follow the previous one's (the trainer's
            # microbatch i is global rows i B_g / A + rank * bs + j)
            first = pos_offset - axis.rank * bs
            cols = (torch.arange(axis.size, device=i_feat.device)[:, None] * bs + first
                    + rows[None]).reshape(-1)
        if queue is not None:
            i_all = torch.cat([i_all, queue["img"].to(i_feat.dtype)], dim=1)
            t_all = torch.cat([t_all, queue["txt"].to(i_feat.dtype)], dim=1)
        sim_i2t = i_feat @ t_all * temp
        sim_t2i = t_feat @ i_all * temp
        in_modal = (i_feat @ i_all * temp, t_feat @ t_all * temp)
        if "i_feat_l_m" in mf:
            t_mask_m = mf.get("t_mask_m")
            if t_mask_m is None:
                t_mask_m = text_mask[:, 1:]
            local_g2l = (
                in_batch_g2l_loss(mf["i_feat_l_m"], i_feat, temp, pos_offset=pos_offset),
                in_batch_g2l_loss(mf["t_feat_l_m"], t_feat, temp, t_mask_m,
                                  pos_offset=pos_offset))

    def ce(sim):  # the target column of each row, sims of any width
        return -torch.log_softmax(sim, dim=-1)[rows, targets].mean()

    def acc(sim):
        return (sim[:, :n_pos_cols].argmax(-1) == targets).float().mean()

    losses = [ce(sim_i2t), ce(sim_t2i)]
    if in_modal is not None:
        losses += [ce(sim) for sim in in_modal]
        if local_g2l is not None:
            losses += list(local_g2l)
    *losses, acc_i2t, acc_t2i = _ranks_mean(axis, *losses, acc(sim_i2t), acc(sim_t2i))
    n = torch.tensor(float(bs * (axis.size if _global(axis) else 1)), device=i_feat.device)
    ret = {
        "i2t_Loss": losses[0],
        "t2i_Loss": losses[1],
        "sim_i2t": sim_i2t,
        "sim_t2i": sim_t2i,
        "itc_temp": temp,
        "itc_i2t_mean_acc": acc_i2t,
        "itc_i2t_count": n,
        "itc_t2i_mean_acc": acc_t2i,
        "itc_t2i_count": n,
    }
    if cols is not None:
        ret["itc_cols"] = cols
    if in_modal is not None:
        ret.update({"i2i_Loss": losses[2], "t2t_Loss": losses[3]})
        if local_g2l is not None:
            ret.update({"i2i_l_Loss": losses[4], "t2t_l_Loss": losses[5]})
    ret["itc_task_loss"] = sum(losses) / len(losses)
    return ret


def patch_pooling(x: torch.Tensor) -> torch.Tensor:
    """A sqrt(N) x sqrt(N) patch grid average-pooled in windows of
    c = int(N ** 0.25) with stride c and floor semantics (F.avg_pool2d's):
    14 x 14 pools 3 x 3 windows into 4 x 4 locals, dropping the last two
    rows and columns."""
    bs, length, dim = x.shape
    b1 = int(length ** 0.5)
    c1 = int(b1 ** 0.5)
    out = b1 // c1
    x = x.reshape(bs, b1, b1, dim)[:, : out * c1, : out * c1]
    x = x.reshape(bs, out, c1, out, c1, dim)
    return x.mean(dim=(2, 4)).reshape(bs, -1, dim)


def in_batch_g2l_loss(l, m, temp, attention_mask=None, pos_offset: int = 0):
    """Global-to-local contrast: each global feature of `m` (M, d) against
    its own sample's local features of `l` (N, L, d) as positives and every
    other sample's locals as negatives. `l` and `attention_mask` (N, L)
    cover the full batch; `m` is the microbatch whose rows start at
    `pos_offset` in it, so the negative pool does not shrink under
    accumulation. Masked locals drop out through -10000 logits, as in JAX.
    In fp32, or fp64 where an input is."""
    l, m = (x.to(torch.promote_types(x.dtype, torch.float32)) for x in (l, m))
    n, n_locals, _ = l.shape
    rows = m.shape[0]
    l_pos = l[pos_offset:pos_offset + rows]
    u_p = torch.einsum("mld,md->ml", l_pos, m)[:, :, None] / temp  # (M, L, 1)
    if attention_mask is not None:
        am_pos = attention_mask[pos_offset:pos_offset + rows].float()
        am = am_pos[:, :, None]
        u_p = am * u_p + 10000.0 * (1 - am)
    u_n = torch.einsum("md,nld->mnl", m, l) / temp  # (M, N, L)
    own = pos_offset + torch.arange(rows, device=l.device)
    n_mask = 1.0 - (own[:, None] == torch.arange(n, device=l.device)[None, :]).float()
    n_mask = n_mask[:, :, None]
    u_n = n_mask * u_n - 10000.0 * (1.0 - n_mask)
    if attention_mask is not None:
        am = attention_mask[None].float()
        u_n = am * u_n - 10000.0 * (1 - am)
    u_n = u_n.reshape(rows, 1, n * n_locals).expand(rows, n_locals, n * n_locals)
    logp = torch.log_softmax(torch.cat([u_p, u_n], dim=2), dim=2)[:, :, 0]
    if attention_mask is not None:
        return (-(logp * am_pos).sum(1) / am_pos.sum(1)).mean()
    return -logp.mean()


# ------------------------------------------------------------------- ITM


def itm_sample_pairs(task, batch: dict, sim_dict: dict | None = None,
                     rng: StepRng | None = None, negatives=None,
                     generator: torch.Generator | None = None, pos_offset: int = 0,
                     axis: DataAxis | None = None):
    """ITC-guided hard negatives and the [pos, img-neg, txt-neg] 3*bs pair
    rows below the fusion layer. Returns (pair_img, pair_txt, pair_mask,
    labels). The negatives are drawn on `rng.generator` (one image per text
    from softmax(sim_t2i), one text per image from softmax(sim_i2t), the
    positive excluded; the same law as JAX's categorical, other draws), on
    `generator` in a deterministic forward (`rng` None: its sampling stream,
    as JAX's eval step keeps its `sample` rng), or given as `negatives` =
    (neg_img_idx, neg_txt_idx). Where the shared sims are wider than the
    batch (momentum ITC: the momentum columns, then the queue's), the
    weights take the batch's own columns [pos_offset, pos_offset + bs)
    (ITC's `itc_cols` where it gives them).

    With a global `axis` the candidates are every process's rows of the
    (micro)batch in rank order, this process's row j at rank * bs + j; the
    negatives' indices (given or drawn) are into them, and the rows they
    pick come from the gathered below-fusion states (with their gradient)
    or, without ITC, the gathered inputs."""
    img, txt_ids, txt_mask = batch["image"], batch["text_ids"], batch["text_mask"]
    bs = img.shape[0]
    g = _global(axis)
    cands, first = (bs, 0) if g is None else (g.size * bs, g.rank * bs)
    if negatives is None:
        if generator is None:
            if rng is None:
                raise ValueError("ITM negatives need a StepRng, a generator or given "
                                 "indices")
            generator = rng.generator
        if sim_dict is not None:
            def own_cols(sim):
                if "itc_cols" in sim_dict:
                    return sim[:, sim_dict["itc_cols"]]
                return sim if sim.shape[1] == bs else sim[:, pos_offset:pos_offset + bs]

            w_i2t, w_t2i = (torch.softmax(own_cols(sim_dict[k].detach().float()), dim=1)
                            for k in ("sim_i2t", "sim_t2i"))
        else:  # JAX's standard-normal log-weights
            w_i2t, w_t2i = (torch.randn((bs, cands), generator=generator,
                                        device=img.device).exp() for _ in range(2))
        # each row's own candidate, the positive, is never its negative
        eye = torch.zeros((bs, cands), dtype=torch.bool, device=img.device)
        eye[:, first:first + bs] = torch.eye(bs, dtype=torch.bool, device=img.device)
        w_i2t, w_t2i = (w.masked_fill(eye, 0.0) for w in (w_i2t, w_t2i))
        neg_img_idx = torch.multinomial(w_t2i, 1, generator=generator)[:, 0]
        neg_txt_idx = torch.multinomial(w_i2t, 1, generator=generator)[:, 0]
    else:
        neg_img_idx, neg_txt_idx = (torch.as_tensor(i, device=img.device).long()
                                    for i in negatives)

    mask_all = txt_mask if g is None else g.gather_const(txt_mask)
    if sim_dict is not None and "itc_h_img" in sim_dict:
        h_img, h_txt = sim_dict["itc_h_img"], sim_dict["itc_h_txt"]
        h_img_all, h_txt_all = (h_img, h_txt) if g is None else (g.gather(h_img),
                                                                 g.gather(h_txt))
        pair_img = torch.cat([h_img, h_img_all[neg_img_idx], h_img], dim=0)
        pair_txt = torch.cat([h_txt, h_txt, h_txt_all[neg_txt_idx]], dim=0)
    else:
        t = task.transformer
        img_all, ids_all = (img, txt_ids) if g is None else (g.gather_const(img),
                                                             g.gather_const(txt_ids))
        # two runs of rows: the batch, then its negatives
        with _runs(rng, 2):
            h_img = t.stream_below_fusion(
                img=torch.cat([img, img_all[neg_img_idx]], dim=0), rng=rng)
            h_txt = t.stream_below_fusion(
                txt=torch.cat([txt_ids, ids_all[neg_txt_idx]], dim=0),
                txt_mask=torch.cat([txt_mask, mask_all[neg_txt_idx]], dim=0), rng=rng)
        pair_img = torch.cat([h_img[:bs], h_img[bs:], h_img[:bs]], dim=0)
        pair_txt = torch.cat([h_txt[:bs], h_txt[:bs], h_txt[bs:]], dim=0)
    pair_mask = torch.cat([txt_mask, txt_mask, mask_all[neg_txt_idx]], dim=0)
    labels = torch.cat([torch.ones(bs, dtype=torch.long, device=img.device),
                        torch.zeros(2 * bs, dtype=torch.long, device=img.device)])
    return pair_img, pair_txt, pair_mask, labels


def _runs(rng: StepRng | None, count: int):
    """The attention calls inside take their rows as `count` runs of the
    global batch (`StepRng.runs`)."""
    return contextlib.nullcontext() if rng is None else rng.runs(count)


def itm_loss_from_co(task, co_feats, labels, axis: DataAxis | None = None) -> dict:
    """ITM head and CE on fused pair rows."""
    logits = task.itm_head(task.transformer.pool(co_feats))
    loss, acc, count = masked_cross_entropy(logits, labels,
                                            torch.ones_like(labels, dtype=torch.bool), axis)
    return {"itm_task_loss": loss, "itm_mean_acc": acc, "itm_count": count}


def compute_itm(task, batch: dict, sim_dict: dict | None = None,
                rng: StepRng | None = None, negatives=None,
                generator: torch.Generator | None = None, pos_offset: int = 0,
                axis: DataAxis | None = None) -> dict:
    """Image-text matching with ITC-guided hard negatives: one fused forward
    over the 3*bs [pos, img-neg, txt-neg] rows (three runs of the global
    batch's rows, as JAX lays out its pair batch)."""
    pair_img, pair_txt, pair_mask, labels = itm_sample_pairs(
        task, batch, sim_dict, rng, negatives, generator, pos_offset, axis)
    with _runs(rng, 3):
        co_feats, _ = task.transformer.fuse_from_hidden(pair_img, pair_txt, pair_mask,
                                                        rng=rng)
    return itm_loss_from_co(task, co_feats, labels, axis)


# ------------------------------------------------------------------- MIM


def compute_mim(task, batch: dict, rng: StepRng | None = None,
                axis: DataAxis | None = None) -> dict:
    """Masked-image-modeling CE against the frozen dVAE codes in
    `batch['mim_labels']`, over the masked patches."""
    labels = batch["mim_labels"].long()
    valid = batch["image_bool_masked_pos"] > 0
    head_pos = task.config.mim_head_pos
    if head_pos in ("img", "mum"):
        mode = "img_only" if head_pos == "img" else "img-txt"
        img_feats = task.infer(batch, mode, mask_img=True, rng=rng)["img_feats"]
    elif head_pos == "fusion":
        img_feats = task.backbone_interval_img(
            batch["image"], batch["image_bool_masked_pos"], rng=rng)
    else:
        raise ValueError(f"mim_head_pos {head_pos!r}")
    patch_feats, labels, valid, extra = _capped(
        img_feats[:, 1:], labels, valid, task.config.mim_gather_cap, "mim", axis)
    loss, acc, count = masked_cross_entropy(task.mim_head(patch_feats), labels, valid,
                                            axis)
    return {"mim_task_loss": loss, "mim_mean_acc": acc, "mim_count": count, **extra}


# ------------------------------------------------------------------- VQA


def _bce_with_logits(logits, targets):
    """Elementwise binary cross-entropy on logits, in fp32."""
    logits = logits.float()
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def compute_vqa_score(logits, targets):
    """The VQAv2 soft score of the argmax answer, averaged; and the count."""
    idx = logits.float().argmax(dim=-1)
    score = torch.gather(targets, 1, idx[:, None])[:, 0]
    return score.mean(), torch.tensor(float(logits.shape[0]), device=logits.device)


def compute_vqa(task, batch: dict, rng: StepRng | None = None,
                isda_state: heads.ISDAState | None = None,
                isda_ratio: float = 0.0, axis: DataAxis | None = None) -> dict:
    """VQAv2 BCE over the soft targets `batch['vqa_targets']`, summed over
    the answers and averaged over the rows. With an `isda_state` and a
    StepRng, ISDA: the statistics take the batch's classifier hiddens and
    the training logits their augmentation. With `kl_alpha` > 0 and a
    StepRng, R-Drop: a second forward with fresh dropout from the same
    StepRng, the two BCEs averaged, and the symmetric KL of the two
    answer distributions added as `vqa_kl_task_loss`. With a global `axis`,
    ISDA's statistics take every process's rows (gathered), and the KL is
    summed over them."""
    infer = task.infer(batch, "img-txt", rng=rng)
    logits, hidden = task.vqa_logits(infer["cls_feats"], return_hidden=True)
    targets = batch["vqa_targets"].float()
    num_answers = targets.shape[1]

    new_isda_state = isda_state
    train_logits = logits
    if isda_state is not None and rng is not None:
        g = _global(axis)
        onehot = (targets > 0).float()
        new_isda_state = heads.isda_update(
            isda_state, hidden if g is None else g.gather_const(hidden),
            onehot if g is None else g.gather_const(onehot))
        train_logits = heads.isda_logits(
            logits, task.vqa_last_kernel(), targets.argmax(dim=1),
            new_isda_state.cov, isda_ratio)

    vqa_loss = _bce_with_logits(train_logits, targets).mean() * num_answers
    score, count = compute_vqa_score(logits, targets)
    vqa_loss, score = _ranks_mean(axis, vqa_loss, score)
    count = _ranks_count(axis, count)
    ret = {"vqa_logits": logits, "vqa_task_loss": vqa_loss,
           "vqa_mean_score": score, "vqa_count": count,
           "isda_state": new_isda_state}

    if task.config.kl_alpha > 0 and rng is not None:
        logits2 = task.vqa_logits(task.infer(batch, "img-txt", rng=rng)["cls_feats"])
        (loss2,) = _ranks_mean(axis, _bce_with_logits(logits2, targets).mean() * num_answers)
        p = torch.log_softmax(logits.float(), dim=-1)
        q = torch.log_softmax(logits2.float(), dim=-1)
        kl = (q.exp() * (q - p)).sum()
        r_kl = (p.exp() * (p - q)).sum()
        if _global(axis) is not None:
            kl, r_kl = axis.sum(torch.stack([kl, r_kl])).unbind()
        ret["vqa_task_loss"] = (vqa_loss + loss2) / 2.0
        ret["vqa_kl_task_loss"] = (kl + r_kl) / 4.0 * task.config.kl_alpha
    return ret


# ------------------------------------------------------------------ NLVR2


def compute_nlvr2(task, batch: dict, rng: StepRng | None = None,
                  axis: DataAxis | None = None) -> dict:
    """NLVR2: the statement fused with each image of the pair (token types 1
    and 2), the two CLS features concatenated, a 2-way CE on `answers`."""
    cls = [task.infer(batch, "img-txt", image_token_type_idx=i, rng=rng)["cls_feats"]
           for i in (1, 2)]
    logits = task.nlvr2_logits(torch.cat(cls, dim=-1))
    labels = batch["answers"].long()
    loss, acc, count = masked_cross_entropy(logits, labels,
                                            torch.ones_like(labels, dtype=torch.bool), axis)
    return {"nlvr2_task_loss": loss, "nlvr2_logits": logits,
            "nlvr2_mean_acc": acc, "nlvr2_count": count}


# ------------------------------------------------------------------- MPP


def compute_mpp(task, batch: dict, rng: StepRng | None = None,
                axis: DataAxis | None = None) -> dict:
    """Masked-patch prediction: a 256-way CE on each of the three colour
    channels of the masked patches, from the fused stream with the masked
    image; labels `batch['image_labels_mpp']` (B, P, 3), -100 ignored."""
    infer = task.infer(batch, "img-txt", mask_img=True, rng=rng)
    logits = task.mpp_logits(infer["img_feats"][:, 1:])
    b, p, _ = logits.shape
    labels = batch["image_labels_mpp"].long()
    loss, acc, count = masked_cross_entropy(logits.reshape(b, p, 3, 256), labels,
                                            labels != -100, axis)
    return {"mpp_task_loss": loss, "mpp_mean_acc": acc, "mpp_count": count}


# ------------------------------------------------------------------- MAE


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, num_patches, patch_size^2 * C), patches in the
    patch embedding's row-major order."""
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, gh, patch_size, gw, patch_size, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


def compute_mae(task, batch: dict, rng: StepRng | None = None,
                axis: DataAxis | None = None) -> dict:
    """Masked pixel regression: the masked image stream's patch features
    decoded to pixels, against each patch's pixels normalised by their own
    mean and variance; the MSE over the masked patches."""
    img_feats = task.infer(batch, "img_only", mask_img=True, rng=rng)["img_feats"]
    pred = task.mae_logits(img_feats[:, 1:])
    targets = patchify(batch["image"].float(), task.config.patch_size)
    mean = targets.mean(dim=-1, keepdim=True)
    var = targets.var(dim=-1, keepdim=True, correction=0)
    targets = (targets - mean) / torch.sqrt(var + 1e-6)
    mask = batch["image_bool_masked_pos"].float()
    per_patch = ((pred.float() - targets) ** 2).mean(dim=-1)
    num, count = (per_patch * mask).sum(), mask.sum()
    if _global(axis) is not None:
        num, count = axis.sum(torch.stack([num, count])).unbind()
    return {"mae_task_loss": num / count.clamp_min(1.0), "mae_count": count}


# ---------------------------------------------------------------- IMGCLS


def compute_imgcls(task, batch: dict, rng: StepRng | None = None,
                   axis: DataAxis | None = None) -> dict:
    """Image classification over the pooled CLS: of the fused stream where
    the batch has captions (`text_ids`), else of the image stream; a CE on
    `batch['label']`."""
    mode = "img-txt" if batch.get("text_ids") is not None else "img_only"
    logits = task.imgcls_logits(task.infer(batch, mode, rng=rng)["cls_feats"])
    labels = batch["label"].long()
    loss, acc, count = masked_cross_entropy(logits, labels,
                                            torch.ones_like(labels, dtype=torch.bool), axis)
    return {"imgcls_task_loss": loss, "imgcls_mean_acc": acc, "imgcls_count": count}


# --------------------------------------------------------------- REFCOCO


def _cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def box_iou_giou(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (IoU, GIoU) of xyxy boxes `a`, `b` (..., 4), with 1e-6 floors
    under the union and the enclosing area."""
    def area(x):
        return (x[..., 2:] - x[..., :2]).clamp_min(0.0).prod(-1)

    inter = (torch.minimum(a[..., 2:], b[..., 2:])
             - torch.maximum(a[..., :2], b[..., :2])).clamp_min(0.0).prod(-1)
    union = area(a) + area(b) - inter
    iou = inter / union.clamp_min(1e-6)
    enclose = (torch.maximum(a[..., 2:], b[..., 2:])
               - torch.minimum(a[..., :2], b[..., :2])).clamp_min(0.0).prod(-1)
    return iou, iou - (enclose - union) / enclose.clamp_min(1e-6)


def compute_refcoco(task, batch: dict, rng: StepRng | None = None,
                    axis: DataAxis | None = None) -> dict:
    """Referring-expression grounding: the fused CLS regresses one
    normalised (cx, cy, w, h) box against `batch['ref_box']`; the loss is
    5 L1 + 2 (1 - GIoU), in fp32; the metrics accuracy at IoU >= 0.5 and
    the mean IoU (`refcoco_mean_score`)."""
    pred = task.ref_box(task.infer(batch, "img-txt", rng=rng)["cls_feats"])
    target = batch["ref_box"].float()
    l1 = (pred - target).abs().sum(-1)
    iou, giou = box_iou_giou(_cxcywh_to_xyxy(pred), _cxcywh_to_xyxy(target))
    loss, acc, score = _ranks_mean(axis, (5.0 * l1 + 2.0 * (1.0 - giou)).mean(),
                                   (iou >= 0.5).float().mean(), iou.mean())
    count = torch.tensor(float(pred.shape[0]), device=pred.device)
    return {"refcoco_task_loss": loss, "refcoco_mean_acc": acc,
            "refcoco_mean_score": score, "refcoco_count": _ranks_count(axis, count)}


# ------------------------------------------------------------------ IRTR


def compute_irtr(task, batch: dict, rng: StepRng | None = None,
                 axis: DataAxis | None = None) -> dict:
    """Text retrieval ranking: each image fused with its caption and its F
    drawn false captions (B (F + 1) rows, the image repeated), the rank
    head's scores, a CE with the true caption at index 0."""
    img = batch["image"]
    false_ids, false_mask = batch["false_text_ids"], batch["false_text_mask"]
    b, f, length = false_ids.shape
    ids = torch.cat([batch["text_ids"][:, None], false_ids], dim=1)
    mask = torch.cat([batch["text_mask"][:, None], false_mask], dim=1)
    flat = {
        "image": img[:, None].expand(b, f + 1, *img.shape[1:]).reshape(
            b * (f + 1), *img.shape[1:]),
        "text_ids": ids.reshape(b * (f + 1), length),
        "text_mask": mask.reshape(b * (f + 1), length),
    }
    cls = task.infer(flat, "img-txt", rng=rng)["cls_feats"]
    score = task.rank_logits(cls)[:, 0].reshape(b, f + 1)
    labels = torch.zeros(b, dtype=torch.long, device=score.device)
    loss, acc, count = masked_cross_entropy(score, labels,
                                            torch.ones_like(labels, dtype=torch.bool), axis)
    return {"irtr_task_loss": loss, "irtr_mean_acc": acc, "irtr_count": count}
