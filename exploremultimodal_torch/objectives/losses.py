"""The pretraining and downstream objectives as fixed-shape functions.

Counterpart of `exploremultimodal_tpu/objectives/losses.py`: `_gather_cap`,
`masked_cross_entropy`, `gather_masked_positions`, `compute_mlm`, the
in-batch (naive) branch of `compute_itc`, `itm_sample_pairs`,
`itm_loss_from_co`, `compute_itm`, `compute_mim`, `_bce_with_logits`,
`compute_vqa_score`, `compute_vqa` (with ISDA and R-Drop),
`compute_nlvr2`, `patchify`, `compute_mae` and `compute_irtr`. Each `compute_*` takes
the task module, the model batch and the step's `StepRng` (None:
deterministic) and returns `<name>_task_loss` plus metrics. ITC runs first;
its below-fusion hidden states (`itc_h_img`, `itc_h_txt`) feed MLM's fused
forward and ITM's pairs.
"""

from __future__ import annotations

import math

import torch

from exploremultimodal_torch.models import heads
from exploremultimodal_torch.ops.stochastic import StepRng

ITC_TEMP_MAX = 4.6052  # log(100)


def _gather_cap(cap: float, length: int) -> int:
    """Static gather width for masked-position heads: ceil(cap * L), >= 1."""
    if cap >= 1.0:
        return length
    return max(1, min(length, int(math.ceil(cap * length))))


def masked_cross_entropy(logits, labels, valid):
    """Mean CE and accuracy over `valid` positions, as logit[label] - lse.
    Returns (loss, mean_acc, count)."""
    valid_f = valid.to(torch.float32)
    count = valid_f.sum()
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    label_logit = torch.gather(lf, -1, safe[..., None])[..., 0]
    denom = count.clamp_min(1.0)
    loss = -((label_logit - lse) * valid_f).sum() / denom
    acc = ((logits.argmax(dim=-1) == safe) * valid_f).sum() / denom
    return loss, acc, count


def gather_masked_positions(feats, labels, valid, k: int):
    """Up to `k` valid positions per row, in sequence order, to the front."""
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)[:, :k]
    g_feats = torch.gather(feats, 1, order[..., None].expand(-1, -1, feats.shape[-1]))
    return g_feats, torch.gather(labels, 1, order), torch.gather(valid, 1, order)


def _capped(feats, labels, valid, cap: float, name: str):
    k = _gather_cap(cap, labels.shape[1])
    extra = {}
    if k < labels.shape[1]:
        # masked positions beyond the cap fall out of the loss; counted
        extra[f"{name}_dropped_positions"] = (
            (valid.sum(dim=1) - k).clamp_min(0).sum().to(torch.float32))
        feats, labels, valid = gather_masked_positions(feats, labels, valid, k)
    return feats, labels, valid, extra


# ------------------------------------------------------------------- MLM


def compute_mlm(task, batch: dict, rng: StepRng | None = None,
                shared: dict | None = None) -> dict:
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
        txt_feats, labels, labels != -100, task.config.mlm_gather_cap, "mlm")
    loss, acc, count = masked_cross_entropy(task.mlm_logits(txt_feats), labels, valid)
    return {"mlm_task_loss": loss, "mlm_mean_acc": acc, "mlm_count": count, **extra}


# ------------------------------------------------------------------- ITC


def compute_itc(task, batch: dict, rng: StepRng | None = None) -> dict:
    """Image-text contrastive loss over in-batch similarities. The
    single-modality streams split at the fusion layer, and the below-fusion
    hidden states are returned for MLM and ITM."""
    temp = torch.exp(task.itc_temp.clamp(0.0, ITC_TEMP_MAX))
    t = task.transformer
    h_img = t.stream_below_fusion(img=batch["image"], rng=rng)
    h_txt = t.stream_below_fusion(txt=batch["text_ids"], txt_mask=batch["text_mask"],
                                  rng=rng)
    img_feats = t.continue_single_stream(h_img, None, "v", rng=rng)
    txt_feats = t.continue_single_stream(h_txt, batch["text_mask"], "l", rng=rng)
    i_feat = task.itc_head(img_feats[:, 0], "v").float()
    t_feat = task.itc_head(txt_feats[:, 0], "l").float()

    bs = i_feat.shape[0]
    targets = torch.arange(bs, device=i_feat.device)
    sim_i2t = i_feat @ t_feat.T * temp
    sim_t2i = sim_i2t.T

    def ce(sim):
        return -torch.log_softmax(sim, dim=-1)[targets, targets].mean()

    i2t_loss, t2i_loss = ce(sim_i2t), ce(sim_t2i)
    n = torch.tensor(float(bs), device=i_feat.device)
    return {
        "i2t_Loss": i2t_loss,
        "t2i_Loss": t2i_loss,
        "sim_i2t": sim_i2t,
        "sim_t2i": sim_t2i,
        "itc_temp": temp,
        "itc_i2t_mean_acc": (sim_i2t.argmax(-1) == targets).float().mean(),
        "itc_i2t_count": n,
        "itc_t2i_mean_acc": (sim_t2i.argmax(-1) == targets).float().mean(),
        "itc_t2i_count": n,
        "itc_i_feat": i_feat,
        "itc_t_feat": t_feat,
        "itc_h_img": h_img,
        "itc_h_txt": h_txt,
        "itc_task_loss": (i2t_loss + t2i_loss) / 2,
    }


# ------------------------------------------------------------------- ITM


def itm_sample_pairs(task, batch: dict, sim_dict: dict | None = None,
                     rng: StepRng | None = None, negatives=None,
                     generator: torch.Generator | None = None):
    """ITC-guided hard negatives and the [pos, img-neg, txt-neg] 3*bs pair
    rows below the fusion layer. Returns (pair_img, pair_txt, pair_mask,
    labels). The negatives are drawn on `rng.generator` (one image per text
    from softmax(sim_t2i), one text per image from softmax(sim_i2t), the
    positive excluded; the same law as JAX's categorical, other draws), on
    `generator` in a deterministic forward (`rng` None: its sampling stream,
    as JAX's eval step keeps its `sample` rng), or given as `negatives` =
    (neg_img_idx, neg_txt_idx)."""
    img, txt_ids, txt_mask = batch["image"], batch["text_ids"], batch["text_mask"]
    bs = img.shape[0]
    if negatives is None:
        if generator is None:
            if rng is None:
                raise ValueError("ITM negatives need a StepRng, a generator or given "
                                 "indices")
            generator = rng.generator
        if sim_dict is not None:
            w_i2t, w_t2i = (torch.softmax(sim_dict[k].detach().float(), dim=1)
                            for k in ("sim_i2t", "sim_t2i"))
        else:  # JAX's standard-normal log-weights
            w_i2t, w_t2i = (torch.randn((bs, bs), generator=generator,
                                        device=img.device).exp() for _ in range(2))
        eye = torch.eye(bs, dtype=torch.bool, device=img.device)
        w_i2t, w_t2i = (w.masked_fill(eye, 0.0) for w in (w_i2t, w_t2i))
        neg_img_idx = torch.multinomial(w_t2i, 1, generator=generator)[:, 0]
        neg_txt_idx = torch.multinomial(w_i2t, 1, generator=generator)[:, 0]
    else:
        neg_img_idx, neg_txt_idx = (torch.as_tensor(i, device=img.device).long()
                                    for i in negatives)

    if sim_dict is not None and "itc_h_img" in sim_dict:
        h_img, h_txt = sim_dict["itc_h_img"], sim_dict["itc_h_txt"]
        pair_img = torch.cat([h_img, h_img[neg_img_idx], h_img], dim=0)
        pair_txt = torch.cat([h_txt, h_txt, h_txt[neg_txt_idx]], dim=0)
    else:
        t = task.transformer
        h_img = t.stream_below_fusion(
            img=torch.cat([img, img[neg_img_idx]], dim=0), rng=rng)
        h_txt = t.stream_below_fusion(
            txt=torch.cat([txt_ids, txt_ids[neg_txt_idx]], dim=0),
            txt_mask=torch.cat([txt_mask, txt_mask[neg_txt_idx]], dim=0), rng=rng)
        pair_img = torch.cat([h_img[:bs], h_img[bs:], h_img[:bs]], dim=0)
        pair_txt = torch.cat([h_txt[:bs], h_txt[:bs], h_txt[bs:]], dim=0)
    pair_mask = torch.cat([txt_mask, txt_mask, txt_mask[neg_txt_idx]], dim=0)
    labels = torch.cat([torch.ones(bs, dtype=torch.long, device=img.device),
                        torch.zeros(2 * bs, dtype=torch.long, device=img.device)])
    return pair_img, pair_txt, pair_mask, labels


def itm_loss_from_co(task, co_feats, labels) -> dict:
    """ITM head and CE on fused pair rows."""
    logits = task.itm_head(task.transformer.pool(co_feats))
    loss, acc, count = masked_cross_entropy(logits, labels,
                                            torch.ones_like(labels, dtype=torch.bool))
    return {"itm_task_loss": loss, "itm_mean_acc": acc, "itm_count": count}


def compute_itm(task, batch: dict, sim_dict: dict | None = None,
                rng: StepRng | None = None, negatives=None,
                generator: torch.Generator | None = None) -> dict:
    """Image-text matching with ITC-guided hard negatives: one fused forward
    over the 3*bs [pos, img-neg, txt-neg] rows."""
    pair_img, pair_txt, pair_mask, labels = itm_sample_pairs(
        task, batch, sim_dict, rng, negatives, generator)
    co_feats, _ = task.transformer.fuse_from_hidden(pair_img, pair_txt, pair_mask,
                                                    rng=rng)
    return itm_loss_from_co(task, co_feats, labels)


# ------------------------------------------------------------------- MIM


def compute_mim(task, batch: dict, rng: StepRng | None = None) -> dict:
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
        img_feats[:, 1:], labels, valid, task.config.mim_gather_cap, "mim")
    loss, acc, count = masked_cross_entropy(task.mim_head(patch_feats), labels, valid)
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
                isda_ratio: float = 0.0) -> dict:
    """VQAv2 BCE over the soft targets `batch['vqa_targets']`, summed over
    the answers and averaged over the rows. With an `isda_state` and a
    StepRng, ISDA: the statistics take the batch's classifier hiddens and
    the training logits their augmentation. With `kl_alpha` > 0 and a
    StepRng, R-Drop: a second forward with fresh dropout from the same
    StepRng, the two BCEs averaged, and the symmetric KL of the two
    answer distributions added as `vqa_kl_task_loss`."""
    infer = task.infer(batch, "img-txt", rng=rng)
    logits, hidden = task.vqa_logits(infer["cls_feats"], return_hidden=True)
    targets = batch["vqa_targets"].float()
    num_answers = targets.shape[1]

    new_isda_state = isda_state
    train_logits = logits
    if isda_state is not None and rng is not None:
        new_isda_state = heads.isda_update(isda_state, hidden,
                                           (targets > 0).float())
        train_logits = heads.isda_logits(
            logits, task.vqa_last_kernel(), targets.argmax(dim=1),
            new_isda_state.cov, isda_ratio)

    vqa_loss = _bce_with_logits(train_logits, targets).mean() * num_answers
    score, count = compute_vqa_score(logits, targets)
    ret = {"vqa_logits": logits, "vqa_task_loss": vqa_loss,
           "vqa_mean_score": score, "vqa_count": count,
           "isda_state": new_isda_state}

    if task.config.kl_alpha > 0 and rng is not None:
        logits2 = task.vqa_logits(task.infer(batch, "img-txt", rng=rng)["cls_feats"])
        loss2 = _bce_with_logits(logits2, targets).mean() * num_answers
        p = torch.log_softmax(logits.float(), dim=-1)
        q = torch.log_softmax(logits2.float(), dim=-1)
        kl = (q.exp() * (q - p)).sum()
        r_kl = (p.exp() * (p - q)).sum()
        ret["vqa_task_loss"] = (vqa_loss + loss2) / 2.0
        ret["vqa_kl_task_loss"] = (kl + r_kl) / 4.0 * task.config.kl_alpha
    return ret


# ------------------------------------------------------------------ NLVR2


def compute_nlvr2(task, batch: dict, rng: StepRng | None = None) -> dict:
    """NLVR2: the statement fused with each image of the pair (token types 1
    and 2), the two CLS features concatenated, a 2-way CE on `answers`."""
    cls = [task.infer(batch, "img-txt", image_token_type_idx=i, rng=rng)["cls_feats"]
           for i in (1, 2)]
    logits = task.nlvr2_logits(torch.cat(cls, dim=-1))
    labels = batch["answers"].long()
    loss, acc, count = masked_cross_entropy(logits, labels,
                                            torch.ones_like(labels, dtype=torch.bool))
    return {"nlvr2_task_loss": loss, "nlvr2_logits": logits,
            "nlvr2_mean_acc": acc, "nlvr2_count": count}


# ------------------------------------------------------------------- MAE


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, num_patches, patch_size^2 * C), patches in the
    patch embedding's row-major order."""
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, gh, patch_size, gw, patch_size, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


def compute_mae(task, batch: dict, rng: StepRng | None = None) -> dict:
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
    count = mask.sum()
    return {"mae_task_loss": (per_patch * mask).sum() / count.clamp_min(1.0),
            "mae_count": count}


# ------------------------------------------------------------------ IRTR


def compute_irtr(task, batch: dict, rng: StepRng | None = None) -> dict:
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
                                            torch.ones_like(labels, dtype=torch.bool))
    return {"irtr_task_loss": loss, "irtr_mean_acc": acc, "irtr_count": count}
