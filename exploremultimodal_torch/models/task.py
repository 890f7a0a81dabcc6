"""VlmoTask: the backbone, the heads and the multitask forward (counterpart
of `exploremultimodal_tpu/models/task.py`; the VQA head for serving and
finetune_vqa, the pretrain_mum heads MLM, ITC, ITM and MIM, pretrain_vis's
MAE head, finetune_nlvr2's classifier and finetune_retrieval's rank head).

The frozen dVAE is not a submodule: the trainer computes the MIM targets and
hands them in as `batch['mim_labels']`, as the JAX trainer does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from exploremultimodal_torch.config import VlmoConfig
from exploremultimodal_torch.models.heads import (
    ITCHead,
    ITMHead,
    MAEHead,
    MIMHead,
    MLMTransform,
    NLVR2Classifier,
    RankHead,
    VQAClassifier,
)
from exploremultimodal_torch.models.vlmo import (
    VLMO,
    LayerNorm,
    expert_layout,
)
from exploremultimodal_torch.objectives import losses as obj
from exploremultimodal_torch.ops.stochastic import StepRng

# every head the port builds, each trained by its objective
TRAINED_OBJECTIVES = ("mlm", "itc", "itm", "mim", "vqa", "mae", "nlvr2", "irtr")


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. CUDA is the default everywhere;
    without a GPU this raises unless the caller asked for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


class VlmoTask(nn.Module):
    def __init__(self, config: VlmoConfig):
        super().__init__()
        c = self.config = config
        unsupported = [n for n in c.loss_names if n not in TRAINED_OBJECTIVES]
        if unsupported:
            raise NotImplementedError(f"not ported yet: heads {unsupported}")
        self.transformer = VLMO(
            img_size=c.img_size, patch_size=c.patch_size,
            embed_dim=c.embed_dim, depth=c.depth, num_heads=c.num_heads,
            mlp_ratio=c.mlp_ratio, norm_eps=c.norm_eps,
            init_values=c.init_values, vocab_size=c.vocab_size,
            max_text_len=c.max_text_len, fusion_layer=c.fusion_layer,
            num_token_types=3 if "nlvr2" in c.loss_names else 2,
            experts_per_block=expert_layout(c.depth, c.fusion_layer, c.phase),
            dtype=c.dtype, attn_impl=c.attn_impl, mlp_impl=c.mlp_impl,
            drop_rate=c.drop_rate, attn_drop_rate=c.attn_drop_rate,
            drop_path_rate=c.drop_path_rate, quantize=c.quantize)
        hs, names = c.embed_dim, c.loss_names
        if "mlm" in names:
            self.mlm_head = MLMTransform(hs, c.vocab_size, c.norm_eps, c.dtype)
        if "itc" in names:
            self.itc_head = ITCHead(hs, c.itc_dim, c.dtype)
            self.itc_temp = nn.Parameter(
                torch.tensor(math.log(1.0 / c.itc_temp), dtype=torch.float32))
        if "itm" in names:
            self.itm_head = ITMHead(hs, c.dtype)
        if "mim" in names:
            self.mim_head = MIMHead(hs, c.img_vocab_size, c.dtype)
        if "mae" in names:
            self.mae_head = MAEHead(hs, c.patch_size, c.dtype)
        if "vqa" in names:
            self.vqa_classifier = VQAClassifier(hs, c.vqa_label_size,
                                                c.norm_eps, c.dtype)
        if "nlvr2" in names:
            self.nlvr2_classifier = NLVR2Classifier(hs, c.norm_eps, c.dtype)
        if "irtr" in names:
            self.rank_output = RankHead(hs, c.dtype)

    # ------------------------------------------------------------------ infer

    def infer(self, batch: dict, infer_mode: str = "img-txt",
              mask_txt: bool = False, mask_img: bool = False,
              image_token_type_idx: int = 1,
              rng: StepRng | None = None) -> dict:
        """`exploremultimodal_tpu.models.task.VlmoTask.infer`: 'img_only',
        'txt_only' or 'img-txt', with the MLM text (`mask_txt`) or the
        masked image patches (`mask_img`). The image is
        `batch['image_<idx - 1>']` where the batch has it (NLVR2's pair),
        else `batch['image']`, at token type `image_token_type_idx`. `rng`
        None is deterministic."""
        if infer_mode not in ("img_only", "txt_only", "img-txt"):
            raise ValueError(f"infer_mode {infer_mode!r}")
        img = bool_masked_pos = None
        txt_ids = txt_labels = txt_mask = None
        if "img" in infer_mode:
            key = f"image_{image_token_type_idx - 1}"
            img = batch[key if key in batch else "image"]
            if mask_img:
                bool_masked_pos = batch["image_bool_masked_pos"]
        if "txt" in infer_mode:
            suffix = "_mlm" if mask_txt else ""
            txt_ids = batch[f"text_ids{suffix}"]
            txt_labels = batch[f"text_labels{suffix}"] if mask_txt else None
            txt_mask = batch["text_mask"]
        co_feats, co_masks = self.transformer.forward_features(
            img=img, txt=txt_ids, txt_mask=txt_mask,
            bool_masked_pos=bool_masked_pos, rng=rng,
            img_token_type_idx=image_token_type_idx)
        if txt_ids is not None:
            txt_feats = co_feats[:, : self.config.max_text_len]
            img_feats = co_feats[:, self.config.max_text_len:]
        else:
            txt_feats, img_feats = None, co_feats
        return {
            "txt_feats": txt_feats,
            "img_feats": img_feats,
            "co_feats": co_feats,
            "cls_feats": self.transformer.pool(co_feats),
            "img_bool_masked_pos": bool_masked_pos,
            "txt_labels": txt_labels,
            "txt_ids": txt_ids,
            "txt_masks": txt_mask,
            "co_masks": co_masks,
        }

    # --------------------------------------------------------------- head fns

    def vqa_logits(self, cls_feats: torch.Tensor, return_hidden: bool = False):
        return self.vqa_classifier(cls_feats, return_hidden=return_hidden)

    def vqa_last_kernel(self) -> torch.Tensor:
        """The classifier's last weight as JAX's (A, C) kernel."""
        return self.vqa_classifier.fc2.weight.T

    def mlm_logits(self, txt_feats: torch.Tensor) -> torch.Tensor:
        h = self.mlm_head(txt_feats)
        return self.transformer.attend_vocab(h) + self.mlm_head.bias

    def itc_project(self, feats: torch.Tensor, route: str) -> torch.Tensor:
        return self.itc_head(feats, route)

    def mae_logits(self, patch_feats: torch.Tensor) -> torch.Tensor:
        return self.mae_head(patch_feats)

    def nlvr2_logits(self, cls_feats: torch.Tensor) -> torch.Tensor:
        """Logits over (False, True) from the two images' concatenated CLS
        features (B, 2 hs)."""
        return self.nlvr2_classifier(cls_feats)

    def rank_logits(self, cls_feats: torch.Tensor) -> torch.Tensor:
        return self.rank_output(cls_feats)

    def stream_below_fusion(self, img=None, txt=None, txt_mask=None,
                            rng: StepRng | None = None) -> torch.Tensor:
        return self.transformer.stream_below_fusion(img=img, txt=txt,
                                                    txt_mask=txt_mask, rng=rng)

    def continue_single_stream(self, x, mask, route: str,
                               rng: StepRng | None = None) -> torch.Tensor:
        return self.transformer.continue_single_stream(x, mask, route, rng=rng)

    def backbone_interval_img(self, img, bool_masked_pos,
                              rng: StepRng | None = None):
        """MIM with mim_head_pos='fusion': the masked image stream through
        blocks[:fusion_layer], then the final norm."""
        t = self.transformer
        x = t.embed_img(img, bool_masked_pos, rng)
        x = t.run_blocks(x, t._img_mask(x), "v", 0, t.fusion_layer, rng)
        return t.norm(x).to(t.dtype)

    # --------------------------------------------------------------- momentum

    def itc_momentum_feats(self, batch: dict) -> dict:
        """The momentum branch's features, for a task that holds the
        momentum encoder's tree: deterministic image-only and text-only
        forwards (the image from `batch['image_aug']` where present), the
        projected globals `i_feat_m` / `t_feat_m`, the image locals pooled
        to 4 x 4 (`patch_pooling`) as `i_feat_l_m`, the text locals as
        `t_feat_l_m`, and their mask `t_mask_m`, carried with the features
        so the global-to-local loss stays full-batch under accumulation."""
        aug = dict(batch)
        if batch.get("image_aug") is not None:
            aug["image"] = batch["image_aug"]
        img = self.infer(aug, "img_only")["co_feats"]
        txt = self.infer(aug, "txt_only")["co_feats"]
        return {
            "i_feat_m": self.itc_project(img[:, 0], "v"),
            "t_feat_m": self.itc_project(txt[:, 0], "l"),
            "i_feat_l_m": obj.patch_pooling(self.itc_project(img[:, 1:], "v")),
            "t_feat_l_m": self.itc_project(txt[:, 1:], "l"),
            "t_mask_m": batch["text_mask"][:, 1:],
        }

    # ---------------------------------------------------------------- forward

    def forward(self, batch: dict, rng: StepRng | None = None,
                negatives=None, isda_state=None, isda_ratio: float = 0.0,
                generator: torch.Generator | None = None,
                momentum_feats: dict | None = None, queue: dict | None = None,
                pos_offset: int = 0) -> dict:
        """The union of the active objectives, as JAX's `__call__`. ITC runs
        first: its below-fusion hidden states feed MLM's fused forward and
        ITM's pair rows. `rng` None is deterministic (no dropout); the ITM
        negatives then come from `negatives` = (neg_img_idx, neg_txt_idx)
        or are drawn on `generator`.
        VQA takes the ISDA statistics `isda_state` (None: no ISDA) and
        returns their update as `isda_state`. ITC takes the momentum
        encoder's `momentum_feats` and the negative `queue` (None: in-batch
        ITC); `pos_offset` is a microbatch's first row in the full batch
        those features cover, which ITM's hard negatives also read."""
        names = self.config.loss_names
        if not names:
            return self.infer(batch)
        ret: dict = {}
        if "itc" in names:
            ret.update(obj.compute_itc(self, batch, rng, momentum_feats=momentum_feats,
                                       queue=queue, pos_offset=pos_offset))
        shared = ret if "itc" in names else None
        if "mlm" in names:
            ret.update(obj.compute_mlm(self, batch, rng, shared=shared))
        if "mim" in names:
            ret.update(obj.compute_mim(self, batch, rng))
        if "itm" in names:
            ret.update(obj.compute_itm(self, batch, shared, rng, negatives, generator,
                                       pos_offset))
        if "vqa" in names:
            ret.update(obj.compute_vqa(self, batch, rng, isda_state=isda_state,
                                       isda_ratio=isda_ratio))
        if "nlvr2" in names:
            ret.update(obj.compute_nlvr2(self, batch, rng))
        if "irtr" in names:
            ret.update(obj.compute_irtr(self, batch, rng))
        if "mae" in names:
            ret.update(obj.compute_mae(self, batch, rng))
        return ret

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights as the reference initializes VLMo: truncated
        normal (std 0.02, cut at 2 std) for every matrix, embedding table,
        position embedding and class token; LayerNorm 1 and 0; biases 0;
        LayerScale gammas at `init_values`; the image mask token 0; the
        ITC temperature at log(1 / itc_temp)."""
        def trunc_(p: torch.Tensor) -> None:
            tmp = torch.empty(p.shape, dtype=torch.float32)
            nn.init.trunc_normal_(tmp, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
            p.copy_(tmp)

        for mod in self.modules():
            if isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.Embedding)):
                trunc_(mod.weight)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
        t = self.transformer
        trunc_(t.pos_embed)
        trunc_(t.img_cls_token)
        t.img_mask_token.zero_()
        for blk in t.blocks:
            blk.attn.q_bias.zero_()
            blk.attn.v_bias.zero_()
            for gamma in (blk.gamma_1, blk.gamma_2):
                if gamma is not None:
                    gamma.fill_(self.config.init_values)
        if hasattr(self, "mlm_head"):
            self.mlm_head.bias.zero_()
        if hasattr(self, "itc_temp"):
            self.itc_temp.fill_(math.log(1.0 / self.config.itc_temp))


def total_loss(outputs: dict, flat: bool = False) -> torch.Tensor:
    """Sum of the `*_task_loss` components in fp32, non-finite ones dropped.
    With flat=True each is divided by its own detached magnitude, so every
    task contributes an equal-magnitude gradient."""
    total = None
    for key, v in outputs.items():
        if key.endswith("_task_loss"):
            v = v.to(torch.float32)
            if flat:
                v = v / v.detach().abs().clamp_min(1e-12)
            v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
            total = v if total is None else total + v
    if total is None:
        raise ValueError("no *_task_loss in the outputs")
    return total


def adjust_downstream_params(state_dict: dict, loss_names) -> dict:
    """Downstream warm start, as JAX's `adjust_downstream_params`: with
    `irtr` among the losses and both heads in `state_dict`, the rank head
    takes the ITM head's 'match' row. Returns a new state dict. (NLVR2's
    token-type table is not touched here: the importer loads a table only
    at its own shape, so a pretrained 2-row table leaves the 3-row one at
    its init, as in JAX.)"""
    keys = ("itm_head.fc.weight", "itm_head.fc.bias", "rank_output.fc.weight",
            "rank_output.fc.bias")
    if "irtr" not in loss_names or not all(k in state_dict for k in keys):
        return state_dict
    out = dict(state_dict)
    out["rank_output.fc.weight"] = state_dict["itm_head.fc.weight"][1:2].clone()
    out["rank_output.fc.bias"] = state_dict["itm_head.fc.bias"][1:2].clone()
    return out


def build_model(cfg: dict, device: str | torch.device = "cuda",
                seed: int = 0) -> VlmoTask:
    """A VlmoTask for `cfg` with seeded random weights, in eval mode on
    `device`."""
    dev = resolve_device(device)
    task = VlmoTask(VlmoConfig.from_config(cfg))
    task.init_weights(torch.Generator().manual_seed(seed))
    return task.to(dev).eval().requires_grad_(False)
