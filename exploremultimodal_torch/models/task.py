"""VlmoTask: the backbone, the heads and the multitask forward (counterpart
of `exploremultimodal_tpu/models/task.py`; the VQA head for serving and
finetune_vqa, and the pretrain_mum heads MLM, ITC, ITM and MIM).

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
    MIMHead,
    MLMTransform,
    VQAClassifier,
)
from exploremultimodal_torch.models.vlmo import (
    VLMO,
    LayerNorm,
    expert_layout,
)
from exploremultimodal_torch.objectives import losses as obj
from exploremultimodal_torch.ops.stochastic import StepRng

SUPPORTED_HEADS = ("vqa", "mlm", "itc", "itm", "mim")
TRAINED_OBJECTIVES = ("mlm", "itc", "itm", "mim", "vqa")


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
        unsupported = [n for n in c.loss_names if n not in SUPPORTED_HEADS]
        if unsupported:
            raise NotImplementedError(f"not ported yet: heads {unsupported}")
        self.transformer = VLMO(
            img_size=c.img_size, patch_size=c.patch_size,
            embed_dim=c.embed_dim, depth=c.depth, num_heads=c.num_heads,
            mlp_ratio=c.mlp_ratio, norm_eps=c.norm_eps,
            init_values=c.init_values, vocab_size=c.vocab_size,
            max_text_len=c.max_text_len, fusion_layer=c.fusion_layer,
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
        if "vqa" in names:
            self.vqa_classifier = VQAClassifier(hs, c.vqa_label_size,
                                                c.norm_eps, c.dtype)

    # ------------------------------------------------------------------ infer

    def infer(self, batch: dict, infer_mode: str = "img-txt",
              mask_txt: bool = False, mask_img: bool = False,
              rng: StepRng | None = None) -> dict:
        """`exploremultimodal_tpu.models.task.VlmoTask.infer`: 'img_only',
        'txt_only' or 'img-txt', with the MLM text (`mask_txt`) or the
        masked image patches (`mask_img`). `rng` None is deterministic."""
        if infer_mode not in ("img_only", "txt_only", "img-txt"):
            raise ValueError(f"infer_mode {infer_mode!r}")
        img = bool_masked_pos = None
        txt_ids = txt_labels = txt_mask = None
        if "img" in infer_mode:
            img = batch["image"]
            if mask_img:
                bool_masked_pos = batch["image_bool_masked_pos"]
        if "txt" in infer_mode:
            suffix = "_mlm" if mask_txt else ""
            txt_ids = batch[f"text_ids{suffix}"]
            txt_labels = batch[f"text_labels{suffix}"] if mask_txt else None
            txt_mask = batch["text_mask"]
        co_feats, co_masks = self.transformer.forward_features(
            img=img, txt=txt_ids, txt_mask=txt_mask,
            bool_masked_pos=bool_masked_pos, rng=rng)
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

    def backbone_interval_img(self, img, bool_masked_pos,
                              rng: StepRng | None = None):
        """MIM with mim_head_pos='fusion': the masked image stream through
        blocks[:fusion_layer], then the final norm."""
        t = self.transformer
        x = t.embed_img(img, bool_masked_pos, rng)
        x = t.run_blocks(x, t._img_mask(x), "v", 0, t.fusion_layer, rng)
        return t.norm(x).to(t.dtype)

    # ---------------------------------------------------------------- forward

    def forward(self, batch: dict, rng: StepRng | None = None,
                negatives=None, isda_state=None, isda_ratio: float = 0.0,
                generator: torch.Generator | None = None) -> dict:
        """The union of the active objectives, as JAX's `__call__`. ITC runs
        first: its below-fusion hidden states feed MLM's fused forward and
        ITM's pair rows. `rng` None is deterministic (no dropout); the ITM
        negatives then come from `negatives` = (neg_img_idx, neg_txt_idx)
        or are drawn on `generator`.
        VQA takes the ISDA statistics `isda_state` (None: no ISDA) and
        returns their update as `isda_state`."""
        names = self.config.loss_names
        if not names:
            return self.infer(batch)
        ret: dict = {}
        if "itc" in names:
            ret.update(obj.compute_itc(self, batch, rng))
        shared = ret if "itc" in names else None
        if "mlm" in names:
            ret.update(obj.compute_mlm(self, batch, rng, shared=shared))
        if "mim" in names:
            ret.update(obj.compute_mim(self, batch, rng))
        if "itm" in names:
            ret.update(obj.compute_itm(self, batch, shared, rng, negatives, generator))
        if "vqa" in names:
            ret.update(obj.compute_vqa(self, batch, rng, isda_state=isda_state,
                                       isda_ratio=isda_ratio))
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


def build_model(cfg: dict, device: str | torch.device = "cuda",
                seed: int = 0) -> VlmoTask:
    """A VlmoTask for `cfg` with seeded random weights, in eval mode on
    `device`."""
    dev = resolve_device(device)
    task = VlmoTask(VlmoConfig.from_config(cfg))
    task.init_weights(torch.Generator().manual_seed(seed))
    return task.to(dev).eval().requires_grad_(False)
