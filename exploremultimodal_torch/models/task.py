"""VlmoTask: the backbone plus the serving heads (counterpart of
`exploremultimodal_tpu/models/task.py`; only the VQA head is ported)."""

from __future__ import annotations

import torch
from torch import nn

from exploremultimodal_torch.config import VlmoConfig
from exploremultimodal_torch.models.heads import VQAClassifier
from exploremultimodal_torch.models.vlmo import (
    VLMO,
    LayerNorm,
    expert_layout,
)

SUPPORTED_HEADS = ("vqa",)


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
        if unsupported or c.quantize != "none":
            raise NotImplementedError(
                f"not ported yet: heads {unsupported}, quantize={c.quantize!r}")
        self.transformer = VLMO(
            img_size=c.img_size, patch_size=c.patch_size,
            embed_dim=c.embed_dim, depth=c.depth, num_heads=c.num_heads,
            mlp_ratio=c.mlp_ratio, norm_eps=c.norm_eps,
            init_values=c.init_values, vocab_size=c.vocab_size,
            max_text_len=c.max_text_len, fusion_layer=c.fusion_layer,
            experts_per_block=expert_layout(c.depth, c.fusion_layer, c.phase),
            dtype=c.dtype, attn_impl=c.attn_impl, mlp_impl=c.mlp_impl)
        if "vqa" in c.loss_names:
            self.vqa_classifier = VQAClassifier(c.embed_dim, c.vqa_label_size,
                                                c.norm_eps, c.dtype)

    def infer(self, batch: dict, infer_mode: str = "img-txt") -> dict:
        """`exploremultimodal_tpu.models.task.VlmoTask.infer` for the
        unmasked modes: 'img_only', 'txt_only' or 'img-txt'."""
        if infer_mode not in ("img_only", "txt_only", "img-txt"):
            raise ValueError(f"infer_mode {infer_mode!r}")
        img = batch["image"] if "img" in infer_mode else None
        txt_ids = batch["text_ids"] if "txt" in infer_mode else None
        txt_mask = batch["text_mask"] if "txt" in infer_mode else None
        co_feats, co_masks = self.transformer.forward_features(
            img=img, txt=txt_ids, txt_mask=txt_mask)
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
            "txt_ids": txt_ids,
            "txt_masks": txt_mask,
            "co_masks": co_masks,
        }

    def vqa_logits(self, cls_feats: torch.Tensor) -> torch.Tensor:
        return self.vqa_classifier(cls_feats)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights as the reference initializes VLMo: truncated
        normal (std 0.02, cut at 2 std) for every matrix, embedding table,
        position embedding and class token; LayerNorm 1 and 0; biases 0;
        LayerScale gammas at `init_values`; the image mask token 0."""
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


def build_model(cfg: dict, device: str | torch.device = "cuda",
                seed: int = 0) -> VlmoTask:
    """A VlmoTask for `cfg` with seeded random weights, in eval mode on
    `device`."""
    dev = resolve_device(device)
    task = VlmoTask(VlmoConfig.from_config(cfg))
    task.init_weights(torch.Generator().manual_seed(seed))
    return task.to(dev).eval().requires_grad_(False)
