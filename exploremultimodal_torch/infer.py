"""Serving API over one set of VLMo weights (counterpart of
`exploremultimodal_tpu/infer.py`): VQA answers, the ITC embeddings of
images and texts and their similarity, the ITM match probability and the
NLVR2 probability.

Each text endpoint has a method on token-id arrays (`vqa_logits`,
`encode_text_ids`, `itm_score_ids`, `nlvr2_ids`) and one on strings (`vqa`,
`encode_text`, `itm_score`, `nlvr2`) that tokenizes with the BERT tokenizer
and calls it. Images are uint8 NHWC arrays at the model's size.

Every call pads its batch to a power-of-two bucket (at most `max_batch`) with
copies of the last row, runs, and slices the result back, as the JAX
`Predictor` does. Weights come as a `VlmoTask` state_dict: from
`models.convert.from_flax_params`, or from `build_model(...).state_dict()`
for seeded random weights; or through `Predictor.from_checkpoint`, from a
checkpoint directory the trainer saved, a BEiT/VLMo `.pth` file, or a
`file://` or `https://` URL of either.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from exploremultimodal_torch.config import VlmoConfig, load_config
from exploremultimodal_torch.data.vqa_vocab import RESOURCE_DIR, load_vqa_vocab
from exploremultimodal_torch.models.task import VlmoTask, build_model, resolve_device
from exploremultimodal_torch.ops.preprocess import normalize_image


def _next_bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(max(b, 1), max(max_batch, n))


def _pad_to(x: np.ndarray, b: int) -> np.ndarray:
    if x.shape[0] == b:
        return x
    pad = [(0, b - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, mode="edge")


class Predictor:
    """Serving over one set of weights, on `device` (CUDA by default). The
    endpoints need the heads of the train phase the weights come from:
    `vqa*` finetune_vqa's, `encode_*`, `similarity` and `itm_score*`
    pretrain_mum's (ITC and ITM), `nlvr2*` finetune_nlvr2's."""

    def __init__(self, cfg: dict, state_dict: dict, *, max_batch: int = 64,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        task = VlmoTask(VlmoConfig.from_config(cfg))
        task.load_state_dict(state_dict, strict=True)
        self.task = task.to(self.device).eval().requires_grad_(False)
        self.max_batch = int(max_batch)
        self._tokenizer = None
        self._vqa_vocab = None

    @classmethod
    def from_checkpoint(cls, checkpoint: str, overrides: Sequence[str] = (),
                        max_batch: int = 64,
                        device: str | torch.device = "cuda") -> "Predictor":
        """Serve the weights of `checkpoint`: a checkpoint directory of the
        port's trainer (`checkpoint-<epoch>/`), a BEiT/VLMo `.pth` file
        (`models.import_torch`, over seeded random weights for what it
        lacks), or a `file://` / `https://` URL of either. `overrides` select
        the model and train groups the weights were trained with (the train
        phase decides which heads exist)."""
        from exploremultimodal_torch.models.import_torch import (
            import_torch_state,
            load_torch_checkpoint,
        )
        from exploremultimodal_torch.train import checkpoints as ckpt_lib

        cfg = load_config(list(overrides))
        path = checkpoint
        if path.startswith(("http://", "https://", "file://")):
            path = ckpt_lib._fetch_url_checkpoint(path)
        if os.path.isdir(path):
            state, _ = ckpt_lib.read_checkpoint(path)
            state_dict = state["model"]
        elif ckpt_lib.is_torch_checkpoint(path):
            target = build_model(cfg, device="cpu", seed=0).state_dict()
            state_dict, _, _ = import_torch_state(
                load_torch_checkpoint(path), target,
                max_text_len=cfg["model"]["max_text_len"])
        else:
            raise ValueError(f"{checkpoint!r} is neither a checkpoint directory "
                             "nor a torch file")
        return cls(cfg, state_dict, max_batch=max_batch, device=device)

    # ------------------------------------------------------- host helpers

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            from transformers import BertTokenizerFast

            d = self.cfg["data"]
            roots = [d.get("tokenizer_dir"), RESOURCE_DIR]
            dirs = [os.path.join(r, d["tokenizer"]) for r in roots if r]
            local = next((p for p in dirs if os.path.isdir(p)), None)
            if local is None:
                raise FileNotFoundError(f"no tokenizer under {dirs}")
            self._tokenizer = BertTokenizerFast.from_pretrained(local)
        return self._tokenizer

    def tokenize(self, texts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        enc = self.tokenizer(list(texts), padding="max_length", truncation=True,
                             max_length=self.task.config.max_text_len,
                             return_tensors="np")
        return (enc["input_ids"].astype(np.int32),
                enc["attention_mask"].astype(np.int32))

    def answers(self, logits: np.ndarray) -> list[str]:
        """Answer strings: argmax over the VQA head through vqa_dict.json."""
        if self._vqa_vocab is None:
            self._vqa_vocab = load_vqa_vocab()
        id2ans = self._vqa_vocab["id2answer"]
        return [id2ans[int(i)] for i in logits.argmax(axis=-1)]

    def _run(self, fn, n: int, *arrays: np.ndarray) -> np.ndarray:
        b = _next_bucket(n, self.max_batch)
        tensors = [torch.from_numpy(np.ascontiguousarray(_pad_to(a, b)))
                   .to(self.device) for a in arrays]
        with torch.inference_mode():
            out = fn(*tensors)
        return out.cpu().numpy()[:n]

    @staticmethod
    def _images(images: np.ndarray) -> np.ndarray:
        if not isinstance(images, np.ndarray) or images.dtype != np.uint8:
            raise ValueError("pass uint8 NHWC images")
        return images

    def _encode_image_fn(self, img_u8) -> torch.Tensor:
        t = self.task
        h = t.stream_below_fusion(img=normalize_image(img_u8, t.config.dtype))
        feats = t.continue_single_stream(h, None, "v")
        return t.itc_project(feats[:, 0], "v").to(torch.float32)

    def _encode_text_fn(self, ids, mask) -> torch.Tensor:
        t = self.task
        h = t.stream_below_fusion(txt=ids, txt_mask=mask)
        feats = t.continue_single_stream(h, mask, "l")
        return t.itc_project(feats[:, 0], "l").to(torch.float32)

    def _itm_fn(self, img_u8, ids, mask) -> torch.Tensor:
        batch = {"image": normalize_image(img_u8, self.task.config.dtype),
                 "text_ids": ids, "text_mask": mask}
        logits = self.task.itm_head(self.task.infer(batch, infer_mode="img-txt")["cls_feats"])
        return torch.softmax(logits.to(torch.float32), dim=-1)[:, 1]

    def _nlvr2_fn(self, img0_u8, img1_u8, ids, mask) -> torch.Tensor:
        dt = self.task.config.dtype
        batch = {"image_0": normalize_image(img0_u8, dt),
                 "image_1": normalize_image(img1_u8, dt),
                 "text_ids": ids, "text_mask": mask}
        cls = [self.task.infer(batch, infer_mode="img-txt",
                               image_token_type_idx=i)["cls_feats"] for i in (1, 2)]
        logits = self.task.nlvr2_logits(torch.cat(cls, dim=-1))
        return torch.softmax(logits.to(torch.float32), dim=-1)[:, 1]

    def _vqa_fn(self, img_u8, ids, mask) -> torch.Tensor:
        batch = {
            "image": normalize_image(img_u8, self.task.config.dtype),
            "text_ids": ids,
            "text_mask": mask,
        }
        infer = self.task.infer(batch, infer_mode="img-txt")
        return self.task.vqa_logits(infer["cls_feats"]).to(torch.float32)

    # ---------------------------------------------------------- endpoints

    def vqa_logits(self, img_u8: np.ndarray, ids: np.ndarray,
                   mask: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 images, (N, L) int32 token ids and mask ->
        (N, vqa_label_size) fp32 logits."""
        self._images(img_u8)
        if not len(img_u8) == len(ids) == len(mask):
            raise ValueError("vqa_logits expects paired images, ids and masks")
        return self._run(self._vqa_fn, len(img_u8), img_u8, ids, mask)

    def vqa(self, images: np.ndarray, questions: Sequence[str]) -> list[str]:
        """Answer strings for paired (image_i, question_i)."""
        ids, mask = self.tokenize(questions)
        return self.answers(self.vqa_logits(images, ids, mask))

    def encode_image(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 images -> (N, itc_dim) unit-norm fp32 ITC
        embeddings."""
        img = self._images(images)
        return self._run(self._encode_image_fn, len(img), img)

    def encode_text_ids(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """(N, L) int32 token ids and mask -> (N, itc_dim) unit-norm fp32
        ITC embeddings."""
        if len(ids) != len(mask):
            raise ValueError("encode_text_ids expects paired ids and masks")
        return self._run(self._encode_text_fn, len(ids), ids, mask)

    def encode_text(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode_text_ids(*self.tokenize(texts))

    def similarity(self, img_emb: np.ndarray, txt_emb: np.ndarray) -> np.ndarray:
        """(N_img, N_txt) cosines scaled by the ITC temperature exp(itc_temp)
        (1 / model.itc_temp for weights without an ITC head)."""
        t = self.task
        temp = (float(np.exp(t.itc_temp.detach().float().cpu().numpy()))
                if hasattr(t, "itc_temp") else 1.0 / float(t.config.itc_temp))
        return (img_emb @ txt_emb.T) * temp

    def itm_score_ids(self, images: np.ndarray, ids: np.ndarray,
                      mask: np.ndarray) -> np.ndarray:
        """The ITM head's match probability (N,) of paired (image_i, text_i)."""
        img = self._images(images)
        if not len(img) == len(ids) == len(mask):
            raise ValueError("itm_score expects paired images and texts")
        return self._run(self._itm_fn, len(img), img, ids, mask)

    def itm_score(self, images: np.ndarray, texts: Sequence[str]) -> np.ndarray:
        return self.itm_score_ids(images, *self.tokenize(texts))

    def nlvr2_ids(self, images_left: np.ndarray, images_right: np.ndarray,
                  ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """P(the statement is true of the image pair) (N,): the statement
        fused with each image (token types 1 and 2), the concatenated CLS
        features through the NLVR2 head, as `compute_nlvr2` evaluates."""
        img0, img1 = self._images(images_left), self._images(images_right)
        if not len(img0) == len(img1) == len(ids) == len(mask):
            raise ValueError("nlvr2 expects paired left and right images and texts")
        return self._run(self._nlvr2_fn, len(ids), img0, img1, ids, mask)

    def nlvr2(self, images_left: np.ndarray, images_right: np.ndarray,
              statements: Sequence[str]) -> np.ndarray:
        return self.nlvr2_ids(images_left, images_right, *self.tokenize(statements))
