"""Serving API over one set of VLMo weights (counterpart of
`exploremultimodal_tpu/infer.py`): VQA answers, the ITC embeddings of
images and texts and their similarity, the ITM match probability, the
NLVR2 probability, captions by mask-predict decoding over the MLM head,
and text-conditioned inpainting through the MIM head and the DALL-E
decoder.

Each text endpoint has a method on token-id arrays (`vqa_logits`,
`encode_text_ids`, `itm_score_ids`, `nlvr2_ids`, `caption_ids`,
`inpaint_ids`) and one on strings (`vqa`, `encode_text`, `itm_score`,
`nlvr2`, `caption`, `inpaint`) that tokenizes with the port's BERT
WordPiece tokenizer (`data/tokenization.py`) and calls it. Images are
uint8 NHWC arrays at the model's size, or PIL images of any size, which
`preprocess_images` resizes as the eval transform does.

Every call pads its batch to a power-of-two bucket (at most `max_batch`) with
copies of the last row, runs, and slices the result back, as the JAX
`Predictor` does. With `devices` (JAX's `mesh`: data-parallel serving) the
process keeps one replica of the weights on each device, as JAX's single
controller does; the bucket rounds up to a multiple of the devices, each
replica runs its equal shard of it, and the outputs are concatenated in
order. Under `model.quantize=w8a8` more than one device is refused: JAX's
mesh is one program whose `quant_dot` takes one activation absmax over the
whole bucket, which shards quantized apart would not reproduce (ROADMAP
A10); `w8a8_pallas*` (a scale per row) and bf16 serve on any number.
Weights come as a `VlmoTask` state_dict: from
`models.convert.from_flax_params`, or from `build_model(...).state_dict()`
for seeded random weights; or through `Predictor.from_checkpoint`, from a
checkpoint directory the trainer saved, a BEiT/VLMo `.pth` file, or a
`file://` or `https://` URL of either.
"""

from __future__ import annotations

import copy
import math
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from exploremultimodal_torch.config import VlmoConfig, load_config
from exploremultimodal_torch.data.tokenization import encode_texts, get_tokenizer
from exploremultimodal_torch.data.transforms import EvalTransform
from exploremultimodal_torch.data.vqa_vocab import load_vqa_vocab
from exploremultimodal_torch.models.dvae import create_d_vae, map_pixels, unmap_pixels
from exploremultimodal_torch.models.task import VlmoTask, build_model, resolve_device
from exploremultimodal_torch.ops.preprocess import normalize_image
from exploremultimodal_torch.ops.quant import site_mode


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


def mask_predict_step(logits: torch.Tensor, ids: torch.Tensor, gen: torch.Tensor,
                      n_gen: torch.Tensor, it: int, n_iter: int,
                      mask_id: int) -> torch.Tensor:
    """Iteration `it` of `n_iter` of mask-predict decoding, as the body of
    JAX's `_caption_fn`: every generated position (`gen`, `n_gen` of them
    a row) takes the argmax of its fp32 `logits`; the ceil(n_gen (it + 1) /
    n_iter) most confident (largest log-softmax maximum; ranks from two
    stable sorts, positions not generated at -inf) keep it and the rest
    take `mask_id`; the other positions keep `ids`. The ids keep their
    dtype (int32)."""
    pred = logits.argmax(dim=-1).to(ids.dtype)
    conf = torch.log_softmax(logits, dim=-1).amax(dim=-1)
    conf = torch.where(gen, conf, torch.full_like(conf, -math.inf))
    # JAX's int32 / int true division: float32
    n_keep = torch.ceil((n_gen * (it + 1)).to(torch.float32) / n_iter).to(torch.int32)
    order = torch.argsort(-conf, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    keep = rank < n_keep[:, None]
    return torch.where(gen, torch.where(keep, pred, torch.full_like(pred, mask_id)), ids)


class Predictor:
    """Serving over one set of weights, on `device` (CUDA by default). The
    endpoints need the heads of the train phase the weights come from:
    `vqa*` finetune_vqa's, `encode_*`, `similarity` and `itm_score*`
    pretrain_mum's (ITC and ITM), `nlvr2*` finetune_nlvr2's, `caption*`
    finetune_caption's (MLM), `inpaint*` finetune_inpainting's (MIM)."""

    def __init__(self, cfg: dict, state_dict: dict, *, max_batch: int = 64,
                 device: str | torch.device = "cuda",
                 devices: Sequence[str | torch.device] | None = None):
        self.cfg = cfg
        model_cfg = VlmoConfig.from_config(cfg)
        quantize = model_cfg.quantize
        if len(devices or ()) > 1 and any(site_mode(quantize, site) == "w8a8"
                                           for site in ("qkv", "proj", "mlp")):
            raise ValueError(
                f"model.quantize={quantize} on more than one device: JAX's data mesh is "
                "one GSPMD program whose quant_dot takes one activation absmax over the "
                "whole bucket, which the port's replicas, each quantizing its own shard, "
                "do not gather yet (ROADMAP §A10); use w8a8_pallas (a scale per row) or "
                "one device")
        task = VlmoTask(model_cfg)
        task.load_state_dict(state_dict, strict=True)
        task.eval().requires_grad_(False)
        # one replica per device (`devices`), else the one on `device`
        self.replicas = [(dev, copy.deepcopy(task).to(dev)) for dev in
                         (resolve_device(d) for d in (devices or [device]))]
        self.device, self.task = self.replicas[0]
        self.max_batch = int(max_batch)
        self._tokenizer = None
        self._vqa_vocab = None
        # the dVAE of the first replica's device, and of the others'
        self._dvae = None
        self._dvaes: dict = {}

    @classmethod
    def from_checkpoint(cls, checkpoint: str, overrides: Sequence[str] = (),
                        max_batch: int = 64, device: str | torch.device = "cuda",
                        devices: Sequence[str | torch.device] | None = None
                        ) -> "Predictor":
        """Serve the weights of `checkpoint`: a checkpoint directory of the
        port's trainer (`checkpoint-<epoch>/`), a BEiT/VLMo `.pth` file
        (`models.import_torch`, over seeded random weights for what it
        lacks), or a `file://` / `https://` URL of either. `overrides` select
        the model and train groups the weights were trained with (the train
        phase decides which heads exist); `devices` as the constructor takes
        them."""
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
        return cls(cfg, state_dict, max_batch=max_batch, device=device, devices=devices)

    # ------------------------------------------------------- host helpers

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            d = self.cfg["data"]
            self._tokenizer = get_tokenizer(d["tokenizer"], d.get("tokenizer_dir"))
        return self._tokenizer

    def tokenize(self, texts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """(N, max_text_len) int32 ids and mask, padded and truncated."""
        return encode_texts(self.tokenizer, list(texts), self.task.config.max_text_len)

    def preprocess_images(self, images) -> np.ndarray:
        """PIL images of any size -> (N, S, S, 3) uint8 at the model's size,
        resized bicubic as `transforms.EvalTransform` does."""
        t = EvalTransform(self.task.config.img_size)
        return np.stack([np.asarray(t(im)) for im in images])

    def answers(self, logits: np.ndarray) -> list[str]:
        """Answer strings: argmax over the VQA head through vqa_dict.json."""
        if self._vqa_vocab is None:
            self._vqa_vocab = load_vqa_vocab()
        id2ans = self._vqa_vocab["id2answer"]
        return [id2ans[int(i)] for i in logits.argmax(axis=-1)]

    def _run(self, fn, n: int, *arrays: np.ndarray):
        """`fn` on the arrays padded to the batch's bucket (a multiple of
        the replicas), each replica on its equal shard; its output (or each
        of a tuple of outputs) concatenated in order and sliced back to `n`
        rows on the host."""
        d = len(self.replicas)
        b = -(-_next_bucket(n, self.max_batch) // d) * d
        shard = b // d
        padded = [np.ascontiguousarray(_pad_to(a, b)) for a in arrays]
        outs = []
        try:
            with torch.inference_mode():
                # every replica's launches first, then the reads
                for k, (self.device, self.task) in enumerate(self.replicas):
                    outs.append(fn(*(torch.from_numpy(a[k * shard:(k + 1) * shard])
                                     .to(self.device) for a in padded)))
        finally:
            self.device, self.task = self.replicas[0]
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate([o[i].cpu().numpy() for o in outs])[:n]
                         for i in range(len(outs[0])))
        return np.concatenate([o.cpu().numpy() for o in outs])[:n]

    def _images(self, images) -> np.ndarray:
        """uint8 NHWC arrays as they are; anything else (PIL images) through
        `preprocess_images`."""
        if isinstance(images, np.ndarray):
            if images.dtype != np.uint8:
                raise ValueError("pass uint8 NHWC images (or PIL images)")
            return images
        return self.preprocess_images(images)

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

    def _caption_logits(self, h_img, ids, mask) -> torch.Tensor:
        """The MLM head's fp32 logits of the text rows `ids` fused with the
        image's hidden states below the fusion layer `h_img`: the text
        stream below fusion, then the fused top."""
        t = self.task
        h_txt = t.stream_below_fusion(txt=ids, txt_mask=mask)
        co_feats, _ = t.transformer.fuse_from_hidden(h_img, h_txt, mask)
        return t.mlm_logits(co_feats[:, : t.config.max_text_len]).to(torch.float32)

    def _caption_fn(self, img_u8, ids, mask, n_iter: int, mask_id: int) -> torch.Tensor:
        """Mask-predict decoding (JAX's `_caption_fn`): the image stream
        below the fusion layer runs once; each of the `n_iter` iterations
        runs the text stream and the fused top on the current ids and takes
        one `mask_predict_step`. No value is read on the host inside the
        loop."""
        t = self.task
        h_img = t.stream_below_fusion(img=normalize_image(img_u8, t.config.dtype))
        gen = ids == mask_id
        n_gen = gen.sum(dim=1, dtype=torch.int32)
        cur = ids
        for it in range(n_iter):
            cur = mask_predict_step(self._caption_logits(h_img, cur, mask), ids, gen, n_gen,
                                    it, n_iter, mask_id)
        return cur

    def _inpaint_logits(self, img_u8, patch_mask, ids, mask) -> torch.Tensor:
        """MIM logits of every patch, the masked ones replaced by the mask
        token, from the fused image-text stream (compute_mim's `mum`
        path)."""
        t = self.task
        batch = {"image": normalize_image(img_u8, t.config.dtype),
                 "image_bool_masked_pos": patch_mask, "text_ids": ids, "text_mask": mask}
        img_feats = t.infer(batch, infer_mode="img-txt", mask_img=True)["img_feats"]
        return t.mim_logits(img_feats[:, 1:]).to(torch.float32)

    def _inpaint_fn(self, img_u8, patch_mask, ids, mask):
        """The image at the dVAE's size (antialiased bilinear, as
        `jax.image.resize` downscales), its codes, the MIM head's codes at
        the masked patches merged in, decoded, and pasted into the image at
        the masked cells; all on the device. Returns (images in [0, 1],
        merged int32 codes)."""
        grid = self.task.config.img_size // self.task.config.patch_size
        size, cell = self.dvae.image_size, self.dvae.image_size // grid
        img = F.interpolate((img_u8.to(torch.float32) / 255.0).permute(0, 3, 1, 2),
                            size=(size, size), mode="bilinear", align_corners=False,
                            antialias=True).permute(0, 2, 3, 1)
        codes = self.dvae.get_codebook_indices(map_pixels(img))
        pred = self._inpaint_logits(img_u8, patch_mask, ids, mask).argmax(dim=-1)
        merged = torch.where(patch_mask > 0, pred, codes)
        recon = unmap_pixels(torch.sigmoid(self.dvae.decode(merged)[..., :3]))
        pix = patch_mask.reshape(-1, grid, grid).repeat_interleave(cell, 1)
        pix = pix.repeat_interleave(cell, 2)[..., None]
        out = torch.where(pix > 0, recon, img).clamp(0.0, 1.0)
        return out, merged.to(torch.int32)

    @property
    def dvae(self):
        """The frozen DALL-E tokenizer with its decoder at img_size // 2,
        built at first use as JAX's `Predictor.dvae` builds it: OpenAI's
        weights from `train.discrete_vae_weight_path` where an
        `encoder.pkl` is there, else the seeded random one; one on each
        replica's device."""
        first = self.device == self.replicas[0][0]
        if (self._dvae if first else self._dvaes.get(self.device)) is None:
            from exploremultimodal_torch.train.trainer import dvae_type

            t = self.cfg["train"]
            vae = create_d_vae(
                dvae_type(t), self.task.config.img_size // 2, self.task.config.dtype,
                device=self.device, weight_path=t.get("discrete_vae_weight_path", ""),
                decoder=True)
            if first:
                self._dvae = vae
            else:
                self._dvaes[self.device] = vae
        return self._dvae if first else self._dvaes[self.device]

    # ---------------------------------------------------------- endpoints

    def vqa_logits(self, img_u8, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 images (or PIL images), (N, L) int32 token ids
        and mask -> (N, vqa_label_size) fp32 logits."""
        img_u8 = self._images(img_u8)
        if not len(img_u8) == len(ids) == len(mask):
            raise ValueError("vqa_logits expects paired images, ids and masks")
        return self._run(self._vqa_fn, len(img_u8), img_u8, ids, mask)

    def vqa(self, images, questions: Sequence[str]) -> list[str]:
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

    def caption_ids(self, images: np.ndarray, ids: np.ndarray, mask: np.ndarray,
                    n_iter: int, mask_id: int) -> np.ndarray:
        """Mask-predict decoding over the MLM head (`_caption_fn`): (N, H, W,
        3) uint8 images and (N, L) int32 rows `[CLS] [MASK]... [SEP]
        [PAD]...` with their mask -> the (N, L) int32 ids after `n_iter`
        refinements, every `mask_id` filled."""
        img = self._images(images)
        if not len(img) == len(ids) == len(mask):
            raise ValueError("caption_ids expects paired images, ids and masks")
        def fn(*xs):
            return self._caption_fn(*xs, n_iter=int(n_iter), mask_id=int(mask_id))

        return self._run(fn, len(img), img, ids.astype(np.int32), mask.astype(np.int32))

    def caption(self, images: np.ndarray, max_tokens: int = 16,
                n_iter: int = 8) -> list[str]:
        """Caption strings: `max_tokens` (at most max_text_len - 2)
        generated tokens by `caption_ids`, decoded by the tokenizer without
        the special tokens."""
        tok = self.tokenizer
        length = self.task.config.max_text_len
        n_tok = min(int(max_tokens), length - 2)
        row = ([tok.cls_token_id] + [tok.mask_token_id] * n_tok + [tok.sep_token_id]
               + [tok.pad_token_id] * (length - 2 - n_tok))
        images = self._images(images)
        n = len(images)
        ids = np.tile(np.asarray(row, np.int32), (n, 1))
        mask = np.zeros((n, length), np.int32)
        mask[:, : n_tok + 2] = 1
        out = self.caption_ids(images, ids, mask, n_iter, tok.mask_token_id)
        special = {tok.sep_token_id, tok.pad_token_id, tok.cls_token_id,
                   tok.mask_token_id}
        return [tok.decode([int(t) for t in r[1: n_tok + 1] if int(t) not in special],
                           skip_special_tokens=True).strip() for r in out]

    def inpaint_ids(self, images: np.ndarray, patch_mask: np.ndarray, ids: np.ndarray,
                    mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Text-conditioned inpainting (`_inpaint_fn`): (N, H, W, 3) uint8
        images, `patch_mask` (N, grid^2) or (N, grid, grid) 0/1 with the
        patches to repaint, (N, L) int32 caption ids and mask -> (the
        repainted fp32 images in [0, 1] at img_size // 2, NHWC; the merged
        (N, grid^2) int32 dVAE codes). Needs the dVAE's grid (img_size / 16)
        to be the patch grid, i.e. patch_size 16."""
        img = self._images(images)
        c = self.task.config
        grid = c.img_size // c.patch_size
        if c.img_size // 16 != grid:
            raise ValueError(f"inpaint needs patch_size 16 (the dVAE's 8x grid at "
                             f"img_size // 2), not {c.patch_size}")
        n = len(img)
        pm = np.asarray(patch_mask, np.int32).reshape(n, grid * grid)
        if not n == len(ids) == len(mask):
            raise ValueError("inpaint expects paired images, masks and texts")
        return self._run(self._inpaint_fn, n, img, pm, ids.astype(np.int32),
                         mask.astype(np.int32))

    def inpaint(self, images: np.ndarray, patch_mask: np.ndarray,
                texts: Sequence[str] | None = None) -> tuple[np.ndarray, np.ndarray]:
        """`inpaint_ids` with optional captions of the whole image (empty
        ones where None)."""
        ids, mask = self.tokenize(list(texts) if texts is not None else [""] * len(images))
        return self.inpaint_ids(images, patch_mask, ids, mask)
