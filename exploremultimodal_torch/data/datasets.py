"""The synthetic dataset (counterpart of
`exploremultimodal_tpu/data/datasets.py` `SyntheticDataset`, its pretrain,
text-only, VQA, retrieval and NLVR2 contracts): the same samples, drawn in the same order from the same numpy
generator, so a seed gives the JAX package's batch.

The repository holds no image-text arrow shards, so this is the training
data of the port for now.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from exploremultimodal_torch.data.masking import MaskingGenerator

Sample = dict[str, Any]


class SyntheticDataset:
    """Deterministic in-memory samples with the pretrain batch contract:
    token ids and mask, MLM ids and labels, a uint8 image, its blockwise
    patch mask, the half-size uint8 image for the dVAE tokenizer (where
    `second_size` is set), a one-hot VQA target over `vqa_label_size`
    answers (where that is set), `draw_false_text` false captions (token ids
    and an all-ones mask) for retrieval, with `nlvr` an image pair (the
    first the sample's image) and a 0/1 answer, and with `image_aug` a
    second uint8 view `image_aug_u8` for the momentum encoder, drawn right
    after the image. With `text_only` a sample
    ends before its image is drawn (the text phases: token ids and mask,
    MLM ids and labels)."""

    def __init__(self, size: int = 256, *, img_size: int = 224,
                 second_size: int | None = 112, max_text_len: int = 40,
                 vocab_size: int = 30522, mask_generator: MaskingGenerator,
                 vqa_label_size: int | None = None, text_only: bool = False,
                 draw_false_text: int = 0, nlvr: bool = False,
                 image_aug: bool = False, seed: int = 0):
        self.size = size
        self.img_size = img_size
        self.second_size = second_size
        self.max_text_len = max_text_len
        self.vocab_size = vocab_size
        self.mask_generator = mask_generator
        self.vqa_label_size = vqa_label_size
        self.text_only = text_only
        self.draw_false_text = draw_false_text
        self.nlvr = nlvr
        self.image_aug = image_aug
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> Sample:
        rng = np.random.default_rng(self.seed * 100003 + index)
        L = self.max_text_len
        ids = rng.integers(1000, self.vocab_size, (L,)).astype(np.int32)
        ids[0], ids[-1] = 101, 102  # [CLS] ... [SEP]
        n_valid = int(rng.integers(L // 2, L + 1))
        mask = np.zeros(L, np.int32)
        mask[:n_valid] = 1

        ids_mlm = ids.copy()
        labels = np.full(L, -100, np.int32)
        mlm_pos = (rng.random(L) < 0.15) & (mask > 0)
        mlm_pos[0] = False
        labels[mlm_pos] = ids[mlm_pos]
        ids_mlm[mlm_pos] = 103  # [MASK]

        sample: Sample = {
            "index": np.int64(index),
            "text_ids": ids,
            "text_mask": mask,
            "text_ids_mlm": ids_mlm,
            "text_labels_mlm": labels,
        }
        if self.text_only:
            return sample
        sample["image_u8"] = rng.integers(0, 256, (self.img_size, self.img_size, 3),
                                          dtype=np.uint8)
        if self.image_aug:
            sample["image_aug_u8"] = rng.integers(
                0, 256, (self.img_size, self.img_size, 3), dtype=np.uint8)
        sample["image_bool_masked_pos"] = self.mask_generator(rng).reshape(-1)
        if self.second_size:
            sample["image4dalle_u8"] = rng.integers(
                0, 256, (self.second_size, self.second_size, 3), dtype=np.uint8)
        if self.vqa_label_size:
            t = np.zeros(self.vqa_label_size, np.float32)
            t[rng.integers(0, self.vqa_label_size)] = 1.0
            sample["vqa_targets"] = t
        if self.draw_false_text:
            sample["false_text_ids"] = rng.integers(
                1000, self.vocab_size, (self.draw_false_text, L)).astype(np.int32)
            sample["false_text_mask"] = np.ones((self.draw_false_text, L), np.int32)
        if self.nlvr:
            sample["image_0_u8"] = sample["image_u8"]
            sample["image_1_u8"] = rng.integers(
                0, 256, (self.img_size, self.img_size, 3), dtype=np.uint8)
            sample["answers"] = np.int32(rng.integers(0, 2))
        return sample


def build_dataset(cfg: dict, split: str = "train") -> SyntheticDataset:
    """The dataset of `cfg` for `split` ('train', 'val' or 'test'), as the
    JAX `MultiTaskData` builds the `synthetic` key, whose samples are the
    same in every split: a phase with masked images (pretraining, or MIM) gets
    the configured patch masker and the dVAE's half-size image, any other
    the default masker and no second image; `vqa` adds the VQA targets,
    `irtr` `train.draw_false_text` false captions (3 where unset), `nlvr2`
    the image pair and answer, `vlmo_ema` the momentum encoder's second
    view on the train split; a phase named `*txt*` whose losses are at
    most MLM gets text-only samples.
    Only `train.datasets=[synthetic]` is ported."""
    if split not in ("train", "val", "test"):
        raise ValueError(f"split {split!r}")
    t = cfg["train"]
    keys = list(t["datasets"])
    if keys != ["synthetic"]:
        raise NotImplementedError(
            f"train.datasets={keys}: only the synthetic dataset is ported (the "
            "repository holds no arrow shards); pass 'train.datasets=[synthetic]'")
    d, m = cfg["data"], cfg["model"]
    if d.get("mask_style", "block") != "block":
        raise NotImplementedError(f"data.mask_style={d['mask_style']!r}")
    losses = set(t["loss_names"])
    masked_image = t["phase"].startswith("pretrain") or "mim" in losses
    grid = m["img_size"] // m["patch_size"]
    if masked_image:
        masker = MaskingGenerator(
            grid, num_masking_patches=d["num_mask_patches"],
            min_num_patches=d.get("min_mask_patches_per_block") or 4,
            max_num_patches=d.get("max_mask_patches_per_block"))
    else:
        masker = MaskingGenerator(grid, d["num_mask_patches"],
                                  min_num_patches=min(16, d["num_mask_patches"]))
    return SyntheticDataset(
        size=d.get("synthetic_size", 256), img_size=m["img_size"],
        second_size=m["img_size"] // 2 if masked_image else None,
        max_text_len=m["max_text_len"], vocab_size=m["vocab_size"],
        mask_generator=masker,
        vqa_label_size=d["vqav2_label_size"] if "vqa" in losses else None,
        text_only=losses <= {"mlm"} and "txt" in t["phase"],
        draw_false_text=int(t.get("draw_false_text", 3)) if "irtr" in losses else 0,
        nlvr="nlvr2" in losses,
        image_aug=bool(cfg.get("vlmo_ema")) and split == "train")
