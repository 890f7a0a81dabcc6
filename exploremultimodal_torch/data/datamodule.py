"""The data of a phase (counterpart of `exploremultimodal_tpu/data/datamodule.py`
`MultiTaskData`): each key of `train.datasets` gives its dataset of each
split, concatenated in the keys' order, and the loaders of the three splits.

A key names arrow tables under `data.data_root` (`ARROW_TABLES`: coco,
f30k, vg, gcc, sbu, vqa, nlvr2, imgcls, refcoco), a `save_to_disk` text
corpus there (`NLP_KEYS`: book, wiki), or the in-memory `synthetic`
dataset; a key whose files are absent is skipped, as JAX skips it. A
pretraining phase, or any with MIM, crops twice (img_size bicubic, and
img_size // 2 Lanczos for the dVAE) and masks patches; the others crop
once.
"""

from __future__ import annotations

import os

from exploremultimodal_torch.data.datasets import (
    ConcatDataset,
    ImageTextArrowDataset,
    ImgClsArrowDataset,
    Nlvr2ArrowDataset,
    RefGroundingArrowDataset,
    TextCorpusDataset,
    VqaArrowDataset,
    build_dataset,
)
from exploremultimodal_torch.data.masking import MaskingGenerator, RegionMaskingGenerator
from exploremultimodal_torch.data.pipeline import ShardedLoader
from exploremultimodal_torch.data.tokenization import MlmCollator, get_tokenizer
from exploremultimodal_torch.data.transforms import (
    EvalTransform,
    FinetuneTransform,
    NativePretrainTransform,
    PretrainTransform,
)
from exploremultimodal_torch.data.vqa_vocab import load_or_build_vqa_vocab

# arrow table names per (key, split)
ARROW_TABLES: dict[str, dict[str, list[str]]] = {
    "coco": {
        "train": ["coco_caption_karpathy_train", "coco_caption_karpathy_restval"],
        "val": ["coco_caption_karpathy_val"],
        "test": ["coco_caption_karpathy_test"],
    },
    "f30k": {
        "train": ["f30k_caption_karpathy_train"],
        "val": ["f30k_caption_karpathy_val"],
        "test": ["f30k_caption_karpathy_test"],
    },
    "vg": {"train": ["vg"], "val": [], "test": []},
    "gcc": {
        "train": [f"conceptual_caption_train_{i}" for i in range(31)],
        "val": ["conceptual_caption_val_0"],
        "test": [],
    },
    "sbu": {"train": [f"sbu_{i}" for i in range(9)], "val": [], "test": []},
    "vqa": {
        "train": ["vqav2_train", "vqav2_trainable_val"],
        "val": ["vqav2_rest_val"],
        "test": ["vqav2_test"],
    },
    "nlvr2": {
        "train": ["nlvr2_train"],
        "val": ["nlvr2_dev"],
        "test": ["nlvr2_dev", "nlvr2_test1"],
    },
    "imgcls": {"train": ["imgcls_train"], "val": ["imgcls_val"], "test": ["imgcls_test"]},
    "refcoco": {"train": ["refcoco_train"], "val": ["refcoco_val"],
                "test": ["refcoco_test"]},
}

NLP_KEYS = {"book": "bookcorpus", "wiki": "wikipedia"}
SPLITS = ("train", "val", "test")


class MultiTaskData:
    """The datasets of `cfg`'s `train.datasets` per split, and their loaders
    (`data.num_workers` threads, `data.prefetch_depth` batches ahead, this
    process's stride of `process_count`)."""

    def __init__(self, cfg: dict, *, process_index: int = 0, process_count: int = 1):
        self.cfg = cfg
        d, t = cfg["data"], cfg["train"]
        self.batch_size = d["batch_size"]
        self.eval_batch_size = d.get("eval_batch_size") or d["batch_size"]
        self.process_index = process_index
        self.process_count = process_count
        self.is_pretrain = t["phase"].startswith("pretrain")
        # MIM in a finetune phase (finetune_inpainting) also takes the two
        # crops, the patch masks and the dVAE's image
        self.masked_image = self.is_pretrain or "mim" in set(t["loss_names"])
        self._tokenizer = None
        self._mlm_collator = None
        self.vqa_vocab = None
        keys = list(t["datasets"])
        self.datasets = {}
        for split in SPLITS:
            parts = [ds for k in keys for ds in [self._build(k, split)]
                     if ds is not None and len(ds) > 0]
            # one dataset stands alone (the same samples, its own attributes)
            self.datasets[split] = parts[0] if len(parts) == 1 else ConcatDataset(parts)

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            d = self.cfg["data"]
            self._tokenizer = get_tokenizer(d["tokenizer"], d.get("tokenizer_dir"))
        return self._tokenizer

    @property
    def mlm_collator(self) -> MlmCollator:
        if self._mlm_collator is None:
            d = self.cfg["data"]
            self._mlm_collator = MlmCollator(self.tokenizer,
                                             whole_word_masking=d["whole_word_masking"],
                                             mlm_prob=d["mlm_prob"])
        return self._mlm_collator

    def mask_generator(self):
        d, m = self.cfg["data"], self.cfg["model"]
        grid = m["img_size"] // m["patch_size"]
        if d.get("mask_style", "block") == "region":
            return RegionMaskingGenerator(grid, d["num_mask_patches"])
        return MaskingGenerator(grid, num_masking_patches=d["num_mask_patches"],
                                min_num_patches=d.get("min_mask_patches_per_block") or 4,
                                max_num_patches=d.get("max_mask_patches_per_block"))

    def _transform(self, split: str):
        d, size = self.cfg["data"], self.cfg["model"]["img_size"]
        second = size // 2 if self.masked_image else None
        if split != "train":
            return EvalTransform(size, second)
        if not self.masked_image:
            return FinetuneTransform(size)
        if d.get("native_loader"):
            return NativePretrainTransform(size, second)
        return PretrainTransform(size, second)

    def _build(self, key: str, split: str):
        cfg, d = self.cfg, self.cfg["data"]
        if key == "synthetic":
            return build_dataset(cfg, split)
        losses = set(cfg["train"]["loss_names"])
        max_len = cfg["model"]["max_text_len"]
        if key in NLP_KEYS:
            path = os.path.join(d["data_root"], NLP_KEYS[key])
            if not os.path.exists(path):
                return None
            # the corpora pack to 512 tokens: the position table must cover it
            nlp_len = int(d.get("nlp_max_text_len") or 512)
            if nlp_len > max_len:
                raise ValueError(
                    f"NLP corpora pack to {nlp_len} tokens but model.max_text_len="
                    f"{max_len}; launch pretrain_txt with model.max_text_len={nlp_len} "
                    "(or set data.nlp_max_text_len)")
            return TextCorpusDataset(path, split=split, tokenizer=self.tokenizer,
                                     max_text_len=nlp_len, mlm_collator=self.mlm_collator)
        tables = [name for name in ARROW_TABLES.get(key, {}).get(split, [])
                  if os.path.exists(os.path.join(d["data_root"], f"{name}.arrow"))]
        if not tables:
            return None
        common = dict(split=split, tokenizer=self.tokenizer, max_text_len=max_len,
                      mlm_collator=self.mlm_collator)
        masker = self.mask_generator() if self.masked_image else None
        if key == "vqa":
            if self.vqa_vocab is None:
                self.vqa_vocab = load_or_build_vqa_vocab()
            return VqaArrowDataset(d["data_root"], tables, transform=self._transform(split),
                                   mask_generator=masker, label_size=d["vqav2_label_size"],
                                   answer_vocab=self.vqa_vocab, **common)
        if key == "nlvr2":
            return Nlvr2ArrowDataset(d["data_root"], tables,
                                     transform=self._transform(split), **common)
        if key == "imgcls":
            return ImgClsArrowDataset(d["data_root"], tables,
                                      transform=self._transform(split), **common)
        if key == "refcoco":
            # a plain resize in every split keeps the normalized boxes valid
            return RefGroundingArrowDataset(d["data_root"], tables,
                                            transform=EvalTransform(cfg["model"]["img_size"]),
                                            **common)
        draw_false = int(cfg["train"].get("draw_false_text", 3)) if "irtr" in losses else 0
        return ImageTextArrowDataset(
            d["data_root"], tables, transform=self._transform(split), mask_generator=masker,
            image_only=d.get("image_only", False),
            draw_false_text=draw_false if split == "train" else 0,
            emit_image_aug=bool(cfg.get("vlmo_ema")) and split == "train" and self.is_pretrain,
            **common)

    def loader(self, split: str) -> ShardedLoader:
        d = self.cfg["data"]
        train = split == "train"
        return ShardedLoader(
            self.datasets[split], self.batch_size if train else self.eval_batch_size,
            shuffle=train, seed=int(self.cfg["seed"]), num_workers=d.get("num_workers", 8),
            prefetch=d.get("prefetch_depth", 4), drop_last=train,
            process_index=self.process_index, process_count=self.process_count)

    def train_loader(self) -> ShardedLoader:
        return self.loader("train")

    def val_loader(self) -> ShardedLoader:
        return self.loader("val")

    def test_loader(self) -> ShardedLoader:
        return self.loader("test")
