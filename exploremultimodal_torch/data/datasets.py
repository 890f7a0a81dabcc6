"""Datasets (counterpart of `exploremultimodal_tpu/data/datasets.py`): the
arrow image-text datasets and their VQA, referring-box, classification and
NLVR2 variants, the packed text corpus, the synthetic dataset and their
concatenation. Each gives JAX's samples for the same files and seeds.

- `ImageTextArrowDataset` reads `<data_root>/<name>.arrow` (arrow IPC
  files, one table each) and flattens (image row, caption j) pairs. A
  sample draws everything from `random.Random(crc32("split:index:epoch"))`,
  in this order: the view (RandomAugment's choices, then the crop), the
  momentum encoder's second view, the patch mask's seed, the MLM seed, the
  false captions. A sample that fails (a corrupt image) is replaced by a
  random index of the same generator, up to 10 tries.
- `TextCorpusDataset` reads a `save_to_disk` corpus (its `train` split, if
  it is a dataset dict) with pyarrow, and packs consecutive texts joined by
  ' [SEP] ' up to the token budget; a fixed permutation splits it 80/10/10.
- `SyntheticDataset` draws every contract (pretrain, text-only, VQA,
  retrieval, NLVR2, image classification, MPP, referring boxes) from a
  numpy generator seeded by the index, in JAX's order.

Images leave as uint8 crops; normalization runs on the device.
"""

from __future__ import annotations

import io
import json
import os
import random
import zlib
from typing import Any, Sequence

import numpy as np

from exploremultimodal_torch.data.masking import MaskingGenerator, RegionMaskingGenerator
from exploremultimodal_torch.data.tokenization import MlmCollator, encode_texts

Sample = dict[str, Any]


class ImageTextArrowDataset:
    """Image-caption arrow tables: one sample per (image row, caption j).
    `transform` maps a PIL image (or, with `from_bytes`, the JPEG bytes) and
    the sample's generator to a uint8 crop or a (crop, dVAE crop) pair."""

    # set by the loader (`ShardedLoader.set_epoch`): the augmentations and
    # masks differ every epoch and stay fixed per (split, index, epoch)
    epoch: int = 0

    def __init__(self, data_root: str, names: Sequence[str], *, split: str = "train",
                 transform=None, tokenizer=None, max_text_len: int = 40,
                 text_column: str = "caption", mlm_collator: MlmCollator | None = None,
                 mask_generator: MaskingGenerator | None = None, image_only: bool = False,
                 text_only: bool = False, draw_false_text: int = 0,
                 emit_image_aug: bool = False, extra_columns: Sequence[str] = ()):
        import pyarrow as pa

        self.split = split
        self.transform = transform
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.text_column = text_column
        self.mlm_collator = mlm_collator
        self.mask_generator = mask_generator
        self.image_only = image_only
        self.text_only = text_only
        self.draw_false_text = draw_false_text
        self.emit_image_aug = emit_image_aug
        self.extra_columns = list(extra_columns)

        tables = []
        for name in names:
            with pa.memory_map(os.path.join(data_root, f"{name}.arrow"), "r") as source:
                tables.append(pa.ipc.open_file(source).read_all())
        self.table = (pa.concat_tables(tables, promote_options="default")
                      if len(tables) > 1 else tables[0])
        self.index_mapper: list[tuple[int, int]] = []
        self._captions = None
        if text_column in self.table.column_names and not image_only:
            self._captions = self.table[text_column].to_pylist()
            for row, caps in enumerate(self._captions):
                n = len(caps) if isinstance(caps, list) else 1
                self.index_mapper += [(row, j) for j in range(n)]
        else:
            self.index_mapper = [(row, 0) for row in range(self.table.num_rows)]

    def __len__(self) -> int:
        return len(self.index_mapper)

    def _image_bytes(self, row: int, column: str = "image") -> bytes:
        return self.table[column][row].as_py()

    def get_raw_text(self, index: int) -> str:
        row, j = self.index_mapper[index]
        caps = self._captions[row]
        return caps[j] if isinstance(caps, list) else caps

    def _load_view(self, row: int, rng: random.Random):
        """One augmented view of an image row: (image, image4dalle | None)."""
        if hasattr(self.transform, "from_bytes"):
            out = self.transform.from_bytes(self._image_bytes(row), rng)
        else:
            from PIL import Image

            img = Image.open(io.BytesIO(self._image_bytes(row)))
            out = self.transform(img, rng) if self.transform else np.asarray(img)
        return out if isinstance(out, tuple) else (out, None)

    def _encode(self, text: str) -> tuple[np.ndarray, np.ndarray]:
        return encode_texts(self.tokenizer, [text], self.max_text_len)

    def get_sample(self, index: int, rng: random.Random) -> Sample:
        row, _ = self.index_mapper[index]
        sample: Sample = {"index": index}
        if not self.text_only:
            image, image4dalle = self._load_view(row, rng)
            sample["image_u8"] = image
            if image4dalle is not None:
                sample["image4dalle_u8"] = image4dalle
            if self.emit_image_aug:
                # the momentum encoder's independent second view
                sample["image_aug_u8"] = self._load_view(row, rng)[0]
            if self.mask_generator is not None:
                np_rng = np.random.default_rng(rng.getrandbits(32))
                sample["image_bool_masked_pos"] = self.mask_generator(np_rng).reshape(-1)
        if not self.image_only and self._captions is not None:
            ids, mask = self._encode(self.get_raw_text(index))
            sample["text_ids"] = ids[0]
            sample["text_mask"] = mask[0]
            if self.mlm_collator is not None:
                ids_mlm, labels = self.mlm_collator(ids, seed=rng.getrandbits(32))
                sample["text_ids_mlm"] = ids_mlm[0].astype(np.int32)
                sample["text_labels_mlm"] = labels[0].astype(np.int32)
        if self.draw_false_text > 0:
            # negative captions for retrieval's ranking
            pairs = [self._encode(self.get_raw_text(rng.randrange(len(self))))
                     for _ in range(self.draw_false_text)]
            sample["false_text_ids"] = np.stack([ids[0] for ids, _ in pairs])
            sample["false_text_mask"] = np.stack([mask[0] for _, mask in pairs])
        for col in self.extra_columns:
            sample[col] = self.table[col][row].as_py()
        return sample

    def __getitem__(self, index: int) -> Sample:
        """The sample of `index`, or, where drawing it raises (a corrupt
        image), of a random index, up to 10 tries."""
        rng = random.Random(zlib.crc32(f"{self.split}:{index}:{self.epoch}".encode()))
        for _ in range(10):
            try:
                return self.get_sample(index, rng)
            except Exception:
                index = rng.randrange(len(self))
        raise RuntimeError("too many corrupt samples")


class VqaArrowDataset(ImageTextArrowDataset):
    """VQAv2: a question per sample, its soft (label_size,) target from the
    `answer_labels` / `answer_scores` columns and its `question_id` as
    `qid`."""

    def __init__(self, *args, answer_vocab: dict | None = None, label_size: int = 3129,
                 **kw):
        kw.setdefault("text_column", "questions")
        super().__init__(*args, **kw)
        self.answer_vocab = answer_vocab or {}
        self.label_size = label_size

    def get_sample(self, index: int, rng: random.Random) -> Sample:
        sample = super().get_sample(index, rng)
        row, j = self.index_mapper[index]
        targets = np.zeros(self.label_size, np.float32)
        if "answer_labels" in self.table.column_names:
            labels = self.table["answer_labels"][row].as_py()[j]
            scores = self.table["answer_scores"][row].as_py()[j]
            for lab, sc in zip(labels, scores):
                targets[lab] = sc
        sample["vqa_targets"] = targets
        if "question_id" in self.table.column_names:
            qid = self.table["question_id"][row].as_py()
            sample["qid"] = np.int64(qid[j] if isinstance(qid, list) else qid)
        return sample


class RefGroundingArrowDataset(ImageTextArrowDataset):
    """Referring expressions: `caption` expressions with a `ref_boxes`
    column of one normalized (cx, cy, w, h) box each; the plain-resize
    transform keeps the boxes valid."""

    def get_sample(self, index: int, rng: random.Random) -> Sample:
        sample = super().get_sample(index, rng)
        row, j = self.index_mapper[index]
        sample["ref_box"] = np.asarray(self.table["ref_boxes"][row].as_py()[j], np.float32)
        return sample


class ImgClsArrowDataset(ImageTextArrowDataset):
    """Image classification: `image` bytes and an integer `label` column."""

    def __init__(self, *args, **kw):
        kw.setdefault("image_only", True)
        super().__init__(*args, **kw)

    def get_sample(self, index: int, rng: random.Random) -> Sample:
        sample = super().get_sample(index, rng)
        row, _ = self.index_mapper[index]
        sample["label"] = np.int32(self.table["label"][row].as_py())
        return sample


class Nlvr2ArrowDataset(ImageTextArrowDataset):
    """NLVR2: an `image_0` / `image_1` pair, a statement, its bool answer,
    and the row's `table_name` (the dev / test buckets of evaluation)."""

    def __init__(self, *args, **kw):
        kw.setdefault("text_column", "questions")
        super().__init__(*args, **kw)

    def get_sample(self, index: int, rng: random.Random) -> Sample:
        from PIL import Image

        row, j = self.index_mapper[index]
        sample: Sample = {"index": index}
        for i in (0, 1):
            img = Image.open(io.BytesIO(self._image_bytes(row, f"image_{i}")))
            out = self.transform(img, rng) if self.transform else np.asarray(img)
            sample[f"image_{i}_u8"] = out[0] if isinstance(out, tuple) else out
        ids, mask = self._encode(self.get_raw_text(index))
        sample["text_ids"] = ids[0]
        sample["text_mask"] = mask[0]
        answers = self.table["answers"][row].as_py()
        sample["answers"] = np.int32(bool(answers[j] if isinstance(answers, list) else answers))
        if "table_name" in self.table.column_names:
            sample["table_name"] = self.table["table_name"][row].as_py()
        return sample


def read_saved_dataset(data_dir: str):
    """The pyarrow table of a `datasets` `save_to_disk` directory: its
    arrow stream files in `state.json`'s order; of a dataset dict, its
    `train` split."""
    import pyarrow as pa

    dict_file = os.path.join(data_dir, "dataset_dict.json")
    if os.path.exists(dict_file):
        with open(dict_file) as f:
            splits = json.load(f)["splits"]
        if "train" not in splits:
            raise ValueError(f"{data_dir}: a dataset dict without a train split ({splits})")
        data_dir = os.path.join(data_dir, "train")
    with open(os.path.join(data_dir, "state.json")) as f:
        files = [d["filename"] for d in json.load(f)["_data_files"]]
    tables = []
    for name in files:
        with pa.memory_map(os.path.join(data_dir, name), "r") as source:
            tables.append(pa.ipc.open_stream(source).read_all())
    return pa.concat_tables(tables) if len(tables) > 1 else tables[0]


class TextCorpusDataset:
    """A text corpus in greedy packs: from its pack's first text (in a fixed
    permutation's split), texts joined by ' [SEP] ' until their tokens (each
    plus one) reach `max_text_len`; the MLM seed is crc32 of
    "split:index:epoch"."""

    epoch: int = 0

    def __init__(self, data_dir: str, *, split: str = "train", tokenizer=None,
                 max_text_len: int = 512, mlm_collator: MlmCollator | None = None,
                 text_column: str = "text", pack_ratio: int = 4):
        self.texts = read_saved_dataset(data_dir)[text_column]
        n = len(self.texts)
        perm = np.random.default_rng(0).permutation(n)
        bounds = {"train": (0, int(0.8 * n)), "val": (int(0.8 * n), int(0.9 * n)),
                  "test": (int(0.9 * n), n)}
        lo, hi = bounds[split]
        self.split = split
        self.indices = perm[lo:hi]
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.mlm_collator = mlm_collator
        self.pack_ratio = pack_ratio

    def __len__(self) -> int:
        return max(len(self.indices) // self.pack_ratio, 1)

    def __getitem__(self, index: int) -> Sample:
        parts: list[str] = []
        used = 0
        i = index * self.pack_ratio
        while i < len(self.indices) and used < self.max_text_len:
            text = self.texts[int(self.indices[i])].as_py()
            parts.append(text)
            used += len(self.tokenizer.tokenize(text)) + 1
            i += 1
        ids, mask = encode_texts(self.tokenizer, [" [SEP] ".join(parts)], self.max_text_len)
        sample: Sample = {"text_ids": ids[0], "text_mask": mask[0]}
        if self.mlm_collator is not None:
            seed = zlib.crc32(f"{self.split}:{index}:{self.epoch}".encode())
            ids_mlm, labels = self.mlm_collator(ids, seed=seed)
            sample["text_ids_mlm"] = ids_mlm[0].astype(np.int32)
            sample["text_labels_mlm"] = labels[0].astype(np.int32)
        return sample


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
                 image_aug: bool = False, num_classes: int | None = None,
                 mpp_labels: bool = False, ref_boxes: bool = False, seed: int = 0):
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
        self.num_classes = num_classes
        self.mpp_labels = mpp_labels
        self.ref_boxes = ref_boxes
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
        if self.num_classes:
            sample["label"] = np.int32(rng.integers(0, self.num_classes))
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
        if self.mpp_labels:
            masked = sample["image_bool_masked_pos"]
            rgb = rng.integers(0, 256, (masked.shape[0], 3)).astype(np.int32)
            rgb[masked == 0] = -100
            sample["image_labels_mpp"] = rgb
        if self.ref_boxes:
            w, h = rng.uniform(0.1, 0.5, 2)
            cx = rng.uniform(w / 2, 1 - w / 2)
            cy = rng.uniform(h / 2, 1 - h / 2)
            sample["ref_box"] = np.asarray([cx, cy, w, h], np.float32)
        if self.nlvr:
            sample["image_0_u8"] = sample["image_u8"]
            sample["image_1_u8"] = rng.integers(
                0, 256, (self.img_size, self.img_size, 3), dtype=np.uint8)
            sample["answers"] = np.int32(rng.integers(0, 2))
        return sample


class ConcatDataset:
    """The datasets one after another (the splits of several keys)."""

    def __init__(self, datasets: Sequence[Any]):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __getitem__(self, index: int) -> Sample:
        d = int(np.searchsorted(self.offsets, index, side="right") - 1)
        return self.datasets[d][index - int(self.offsets[d])]


def build_dataset(cfg: dict, split: str = "train") -> SyntheticDataset:
    """The synthetic dataset of `cfg` for `split` ('train', 'val' or
    'test'), as the JAX `MultiTaskData` builds the `synthetic` key, whose samples are the
    same in every split: a phase with masked images (pretraining, or MIM) gets
    the configured patch masker and the dVAE's half-size image, any other
    the default masker and no second image; `data.mask_style=region`
    gives a phase with masked images one region a sample instead; `vqa`
    adds the VQA targets, `irtr` `train.draw_false_text` false captions (3
    where unset), `nlvr2` the image pair and answer, `imgcls` a class
    label of `model.num_classes` (1000 where 0), `mpp` the MPP targets,
    `refcoco` the referring box, `vlmo_ema` the momentum encoder's second
    view on the train split; a phase named `*txt*` whose losses are at
    most MLM gets text-only samples."""
    if split not in ("train", "val", "test"):
        raise ValueError(f"split {split!r}")
    t = cfg["train"]
    d, m = cfg["data"], cfg["model"]
    losses = set(t["loss_names"])
    masked_image = t["phase"].startswith("pretrain") or "mim" in losses
    grid = m["img_size"] // m["patch_size"]
    if masked_image and d.get("mask_style", "block") == "region":
        masker = RegionMaskingGenerator(grid, d["num_mask_patches"])
    elif masked_image:
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
        image_aug=bool(cfg.get("vlmo_ema")) and split == "train",
        num_classes=int(m.get("num_classes") or 1000) if "imgcls" in losses else None,
        mpp_labels="mpp" in losses, ref_boxes="refcoco" in losses)
