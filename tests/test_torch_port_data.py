"""The PyTorch port's data layer against the JAX package, on the CPU: the
BERT WordPiece tokenizer and the MLM collators (the port's own code; JAX
wraps HF `transformers`), the PIL transforms, the native JPEG loader, the
arrow datasets, the text corpus, `ShardedLoader`, `MultiTaskData`,
`Predictor` on PIL images and strings, and the trainer on arrow shards.

Shards are written in a temporary directory from a seed: small JPEGs (48 x
40 and 64 x 48, one corrupt row), captions, VQA answers with question ids,
NLVR2 pairs with their table names, class labels, referring boxes, and a
`save_to_disk` text corpus. Unless a docstring says otherwise, the port's
arrays must equal JAX's exactly (ids, masks, labels, uint8 crops, float
targets): the two packages run the same algorithms on the same draws.
"""

from __future__ import annotations

import functools
import io
import os
import random
import subprocess
import sys
import textwrap
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from PIL import Image

import exploremultimodal_tpu.data.datasets as jds
import exploremultimodal_tpu.data.transforms as jtf
from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.data import native as jnative
from exploremultimodal_tpu.data.datamodule import MultiTaskData as JaxMultiTaskData
from exploremultimodal_tpu.data.pipeline import ShardedLoader as JaxShardedLoader
from exploremultimodal_tpu.data.tokenization import MlmCollator as JaxMlmCollator
from exploremultimodal_tpu.data.tokenization import encode_texts as jax_encode_texts
from exploremultimodal_tpu.data.tokenization import get_tokenizer as jax_get_tokenizer
from exploremultimodal_tpu.data.vqa_vocab import load_or_build_vqa_vocab as jax_vocab
from exploremultimodal_tpu.infer import Predictor as JaxPredictor
from exploremultimodal_tpu.infer import _vqa_fn
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.models.task import build_model as jax_build_model
import exploremultimodal_torch.data.datasets as pds
import exploremultimodal_torch.data.transforms as ptf
from exploremultimodal_torch.config import load_config
from exploremultimodal_torch.data import native
from exploremultimodal_torch.data.datamodule import MultiTaskData
from exploremultimodal_torch.data.pipeline import ShardedLoader
from exploremultimodal_torch.data.tokenization import (
    _UNKNOWN_TO_FAST,
    MlmCollator,
    encode_texts,
    get_tokenizer,
)
from exploremultimodal_torch.data.vqa_vocab import load_or_build_vqa_vocab
from exploremultimodal_torch.infer import Predictor
from exploremultimodal_torch.main import main as port_main
import exploremultimodal_torch.models.dvae as pdvae
from exploremultimodal_torch.models.dvae import DalleEncoder
from exploremultimodal_torch.models.convert import from_flax_params
from exploremultimodal_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRINGS = [
    "", " ", "a", "A man riding a wave on top of a surfboard.",
    "Two dogs are playing with a frisbee in the park near some trees.",
    "what color is the bus?", "how many dogs", "is it raining?!",
    "Héllo WÖRLD, café crème brûlée", "naïve façade Ångström", "İstanbul ΣΑΣ",
    "你好世界 and 日本語のテキスト", "한국어 텍스트", "x y z　w",
    "tab\tnew\nline\rcarriage", "ctrl\x00\x01\x7f\x85chars", "zero​width﻿join",
    "soft­hyphen", "combining x́̀ marks", "́leading mark",
    "emoji \U0001F600 \U0001F970 \U0001FAE0 ok", "ﬁne ligature ²", "Ⅻ roman",
    "don't won't I'm we're they've it's", "e.g. U.S.A. etc...", "(parens) [brackets] {braces}",
    "hyphen-ated and under_scored", "$100 & 50% @home #tag", "quotes \"double\" 'single'",
    "«guillemets» „low“ ‘curly’", "dash — en – minus −", "ellipsis… bullet •",
    "[SEP] inside", "hello[SEP]world", "[sep] lower case", " [MASK] ", "a[CLS][CLS]b",
    "A [UNK] b", "[PAD][PAD]", "[MASK]ed", "x" * 100, "y" * 101,
    "supercalifragilisticexpialidocious" * 3 + " short", "a " * 30, "word " * 300,
    "the " + "very " * 600 + "end", "MiXeD CaSe WoRdS", "numbers 123 4.56 7,890",
    "unicode ÆØÅ æøå ÞÐ þð", "arabic العربية hebrew עברית", "thai ภาษาไทย",
    "devanagari हिन्दी", "greek αβγ ΑΒΓ", "cyrillic Привет мир", "math ∑∫√∞≠≤",
    "࢐؝ unknown to old tables ᙭᜴", "trailing space ", "  leading",
    "multiple   spaces\n\n\nand lines", "surfboard surfboards surfing surfer",
]


def _jpeg(rng, w=48, h=40):
    """A smooth random field plus noise, JPEG quality 90."""
    base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3)).astype(np.float32)
    smooth = np.asarray(Image.fromarray(base.astype(np.uint8)).resize((w, h), Image.BILINEAR),
                        np.float32)
    arr = np.clip(smooth + rng.normal(0, 12, smooth.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _write(path, table):
    with pa.OSFile(str(path), "wb") as sink:
        with pa.ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table)


CAPTIONS = ["a man riding a wave on top of a surfboard", "two dogs play in the park",
            "a red bus parked beside the road", "an unbelievably gigantic hippopotamus",
            "a plate of food with broccoli", "people walking down a busy street",
            "a cat sleeping on a laptop keyboard", "a train passing through the station"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Every table the presets read, with 5-8 rows each."""
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)

    def caps(n, k):
        return [[CAPTIONS[(i + j) % len(CAPTIONS)] for j in range(1 + (i + k) % 3)]
                for i in range(n)]

    images = [_jpeg(rng, 48 + 16 * (i % 2), 40 + 8 * (i % 3)) for i in range(8)]
    coco = pa.table({"image": [b"not a jpeg"] + images[1:6], "caption": caps(6, 0)})
    _write(root / "coco_caption_karpathy_train.arrow", coco)
    _write(root / "coco_caption_karpathy_val.arrow",
           pa.table({"image": images[:3], "caption": caps(3, 1)}))
    _write(root / "vg.arrow", pa.table({"image": images[2:7], "caption": caps(5, 2)}))
    for name, n in (("vqav2_train", 6), ("vqav2_rest_val", 3), ("vqav2_test", 3)):
        _write(root / f"{name}.arrow", pa.table({
            "image": images[:n],
            "questions": [[f"what is in picture {i}?", "is it day?"][: 1 + i % 2]
                          for i in range(n)],
            "answers": [[["surf"], ["yes", "no"]][: 1 + i % 2] for i in range(n)],
            "answer_labels": [[[3, 7], [1]][: 1 + i % 2] for i in range(n)],
            "answer_scores": [[[1.0, 0.3], [0.6]][: 1 + i % 2] for i in range(n)],
            "question_id": [[100 * i + 1, 100 * i + 2][: 1 + i % 2] for i in range(n)],
        }))
    for name, n in (("nlvr2_train", 5), ("nlvr2_dev", 3), ("nlvr2_test1", 2)):
        _write(root / f"{name}.arrow", pa.table({
            "image_0": images[:n], "image_1": images[n: 2 * n][::-1] + images[: max(0, 2 * n - 8)],
            "questions": [[f"the left image shows {CAPTIONS[i]}"] for i in range(n)],
            "answers": [[bool(i % 2)] for i in range(n)],
            "table_name": [name] * n,
        }))
    for split, n in (("train", 6), ("val", 3)):
        _write(root / f"imgcls_{split}.arrow",
               pa.table({"image": images[:n], "label": list(range(n))}))
        _write(root / f"refcoco_{split}.arrow", pa.table({
            "image": images[:n], "caption": [[f"the thing on the left {i}"] for i in range(n)],
            "ref_boxes": [[[0.3 + 0.05 * i, 0.4, 0.2, 0.3]] for i in range(n)],
        }))
    import datasets as hf_datasets

    corpus = [" ".join(CAPTIONS[(i + j) % 8] for j in range(1 + i % 4)) + "." for i in range(40)]
    hf_datasets.DatasetDict({"train": hf_datasets.Dataset.from_dict({"text": corpus})}
                            ).save_to_disk(str(root / "bookcorpus"))
    return root


@pytest.fixture(scope="module")
def toks():
    return jax_get_tokenizer(), get_tokenizer()


# ------------------------------------------------------------------ tokenizer


@pytest.mark.parametrize("max_len", [8, 40, 512])
def test_encode_texts_matches_hf(toks, max_len):
    """ids and masks of ~60 strings (accents, CJK, punctuation, controls,
    non-breaking spaces, 100+ character words, special tokens in the text,
    truncation) equal JAX's `encode_texts` through `BertTokenizerFast`."""
    hf, mine = toks
    want = jax_encode_texts(hf, STRINGS, max_len)
    got = encode_texts(mine, STRINGS, max_len)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_tokens_and_decode_match_hf(toks):
    """`tokenize` (pretrain_txt's packing counts), `convert_ids_to_tokens`
    and `decode` with and without the special tokens equal HF's."""
    hf, mine = toks
    for s in STRINGS:
        assert mine.tokenize(s) == hf.tokenize(s), s
    ids = jax_encode_texts(hf, STRINGS, 40)[0]
    rng = np.random.default_rng(0)
    rows = [list(r) for r in ids] + [list(rng.integers(0, 30522, int(n)))
                                      for n in rng.integers(0, 24, 200)]
    for r in rows:
        assert mine.convert_ids_to_tokens(r) == hf.convert_ids_to_tokens(r)
        for skip in (True, False):
            assert mine.decode(r, skip_special_tokens=skip) == hf.decode(
                r, skip_special_tokens=skip), r
    assert len(mine) == len(hf) == 30522
    assert (mine.cls_token_id, mine.sep_token_id, mine.pad_token_id, mine.mask_token_id) == (
        hf.cls_token_id, hf.sep_token_id, hf.pad_token_id, hf.mask_token_id)


def test_code_points_match_hf(toks):
    """'a' + c + 'b' for every 97th code point and every code point of the
    table of characters the fast tokenizer's Unicode tables lack: the same
    ids (the whole range was checked once this way)."""
    hf, mine = toks
    cps = {c for c in range(0, 0x110000, 97) if not 0xD800 <= c <= 0xDFFF}
    cps |= {c for lo, hi in _UNKNOWN_TO_FAST for c in range(lo, hi + 1)}
    cps |= {0x166D, 0x1734, 0x111C9}
    texts = ["a" + chr(c) + "b" for c in sorted(cps)]
    want = hf(texts, add_special_tokens=False)["input_ids"]
    assert [mine.convert_tokens_to_ids(mine.tokenize(t)) for t in texts] == want


# ------------------------------------------------------------------ collator


@pytest.mark.parametrize("wwm", [True, False])
def test_mlm_collator_matches_hf(toks, wwm):
    """Bit for bit with JAX's collator (HF's whole-word or token-level
    collator under the seeded global generators) over 50 seeds, one row at
    a time and on padded multi-row batches; unseeded calls run."""
    hf, mine = toks
    ids = jax_encode_texts(hf, STRINGS[:12] + ["[UNK] " * 5, "x" * 120], 40)[0]
    jc, pc = JaxMlmCollator(hf, whole_word_masking=wwm), MlmCollator(mine, whole_word_masking=wwm)
    for seed in range(50):
        s = seed * 7919 + (2 ** 33 if seed % 2 else 0)
        rows = [ids[seed % len(ids)][None], ids[:6]]
        for x in rows:
            want, got = jc(x, seed=s), pc(x, seed=s)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    out, labels = pc(ids)
    assert out.shape == labels.shape == ids.shape


def test_tokenizer_and_collator_are_thread_safe(toks):
    """16 threads (more than the cores) encoding and collating every string
    under a 1 us switch interval give the serial results: the word cache
    and the per-thread generators lose nothing."""
    _, mine = toks
    col = MlmCollator(mine)
    get_tokenizer.cache_clear()
    fresh = get_tokenizer()  # an empty word cache, filled by the threads

    def work(k):
        ids = encode_texts(fresh, STRINGS, 40)[0]
        return ids, [col(ids[i: i + 1], seed=k * 100 + i) for i in range(len(ids))]

    want = [work(k) for k in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        get_tokenizer.cache_clear()
        fresh = get_tokenizer()
        with ThreadPoolExecutor(16) as pool:
            got = list(pool.map(work, range(16), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    for (ids, rows), (wids, wrows) in zip(got, want):
        np.testing.assert_array_equal(ids, wids)
        for a, b in zip(rows, wrows):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


# ---------------------------------------------------------------- transforms


def _pil(seed, w=64, h=48):
    return Image.open(io.BytesIO(_jpeg(np.random.default_rng(seed), w, h)))


@pytest.mark.parametrize("op", jtf.DEFAULT_AUGS)
def test_aug_ops_match_jax(op):
    """Each RandomAugment op at level 7 from the same generator."""
    for seed in range(4):
        img = _pil(seed).convert("RGB")
        want = jtf._apply_op(img, op, 7, random.Random(seed))
        got = ptf._apply_op(img, op, 7, random.Random(seed))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_transforms_match_jax():
    """RandomAugment, the crop parameters, TwoPicCrop, the pretrain,
    finetune, eval and native transforms: the same arrays, and the
    generators left in the same state."""
    for seed in range(6):
        img = _pil(seed, 48 + 8 * seed, 40 + 4 * seed)
        raw = _jpeg(np.random.default_rng(seed), 64, 48)
        cases = [
            (jtf.RandomAugment(), ptf.RandomAugment()),
            (jtf.TwoPicCrop(32, 16), ptf.TwoPicCrop(32, 16)),
            (jtf.PretrainTransform(32, 16), ptf.PretrainTransform(32, 16)),
            (jtf.FinetuneTransform(32), ptf.FinetuneTransform(32)),
            (jtf.EvalTransform(32, 16), ptf.EvalTransform(32, 16)),
        ]
        for want_t, got_t in cases:
            rj, rp = random.Random(seed), random.Random(seed)
            want, got = want_t(img.convert("RGB"), rj), got_t(img.convert("RGB"), rp)
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert rj.random() == rp.random()
        rj, rp = random.Random(seed), random.Random(seed)
        assert ptf.random_resized_crop_params(640, 480, rp, scale=(0.08, 1.0)) == \
            jtf.random_resized_crop_params(640, 480, rj, scale=(0.08, 1.0))
        want = jtf.NativePretrainTransform(32, 16).from_bytes(raw, random.Random(seed))
        got = ptf.NativePretrainTransform(32, 16).from_bytes(raw, random.Random(seed))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_native_decode_matches_jax():
    """`decode_resize_batch` of the port's build of `native/emmloader.cc`
    equals JAX's library: crops, full images, two sizes, a corrupt buffer's
    status; the library is built under the port's build directory."""
    rng = np.random.default_rng(5)
    bufs = [_jpeg(rng, int(w), int(h)) for w, h in rng.integers(24, 200, (7, 2))]
    bufs.append(b"not a jpeg")
    boxes = np.array([[1, 2, 20, 18]] * 4 + [[-1, -1, -1, -1]] * 4, np.int32)
    for size2 in (None, 16):
        want = jnative.decode_resize_batch(bufs, 32, size2, boxes, 2)
        got = native.decode_resize_batch(bufs, 32, size2, boxes, 2)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert list(got[2]) == [0] * 7 + [1]
    assert native.LIB_PATH.startswith(native.BUILD_DIR) and native.is_available()


def test_native_loader_without_the_library_raises(monkeypatch):
    """`data.native_loader=true` with no library raises; no PIL fallback."""
    monkeypatch.setattr(native, "_state", {"error": RuntimeError("native loader: no jpeglib.h")})
    assert not native.is_available()
    with pytest.raises(RuntimeError, match="jpeglib"):
        ptf.NativePretrainTransform(32, 16)


# ------------------------------------------------------------------ datasets


def _same(got, want, where=""):
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for k in want:
        a, b = got[k], want[k]
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, (where, k)
            np.testing.assert_array_equal(a, b, err_msg=f"{where} {k}")
        else:
            assert a == b and type(a) is type(b), (where, k, a, b)


def _both(root, toks, cls_name, names, **kw):
    hf, mine = toks
    masker = kw.pop("masker", False)
    jkw, pkw = dict(kw), dict(kw)
    for d, pkg, tok, col, tf in ((jkw, jds, hf, JaxMlmCollator, jtf),
                                 (pkw, pds, mine, MlmCollator, ptf)):
        d["tokenizer"] = tok
        d["mlm_collator"] = col(tok) if kw.get("mlm", True) else None
        d.pop("mlm", None)
        if "transform" in kw:
            d["transform"] = getattr(tf, kw["transform"][0])(*kw["transform"][1:])
    if masker:
        from exploremultimodal_tpu.data.masking import MaskingGenerator as JM
        from exploremultimodal_torch.data.masking import MaskingGenerator as PM

        jkw["mask_generator"], pkw["mask_generator"] = JM(2, 2, min_num_patches=1), PM(
            2, 2, min_num_patches=1)
    return (getattr(jds, cls_name)(str(root), names, **jkw),
            getattr(pds, cls_name)(str(root), names, **pkw))


DATASET_CASES = {
    "pretrain": ("ImageTextArrowDataset", ["coco_caption_karpathy_train", "vg"],
                 dict(transform=("PretrainTransform", 32, 16), masker=True, max_text_len=12,
                      draw_false_text=2, emit_image_aug=True)),
    "native": ("ImageTextArrowDataset", ["vg"],
               dict(transform=("NativePretrainTransform", 32, 16), masker=True,
                    max_text_len=12)),
    "eval": ("ImageTextArrowDataset", ["coco_caption_karpathy_val"],
             dict(transform=("EvalTransform", 32, 16), max_text_len=12, split="val")),
    "image_only": ("ImageTextArrowDataset", ["vg"],
                   dict(transform=("FinetuneTransform", 32), image_only=True, mlm=False)),
    "vqa": ("VqaArrowDataset", ["vqav2_train"],
            dict(transform=("FinetuneTransform", 32), max_text_len=12, label_size=10)),
    "nlvr2": ("Nlvr2ArrowDataset", ["nlvr2_dev", "nlvr2_test1"],
              dict(transform=("FinetuneTransform", 32), max_text_len=12, split="test")),
    "imgcls": ("ImgClsArrowDataset", ["imgcls_train"], dict(transform=("FinetuneTransform", 32))),
    "refcoco": ("RefGroundingArrowDataset", ["refcoco_train"],
                dict(transform=("EvalTransform", 32), max_text_len=12)),
}


@pytest.mark.parametrize("case", DATASET_CASES)
def test_arrow_datasets_match_jax(root, toks, case):
    """Every sample of each arrow dataset, field by field, over two epochs
    (coco's first row is corrupt: its samples resample as JAX's do)."""
    cls_name, names, kw = DATASET_CASES[case]
    jset, pset = _both(root, toks, cls_name, names, **kw)
    assert len(pset) == len(jset) > 0
    for epoch in (0, 1):
        jset.epoch = pset.epoch = epoch
        for i in range(len(pset)):
            _same(pset[i], jset[i], f"{case} epoch {epoch} index {i}")
    if case == "pretrain":
        assert pset.get_raw_text(0) == jset.get_raw_text(0)


def test_text_corpus_matches_jax(root, toks):
    """The save_to_disk corpus read with pyarrow: every packed sample of
    each split over two epochs equals JAX's (`load_from_disk`)."""
    hf, mine = toks
    for split in ("train", "val", "test"):
        jset = jds.TextCorpusDataset(str(root / "bookcorpus"), split=split, tokenizer=hf,
                                     max_text_len=24, mlm_collator=JaxMlmCollator(hf))
        pset = pds.TextCorpusDataset(str(root / "bookcorpus"), split=split, tokenizer=mine,
                                     max_text_len=24, mlm_collator=MlmCollator(mine))
        assert len(pset) == len(jset)
        for epoch in (0, 1):
            jset.epoch = pset.epoch = epoch
            for i in range(len(pset)):
                _same(pset[i], jset[i], f"{split} {epoch} {i}")


def test_vqa_vocab_build_matches_jax(root, tmp_path):
    """The building half: the same vocabulary and cache file from the
    answer columns; the cache is read back."""
    tables = [pa.ipc.open_file(pa.memory_map(str(root / f"{n}.arrow"))).read_all()
              for n in ("vqav2_train", "vqav2_rest_val")]
    want = jax_vocab(tables, str(tmp_path / "jax.json"), num_classes=2)
    got = load_or_build_vqa_vocab(tables, str(tmp_path / "port.json"), num_classes=2)
    assert got == want
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert load_or_build_vqa_vocab(cache_path=str(tmp_path / "port.json")) == want


# ------------------------------------------------------------------- loaders


class _Indexed:
    epoch = 0

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"index": np.int64(i), "epoch": np.int64(self.epoch)}


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_sharded_loader_order_and_partition(shuffle, drop_last):
    """The (seed, epoch) order, drop_last or the padded eval order, and the
    process stride at (0, 1) and (1, 2) equal JAX's; `set_epoch` reaches
    the datasets inside a ConcatDataset."""
    for pi, pc in ((0, 1), (1, 2), (0, 2)):
        for epoch in (0, 3):
            data = pds.ConcatDataset([_Indexed(13), _Indexed(6)])
            mine = ShardedLoader(data, 3, shuffle=shuffle, drop_last=drop_last, seed=5,
                                 num_workers=3, process_index=pi, process_count=pc)
            jl = JaxShardedLoader(jds.ConcatDataset([_Indexed(13), _Indexed(6)]), 3,
                                  shuffle=shuffle, drop_last=drop_last, seed=5, num_workers=3,
                                  process_index=pi, process_count=pc)
            jl.set_epoch(epoch)
            want = list(jl)
            got = list(mine.epoch(epoch))
            assert len(got) == len(want) == len(mine)
            for a, b in zip(got, want):
                _same(a, b)
            assert all(int(e) == epoch for b in got for e in b["epoch"])


def test_sharded_loader_shuts_down_and_raises():
    """An early break stops the producer and its pool; a sample that raises
    reaches the consumer."""
    before = threading.active_count()
    loader = ShardedLoader(_Indexed(400), 2, num_workers=4, prefetch=2)
    for i, _ in enumerate(loader):
        if i == 3:
            break
    for _ in range(100):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.02)
    assert threading.active_count() <= before

    class Broken(_Indexed):
        def __getitem__(self, i):
            if i == 5:
                raise KeyError("sample 5")
            return super().__getitem__(i)

    with pytest.raises(KeyError, match="sample 5"):
        list(ShardedLoader(Broken(12), 2, shuffle=False, drop_last=False))


def _cfgs(root, phase, extra=()):
    over = [f"train={phase}", "model=vlmo_debug", "model.img_size=64", "model.max_text_len=12",
            f"data.data_root={root}", "data.batch_size=3", "data.num_workers=2",
            "data.prefetch_depth=2", "data.num_mask_patches=6",
            "data.min_mask_patches_per_block=1", *extra]
    return jax_load_config(over), load_config(over)


MULTITASK = {
    "pretrain_mum": ("pretrain_mum", []),
    "finetune_vqa": ("finetune_vqa", []),
    "nlvr2": ("finetune_nlvr2", []),
    "imgcls": ("finetune_vis", []),
    "refcoco": ("finetune_ref", []),
    "pretrain_txt": ("pretrain_txt", ["model.max_text_len=24", "data.nlp_max_text_len=24"]),
    "retrieval": ("finetune_retrieval", ["train.draw_false_text=2"]),
}


@pytest.mark.parametrize("case", MULTITASK)
def test_multitask_data_matches_jax(root, case):
    """The preset's own `train.datasets` (keys without shards skipped):
    the split sizes and the first train and val batches equal JAX's (JAX's
    loader on one thread: its fast tokenizer raises "Already borrowed"
    under concurrent calls, and its producer then dies without a word)."""
    phase, extra = MULTITASK[case]
    jcfg, cfg = _cfgs(root, phase, extra)
    jdata, data = JaxMultiTaskData(jcfg), MultiTaskData(cfg)
    for split in ("train", "val", "test"):
        assert len(data.datasets[split]) == len(jdata.datasets[split]), split
    assert len(data.datasets["train"]) > 0
    for split in ("train", "val"):
        jl, pl = getattr(jdata, f"{split}_loader")(), getattr(data, f"{split}_loader")()
        jl.num_workers = 1
        assert len(pl) == len(jl)
        if len(pl):
            jl.set_epoch(1)
            _same(next(iter(pl.epoch(1))), next(iter(jl)), split)


def test_the_port_runs_without_pil_and_pyarrow():
    """In a process where PIL and pyarrow cannot be imported, the port and
    `chip_smoke.py` import; phase 25 prints the parts it leaves out and
    runs the tokenizer, the collator and `ShardedLoader` on the synthetic
    samples; an arrow dataset raises ImportError naming pyarrow, a
    transform one naming PIL; nothing falls back."""
    code = textwrap.dedent("""
        import sys
        sys.modules["PIL"] = None
        sys.modules["pyarrow"] = None
        import chip_smoke
        from exploremultimodal_torch.data import datasets, transforms
        out = chip_smoke.data_phase("cpu")
        assert out["loader"] and out["packages"]["pyarrow"].startswith("missing")
        for make, name in ((lambda: datasets.ImageTextArrowDataset("/none", ["x"]), "pyarrow"),
                           (lambda: transforms.EvalTransform(8)(None), "PIL")):
            try:
                make()
            except ImportError as e:
                assert name in str(e), e
            else:
                raise SystemExit(f"no ImportError naming {name}")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "data: left out" in proc.stdout and "data_loader:" in proc.stdout


# ------------------------------------------------------------------- serving

SERVE = ["model=vlmo_debug", "train=finetune_vqa", "model.img_size=32",
         "model.max_text_len=10", "compute_dtype=float32", "attn_impl=recompute"]


def test_predictor_on_pil_images_and_strings_matches_jax():
    """`preprocess_images` equals JAX's (PIL images of several sizes); the
    VQA logits from PIL images and questions within 1e-5 of JAX's and the
    answers equal; `encode_text` within 1e-5."""
    task = jax_build_model(jax_load_config(SERVE))
    dummy = {"image": jnp.zeros((1, 32, 32, 3), jnp.float32),
             "text_ids": jnp.zeros((1, 10), jnp.int32),
             "text_mask": jnp.ones((1, 10), jnp.int32)}
    params = jax.device_get(jax.jit(lambda k: task.init({"params": k}, dummy,
                                                        method=JaxTask.init_inference))(
        jax.random.key(0))["params"])
    jpred = JaxPredictor(jax_load_config(SERVE), params, max_batch=4)
    pred = Predictor(load_config(SERVE), from_flax_params(params), max_batch=4, device="cpu")
    images = [_pil(s, 40 + 16 * s, 30 + 8 * s) for s in range(3)]
    np.testing.assert_array_equal(pred.preprocess_images(images),
                                  jpred.preprocess_images(images))
    questions = ["what color is the bus?", "how many dogs are there", "is it día?"]
    ids, mask = pred.tokenize(questions)
    want = jpred._run("vqa", _vqa_fn, 3, jpred.preprocess_images(images), ids, mask)
    np.testing.assert_allclose(pred.vqa_logits(images, ids, mask), want, atol=1e-5, rtol=0)
    assert pred.vqa(images, questions) == jpred.vqa(images, questions)


# ------------------------------------------------------------- whole slice


def test_trainer_steps_on_arrow_shards(root, monkeypatch):
    """The port's trainer alone (no JAX step) on the arrow shards: two
    pretrain_mum steps at vlmo_debug from coco and vg (whole-word MLM,
    block masks, the dVAE's 32^2 crops, its random encoder narrowed to
    n_hid 16), finite and moving the weights (not pretrain_txt's
    attention, at 0x lr); two finetune_vqa steps from vqav2_train; two
    pretrain_txt steps from the corpus; one step of `main
    train=pretrain_mum` from the shards. Torch runs at two threads, its
    count restored after."""
    # the random dVAE at n_hid 16 (its labels are not compared; its full
    # width costs seconds on the CPU), and two torch threads beside the
    # other test processes
    monkeypatch.setattr(pdvae, "DalleEncoder", functools.partial(DalleEncoder, n_hid=16))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for phase, extra in (("pretrain_mum", ["train.discrete_vae_type=random"]),
                             ("finetune_vqa", []),
                             ("pretrain_txt", ["model.max_text_len=24",
                                               "data.nlp_max_text_len=24"])):
            _, cfg = _cfgs(root, phase, ["compute_dtype=float32", *extra])
            trainer = Trainer(cfg, device="cpu")
            before = {n: p.detach().clone() for n, p in trainer.task.named_parameters()
                      if p.requires_grad}
            metrics = trainer.train_steps(2)
            assert all(np.isfinite(v) for m in metrics for v in m.values()), (phase, metrics)
            moved = [n for n, p in trainer.task.named_parameters()
                     if n in before and not torch.equal(p.detach(), before[n])]
            assert len(moved) >= 10, (phase, moved)
        args = ["train=pretrain_mum", "model=vlmo_debug"] + [
            f"{k}={v}" for k, v in (("model.img_size", 64), ("model.max_text_len", 12),
                                    ("data.data_root", root), ("data.batch_size", 3),
                                    ("data.num_mask_patches", 6),
                                    ("data.min_mask_patches_per_block", 1),
                                    ("compute_dtype", "float32"),
                                    ("train.discrete_vae_type", "random"))]
        assert port_main(args + ["steps=1", "device=cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
