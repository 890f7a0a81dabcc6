"""Host-side image augmentation and the two-resolution crop (counterpart of
`exploremultimodal_tpu/data/transforms.py`, the same PIL calls in the same
order, so the same image and `random.Random` give JAX's arrays bit for
bit).

RandomAugment picks 2 of 10 ops at magnitude 7, each applied with
probability 0.5; one random-resized crop is resized to img_size (bicubic,
the backbone's stream) and to img_size // 2 (Lanczos, the dVAE's). The
host emits uint8 crops; normalization runs on the device
(`ops/preprocess.py`). `NativePretrainTransform` decodes, crops and
resizes in the C++ loader (`data/native.py`) and augments the small crop.
PIL is imported where an image is transformed, so the package imports
without it (and raises ImportError naming it at the first image).
"""

from __future__ import annotations

import io
import math
import random
from typing import Sequence

import numpy as np

DEFAULT_AUGS = (
    "Identity", "AutoContrast", "Equalize", "Brightness", "Sharpness",
    "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
)


def _affine(img: Image.Image, matrix) -> Image.Image:
    from PIL import Image

    return img.transform(img.size, Image.AFFINE, matrix, resample=Image.BILINEAR)


def _apply_op(img: Image.Image, op: str, level: float, rng: random.Random):
    """level ∈ [0, 10]; magnitudes follow the common AutoAugment ranges."""
    from PIL import Image, ImageEnhance, ImageOps

    sign = 1 if rng.random() < 0.5 else -1
    if op == "Identity":
        return img
    if op == "AutoContrast":
        return ImageOps.autocontrast(img)
    if op == "Equalize":
        return ImageOps.equalize(img)
    if op == "Brightness":
        return ImageEnhance.Brightness(img).enhance(1.0 + sign * 0.09 * level)
    if op == "Sharpness":
        return ImageEnhance.Sharpness(img).enhance(1.0 + sign * 0.09 * level)
    if op == "ShearX":
        v = sign * 0.03 * level
        return _affine(img, (1, v, 0, 0, 1, 0))
    if op == "ShearY":
        v = sign * 0.03 * level
        return _affine(img, (1, 0, 0, v, 1, 0))
    if op == "TranslateX":
        v = sign * 0.045 * level * img.size[0]
        return _affine(img, (1, 0, v, 0, 1, 0))
    if op == "TranslateY":
        v = sign * 0.045 * level * img.size[1]
        return _affine(img, (1, 0, 0, 0, 1, v))
    if op == "Rotate":
        return img.rotate(sign * 3.0 * level, resample=Image.BILINEAR)
    raise ValueError(f"unknown aug op {op!r}")


class RandomAugment:
    """Pick N ops (each applied with prob 0.5) at magnitude M
    (randaugment.py RandomAugment(2, 7) semantics)."""

    def __init__(self, n: int = 2, m: int = 7, augs: Sequence[str] = DEFAULT_AUGS):
        self.n = n
        self.m = m
        self.augs = list(augs)

    def __call__(self, img: Image.Image, rng: random.Random | None = None):
        rng = rng or random
        for op in rng.choices(self.augs, k=self.n):
            if rng.random() < 0.5:
                img = _apply_op(img, op, self.m, rng)
        return img


def random_resized_crop_params(
    width: int,
    height: int,
    rng: random.Random,
    scale=(0.9, 1.0),
    ratio=(3 / 4, 4 / 3),
) -> tuple[int, int, int, int]:
    """(left, top, w, h) of a random area/aspect crop with central fallback
    (transforms.py:68-113)."""
    area = width * height
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = rng.randint(0, height - h)
            left = rng.randint(0, width - w)
            return left, top, w, h
    in_ratio = width / height
    if in_ratio < min(ratio):
        w = width
        h = int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        h = height
        w = int(round(h * max(ratio)))
    else:
        w, h = width, height
    return (width - w) // 2, (height - h) // 2, w, h


class TwoPicCrop:
    """One random crop → (img_size bicubic, second_size lanczos) uint8 pair."""

    def __init__(self, img_size: int, second_size: int | None, scale=(0.9, 1.0)):
        self.img_size = img_size
        self.second_size = second_size
        self.scale = scale

    def __call__(self, img: Image.Image, rng: random.Random | None = None):
        rng = rng or random
        left, top, w, h = random_resized_crop_params(
            img.size[0], img.size[1], rng, scale=self.scale
        )
        box = (left, top, left + w, top + h)
        from PIL import Image

        main = img.resize((self.img_size, self.img_size), Image.BICUBIC, box=box)
        if self.second_size is None:
            return np.asarray(main, np.uint8)
        second = img.resize(
            (self.second_size, self.second_size), Image.LANCZOS, box=box
        )
        return np.asarray(main, np.uint8), np.asarray(second, np.uint8)


class PretrainTransform:
    """RandomAugment → two-pic crop (datamodule_base.py pretrain_transform)."""

    def __init__(self, img_size: int, second_size: int | None = None,
                 n: int = 2, m: int = 7):
        self.aug = RandomAugment(n, m)
        self.crop = TwoPicCrop(img_size, second_size)

    def __call__(self, img: Image.Image, rng: random.Random | None = None):
        img = img.convert("RGB")
        return self.crop(self.aug(img, rng), rng)


class FinetuneTransform:
    """RandomAugment → single random-resized crop (train_transform)."""

    def __init__(self, img_size: int, n: int = 2, m: int = 7):
        self.aug = RandomAugment(n, m)
        self.crop = TwoPicCrop(img_size, None)

    def __call__(self, img: Image.Image, rng: random.Random | None = None):
        return self.crop(self.aug(img.convert("RGB"), rng), rng)


class NativePretrainTransform:
    """Fast-path pretrain transform over raw JPEG bytes: native C++ decode +
    random-resized crop + resize to img_size, photometric RandomAugment on
    the small crop (cheaper than on the full image), then img_size →
    second_size for the dVAE stream so both streams see identical content.

    Performance alternative to PretrainTransform (which is the
    reference-parity path: augment before crop, bicubic/lanczos resampling).
    """

    def __init__(self, img_size: int, second_size: int | None = None,
                 n: int = 2, m: int = 7, scale=(0.9, 1.0)):
        from exploremultimodal_torch.data import native

        native.require()
        self.native = native
        self.img_size = img_size
        self.second_size = second_size
        self.aug = RandomAugment(n, m)
        self.scale = scale

    def from_bytes(self, jpeg_bytes: bytes, rng: random.Random | None = None):
        from PIL import Image

        rng = rng or random
        # decode header cheaply for crop params? decode once, full image crop
        # params need (w, h): read from the JPEG SOF via PIL lazy open
        with Image.open(io.BytesIO(jpeg_bytes)) as im:
            w, h = im.size
        left, top, cw, ch = random_resized_crop_params(w, h, rng, scale=self.scale)
        boxes = np.array([[left, top, cw, ch]], np.int32)
        out1, _, status = self.native.decode_resize_batch(
            [jpeg_bytes], size1=self.img_size, crop_boxes=boxes, num_threads=1
        )
        if status[0] != 0:
            raise ValueError("jpeg decode failed")
        main = np.asarray(
            self.aug(Image.fromarray(out1[0]), rng), np.uint8
        )
        if self.second_size is None:
            return main
        second = np.asarray(
            Image.fromarray(main).resize(
                (self.second_size, self.second_size), Image.LANCZOS
            ),
            np.uint8,
        )
        return main, second


class EvalTransform:
    """Plain resize (val_transform / pretrain_val_transform)."""

    def __init__(self, img_size: int, second_size: int | None = None):
        self.img_size = img_size
        self.second_size = second_size

    def __call__(self, img: Image.Image, rng=None):
        from PIL import Image

        img = img.convert("RGB")
        main = np.asarray(
            img.resize((self.img_size, self.img_size), Image.BICUBIC), np.uint8
        )
        if self.second_size is None:
            return main
        second = np.asarray(
            img.resize((self.second_size, self.second_size), Image.LANCZOS),
            np.uint8,
        )
        return main, second
