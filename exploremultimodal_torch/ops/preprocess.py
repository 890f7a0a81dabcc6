"""Image preprocessing on the device (counterpart of
`exploremultimodal_tpu/ops/preprocess.py`): uint8 crops cross to the device
and are normalized there."""

from __future__ import annotations

import torch

from exploremultimodal_torch.models.dvae import map_pixels

# CLIP normalization, as in exploremultimodal_tpu/data/transforms.py
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_image(img_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC -> CLIP-normalized NHWC in `dtype` (math in fp32)."""
    x = img_u8.to(torch.float32) / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def dalle_image(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> logit-Laplace-mapped fp32 (the dVAE tokenizer's input)."""
    return map_pixels(img_u8.to(torch.float32) / 255.0)


def preprocess_batch(batch: dict, dtype=torch.float32) -> dict:
    """Expand the uint8 `*_u8` image fields into the model-ready fields."""
    out = dict(batch)
    for key in ("image", "image_0", "image_1", "image_aug"):
        u8 = out.pop(f"{key}_u8", None)
        if u8 is not None:
            out[key] = normalize_image(u8, dtype)
    u8 = out.pop("image4dalle_u8", None)
    if u8 is not None:
        out["image4dalle"] = dalle_image(u8)
    return out
