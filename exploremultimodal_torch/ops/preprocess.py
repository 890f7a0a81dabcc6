"""Image preprocessing on the device (counterpart of
`exploremultimodal_tpu/ops/preprocess.py` `normalize_image`)."""

from __future__ import annotations

import torch

# CLIP normalization, as in exploremultimodal_tpu/data/transforms.py
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_image(img_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC -> CLIP-normalized NHWC in `dtype` (math in fp32)."""
    x = img_u8.to(torch.float32) / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)
