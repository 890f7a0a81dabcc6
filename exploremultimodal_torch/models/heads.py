"""Task heads (counterpart of `exploremultimodal_tpu/models/heads.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from exploremultimodal_torch.models.vlmo import LayerNorm, Linear


class VQAClassifier(nn.Module):
    """hs -> 2hs -> LayerNorm -> gelu (erf) -> num_classes."""

    def __init__(self, dim: int, num_classes: int, norm_eps: float,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Linear(dim, 2 * dim, dtype=dtype)
        self.ln = LayerNorm(2 * dim, eps=norm_eps)
        self.fc2 = Linear(2 * dim, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln(self.fc1(x))
        return self.fc2(F.gelu(h.to(self.dtype)))
