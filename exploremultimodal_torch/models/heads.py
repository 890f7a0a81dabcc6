"""Task heads (counterpart of `exploremultimodal_tpu/models/heads.py`): the
VQA classifier and the pretrain_mum heads, with flax's parameter names."""

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


class MLMTransform(nn.Module):
    """BertPredictionHeadTransform (dense -> erf gelu -> LayerNorm) and the
    output bias; the tied decoder product is `VLMO.attend_vocab`."""

    def __init__(self, dim: int, vocab_size: int, norm_eps: float,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.transform_dense = Linear(dim, dim, dtype=dtype)
        self.transform_ln = LayerNorm(dim, eps=norm_eps)
        self.bias = nn.Parameter(torch.zeros(vocab_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.transform_dense(x))
        return self.transform_ln(x).to(self.dtype)


class MIMHead(nn.Module):
    """Linear hs -> img_vocab_size (the dVAE codes)."""

    def __init__(self, dim: int, vocab_size: int, dtype: torch.dtype):
        super().__init__()
        self.fc = Linear(dim, vocab_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class ITCHead(nn.Module):
    """Per-route ('v'/'l') projection to the contrastive space + L2 norm
    (the norm in fp32, the result in the compute dtype)."""

    def __init__(self, dim: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dense_v = Linear(dim, out_dim, dtype=dtype)
        self.dense_l = Linear(dim, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor, route: str) -> torch.Tensor:
        if route not in ("v", "l"):
            raise ValueError(f"ITC route {route!r}")
        x = getattr(self, f"dense_{route}")(x)
        norm = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
        return x / norm.clamp_min(1e-12).to(x.dtype)


class ITMHead(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc = Linear(dim, 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)
