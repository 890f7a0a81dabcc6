"""Task heads (counterpart of `exploremultimodal_tpu/models/heads.py`): the
VQA classifier with its ISDA statistics, the pretrain_mum heads, the NLVR2
classifier, the IRTR rank head, the MAE pixel decoder, the MPP decoder, the
image classifier and the referring-box head, with flax's parameter names."""

from __future__ import annotations

import dataclasses

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

    def forward(self, x: torch.Tensor, return_hidden: bool = False):
        """Logits; with `return_hidden`, (logits, the gelu hidden in the
        compute dtype), the features ISDA reads."""
        h = F.gelu(self.ln(self.fc1(x)).to(self.dtype))
        logits = self.fc2(h)
        return (logits, h) if return_hidden else logits


class NLVR2Classifier(nn.Module):
    """The two images' concatenated CLS features: 2hs -> 2hs -> LayerNorm ->
    gelu (erf) -> 2."""

    def __init__(self, dim: int, norm_eps: float, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Linear(2 * dim, 2 * dim, dtype=dtype)
        self.ln = LayerNorm(2 * dim, eps=norm_eps)
        self.fc2 = Linear(2 * dim, 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.ln(self.fc1(x)).to(self.dtype)))


class MAEHead(nn.Module):
    """Masked-autoencoder pixel decoder: hs -> patch_size^2 * 3."""

    def __init__(self, dim: int, patch_size: int, dtype: torch.dtype):
        super().__init__()
        self.fc = Linear(dim, patch_size * patch_size * 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class MPPHead(nn.Module):
    """Masked-patch prediction: dense -> gelu (erf) -> fp32 LayerNorm ->
    3 x 256 discretised RGB logits."""

    def __init__(self, dim: int, norm_eps: float, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.transform_dense = Linear(dim, dim, dtype=dtype)
        self.transform_ln = LayerNorm(dim, eps=norm_eps)
        self.decoder = Linear(dim, 256 * 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.transform_dense(x))
        return self.decoder(self.transform_ln(x).to(self.dtype))


class ImgClsHead(nn.Module):
    """Image classification over the pooled features: hs -> num_classes."""

    def __init__(self, dim: int, num_classes: int, dtype: torch.dtype):
        super().__init__()
        self.fc = Linear(dim, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class RefHead(nn.Module):
    """Referring-expression box: hs -> 2hs -> LayerNorm -> gelu (erf) -> 4,
    then a sigmoid in fp32: a normalised (cx, cy, w, h) box."""

    def __init__(self, dim: int, norm_eps: float, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Linear(dim, 2 * dim, dtype=dtype)
        self.ln = LayerNorm(2 * dim, eps=norm_eps)
        self.fc2 = Linear(2 * dim, 4, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        box = self.fc2(F.gelu(self.ln(self.fc1(x)).to(self.dtype)))
        return torch.sigmoid(box.float())


class RankHead(nn.Module):
    """IRTR rank score: hs -> 1."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc = Linear(dim, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


# --------------------------------------------------------------------- ISDA


@dataclasses.dataclass
class ISDAState:
    """Running per-class feature statistics for ISDA: count (C,), mean
    (C, A) and the diagonal covariance cov (C, A), all fp32."""

    count: torch.Tensor
    mean: torch.Tensor
    cov: torch.Tensor

    @classmethod
    def create(cls, num_classes: int, feature_dim: int,
               device: str | torch.device = "cpu") -> "ISDAState":
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return cls(zeros(num_classes), zeros(num_classes, feature_dim),
                   zeros(num_classes, feature_dim))


def isda_update(state: ISDAState, features: torch.Tensor,
                onehot: torch.Tensor) -> ISDAState:
    """Merge the batch's per-class mean and variance of `features` (N, A)
    into the running estimate; `onehot` (N, C) marks each row's classes.
    The features carry no gradient."""
    features = features.detach().float()
    onehot = onehot.float()
    amount = onehot.sum(0)
    amount_safe = amount.clamp_min(1.0)
    sums = onehot.T @ features
    ave = sums / amount_safe[:, None]
    sq_dev = onehot.T @ (features ** 2) - 2 * ave * sums + ave ** 2 * amount[:, None]
    var = sq_dev / amount_safe[:, None]
    weight = torch.nan_to_num(amount / (amount + state.count).clamp_min(1.0))[:, None]
    cov = (state.cov * (1 - weight) + var * weight
           + weight * (1 - weight) * (state.mean - ave) ** 2)
    mean = state.mean * (1 - weight) + ave * weight
    return ISDAState(count=state.count + amount, mean=mean, cov=cov)


def isda_logits(logits: torch.Tensor, fc_kernel: torch.Tensor,
                labels: torch.Tensor, cov: torch.Tensor,
                ratio: float) -> torch.Tensor:
    """ISDA logit augmentation: y_c += ratio / 2 * sum_a (w_c - w_y)^2
    cov[y, a], with w = `fc_kernel`^T from the last layer's (A, C) kernel
    (the gradient reaches it) and `cov` (C, A) taken as a constant. The sum is expanded
    into products, w^2 . cov_y - 2 w . (w_y cov_y) + sum_a w_y^2 cov_y, so
    the (N, C, A) difference is never formed; in fp32, and the result in
    fp32 as JAX's trainer gets it (its ratio is an fp32 array)."""
    w = fc_kernel.T.float()
    w_y, cov_y = w[labels], cov[labels].detach()
    sigma2 = ((w * w) @ cov_y.T - 2.0 * (w @ (w_y * cov_y).T)).T \
        + (w_y * w_y * cov_y).sum(-1, keepdim=True)
    return logits + 0.5 * ratio * sigma2.to(logits.dtype).float()


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
