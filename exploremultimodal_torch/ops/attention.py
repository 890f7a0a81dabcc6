"""Multi-head attention for deterministic (serving) calls.

Counterpart of `exploremultimodal_tpu/ops/attention.py`. `'pallas'` goes to
the flash-attention kernel (fp32 scores, as the TPU kernel keeps them);
`'auto'`, `'recompute'` and `'xla'` go to the plain chain, which rounds the
scores to the compute dtype before the fp32 softmax, as the XLA chain does.
Attention dropout is training, which this package does not do yet.
"""

from __future__ import annotations

import torch

from exploremultimodal_torch.ops.flash_attention import flash_attention

NEG_INF = -1e30
IMPLS = ("auto", "recompute", "xla", "pallas")


def key_padding_bias(mask: torch.Tensor | None) -> torch.Tensor | None:
    """(B, N) {0,1} key mask -> (B, 1, 1, N) fp32 additive bias (0 keep,
    -1e30 drop)."""
    if mask is None:
        return None
    return ((1.0 - mask.to(torch.float32)) * NEG_INF)[:, None, None, :]


def multi_head_attention(q, k, v, *, bias=None, scale: float | None = None,
                         dropout_rate: float = 0.0, deterministic: bool = True,
                         impl: str = "recompute"):
    """q, k, v: (B, H, N, D) -> (B, H, N, D)."""
    if impl not in IMPLS:
        raise ValueError(f"attn_impl {impl!r} not in {IMPLS}")
    if not deterministic and dropout_rate > 0.0:
        raise NotImplementedError("attention dropout (training) is not ported")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "pallas":
        return flash_attention(q, k, v, bias=bias, scale=scale)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.to(v.dtype).float(), dim=-1).to(v.dtype)
    return torch.matmul(probs, v)
