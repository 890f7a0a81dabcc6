"""W8A8 (int8) convolution of the dVAE tokenizer's trunk.

Counterpart of `exploremultimodal_tpu/ops/quant_conv.py`:
  - `quant_conv`           `quant_conv`: per-tensor activation codes,
                           per-output-channel weight codes, an exact integer
                           sum, the dequantization; impl 'direct' or 'shifted'
  - `_shifted_int8_conv`   `_shifted_int8_conv`: the k x k conv as k^2
                           channel products over shifted views
  - `_dequant`             `_dequant`
JAX runs this outside any Pallas kernel, as XLA ops. Here the int8 products
are `torch._int_mm` on the card ('direct': one product of an im2col matrix;
'shifted': one per tap), the contraction zero-padded to a multiple of 8,
which adds nothing; on the CPU they are exact float64 sums of the codes
(`F.conv2d` for 'direct'). Every sum is an exact integer either way, so the
two impls give the same bits, as JAX's do. Forward only: the tokenizer is
frozen. Tensors are NCHW, weights nn.Conv2d's (co, ci, kh, kw).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from exploremultimodal_torch.ops.quant import _quantize_int8

IMPLS = ("direct", "shifted")


def _dequant(y: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Exact integer sums y (N, Co, H, W) -> y * (sx * sw[co]) in fp32, then
    `dtype`. The int32 (or float64) sums round to fp32 as JAX's int32 does."""
    return (y.float() * (sx.reshape(()) * sw.reshape(1, -1, 1, 1))).to(dtype)


def _int_sums(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """qa (M, K) . qb (N, K)^T of int8 codes as exact integer sums: int32
    from `torch._int_mm` on the card where its shape rules allow (K padded
    with zero codes to a multiple of 8), else float64."""
    m, k = qa.shape
    if qa.is_cuda and m > 16 and qb.shape[0] % 8 == 0:
        if k % 8:
            qa, qb = F.pad(qa, (0, -k % 8)), F.pad(qb, (0, -k % 8))
        return torch._int_mm(qa, qb.T)
    return qa.double() @ qb.double().T


def _nhwc_padded(qx: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(qx.permute(0, 2, 3, 1), (0, 0, pad, pad, pad, pad))


def _direct_int8_conv(qx: torch.Tensor, qw: torch.Tensor, pad: int) -> torch.Tensor:
    """The conv in one product: an im2col matrix (taps, then channels) on
    the card, `F.conv2d` in float64 on the CPU."""
    if not qx.is_cuda:
        return F.conv2d(qx.double(), qw.double(), padding=pad)
    n, ci, h, w = qx.shape
    co, _, kh, kw = qw.shape
    ho, wo = h + 2 * pad - kh + 1, w + 2 * pad - kw + 1
    xp = _nhwc_padded(qx, pad)
    cols = torch.cat([xp[:, i:i + ho, j:j + wo, :] for i in range(kh) for j in range(kw)],
                     dim=-1).reshape(n * ho * wo, kh * kw * ci)
    y = _int_sums(cols, qw.permute(0, 2, 3, 1).reshape(co, kh * kw * ci))
    return y.reshape(n, ho, wo, co).permute(0, 3, 1, 2)


def _shifted_int8_conv(qx: torch.Tensor, qw: torch.Tensor, pad: int) -> torch.Tensor:
    """k x k int8 conv as k^2 shifted channel products, summed exactly.
    Zero padding of the codes is exact, so this equals the direct conv bit
    for bit."""
    n, ci, h, w = qx.shape
    co, _, kh, kw = qw.shape
    ho, wo = h + 2 * pad - kh + 1, w + 2 * pad - kw + 1
    xp = _nhwc_padded(qx, pad)
    out = None
    for i in range(kh):
        for j in range(kw):
            patch = xp[:, i:i + ho, j:j + wo, :].reshape(n * ho * wo, ci)
            part = _int_sums(patch, qw[:, :, i, j])
            out = part if out is None else out + part
    return out.reshape(n, ho, wo, co).permute(0, 3, 1, 2)


def quant_conv(x: torch.Tensor, weight: torch.Tensor, pad: int,
               impl: str = "direct") -> torch.Tensor:
    """W8A8 forward of a stride-1 conv with symmetric zero padding `pad`
    (`_Conv`'s (k - 1) // 2). x: (N, Ci, H, W) float; weight: (Co, Ci, kh,
    kw) float. Returns (N, Co, H', W') in x's dtype."""
    if impl not in IMPLS:
        raise ValueError(f"unknown quant_conv impl={impl!r} (direct|shifted)")
    qx, sx = _quantize_int8(x)
    qw, sw = _quantize_int8(weight, dim=(1, 2, 3))
    conv = _direct_int8_conv if impl == "direct" else _shifted_int8_conv
    return _dequant(conv(qx, qw, pad), sx, sw, x.dtype)
