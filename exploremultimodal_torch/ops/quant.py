"""The linear layers and their W8A8 (int8) forms, picked by `model.quantize`.

Counterpart of `exploremultimodal_tpu/ops/quant.py`:
  - `quant_dot`     `quant_dot`: per-tensor activation and per-channel weight
                    int8 codes, an int32 product, the STE backward
  - `QuantLinear`   `QuantDense`, with nn.Linear's parameter names
  - `dense`         `dense`: `Linear` or `QuantLinear(impl='xla'|'pallas')`
  - `site_mode`     `site_mode`
  - `partial_dense` a row-parallel share of any of them (`parallel=tp`)
`Linear` is flax `Dense(dtype=...)`; the 'pallas' impl is the row-8 kernel
of `ops/quant_fused.py`. `quant_dot`'s product is a plain int8 GEMM, an XLA
dot outside any Pallas kernel in JAX: `torch._int_mm` on the card, an exact
float64 product of the codes on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from exploremultimodal_torch.ops.quant_fused import (
    divide_by_127,
    int8_product,
    pallas_quant_dot,
    pallas_quant_dot_partial,
)

_EPS = 1e-8


class Linear(nn.Linear):
    """nn.Linear computed in `dtype`: input, weight and bias are cast to it
    at use (flax `Dense(dtype=...)` numerics). The weight is created in
    `param_dtype` (default `dtype`), the bias in fp32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype
        self.weight = nn.Parameter(self.weight.detach().to(param_dtype or dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


def _quantize_int8(t: torch.Tensor, dim: int | tuple[int, ...] | None = None,
                   absmax: torch.Tensor | None = None):
    """Symmetric int8 codes of t with one scale over `dim`, a dim or a tuple
    of dims (None: the whole tensor): scale = max(absmax, 1e-8) / 127, codes
    round(t / scale) clipped to +-127. The scale keeps the reduced dims
    (fp32). A conv weight (co, ci, kh, kw) takes dim (1, 2, 3): one scale per
    output channel, as JAX reduces its HWIO kernel over (kh, kw, ci).
    `absmax`, where given (with the reduced dims kept), replaces t's own: a
    tensor-split share's, the max over the whole tensor."""
    t = t.float()
    if absmax is None:
        absmax = (t.abs().amax(dim, keepdim=True) if dim is not None
                  else t.abs().amax().reshape((1,) * t.ndim))
    scale = divide_by_127(absmax.clamp_min(_EPS))
    return torch.round(t / scale).clamp(-127, 127).to(torch.int8), scale


def _int_dot(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """qa (M, K) . qb (N, K)^T of int8 codes, as fp32: the library int8 GEMM
    on the card where its shape rules allow, else exactly in float64."""
    m, k = qa.shape
    if qa.is_cuda and m > 16 and k % 8 == 0 and qb.shape[0] % 8 == 0:
        return torch._int_mm(qa, qb.T).float()
    return int8_product(qa, qb)


def _int8_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    qx, sx = _quantize_int8(x)  # per tensor
    qw, sw = _quantize_int8(w, dim=1)  # per output channel: (N, 1)
    y = _int_dot(qx.reshape(-1, x.shape[-1]), qw).reshape(*x.shape[:-1], -1)
    return (y * (sx.reshape(()) * sw.reshape(-1))).to(x.dtype)


class _QuantDot(torch.autograd.Function):
    """The int8 forward and `_quant_dot_bwd`: the gradients of the
    unquantized product, dx = g . w in x's dtype and dw = g^T . x in w's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _int8_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = (g @ w.to(g.dtype)).to(x.dtype)
        dw = (g2.T @ x.reshape(-1, x.shape[-1]).to(g.dtype)).to(w.dtype)
        return dx, dw


def quant_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) . w^T for w (N, K): the `w8a8` int8 forward, the STE
    backward."""
    return _QuantDot.apply(x, w)


class _QuantDotPartial(torch.autograd.Function):
    """`_QuantDot` on a row-parallel share (x (..., K/T), w (N, K/T)): the
    absmax of all of x and each channel's of w maxed over the tensor group
    (one all-reduce), the share's codes at those scales, and the fp32
    partial product, unrounded. The backward is the whole one's on the
    share (the gradient taken in x's dtype, as the whole output's)."""

    @staticmethod
    def forward(ctx, x, w, tensor):
        ctx.save_for_backward(x, w)
        amax = tensor.max_(torch.cat([x.float().abs().amax().reshape(1),
                                      w.float().abs().amax(1)]))
        qx, sx = _quantize_int8(x, absmax=amax[:1].reshape((1,) * x.ndim))
        qw, sw = _quantize_int8(w, dim=1, absmax=amax[1:, None])
        y = _int_dot(qx.reshape(-1, x.shape[-1]), qw).reshape(*x.shape[:-1], -1)
        return y * (sx.reshape(()) * sw.reshape(-1))

    @staticmethod
    def backward(ctx, g):
        return (*_QuantDot.backward(ctx, g.to(ctx.saved_tensors[0].dtype)), None)


def partial_dense(layer: "Linear", x: torch.Tensor, tensor) -> torch.Tensor:
    """A row-parallel layer's product on this tensor rank's share (x's
    columns, the weight's), without the bias: `Linear`'s in its dtype, a
    `QuantLinear`'s the fp32 partial sum of its int8 product
    (`quant_dot` or row 8's partial mode), with the whole call's codes."""
    dt = layer.dtype
    if not isinstance(layer, QuantLinear):
        return F.linear(x.to(dt), layer.weight.to(dt))
    if layer.impl == "xla":
        return _QuantDotPartial.apply(x.to(dt), layer.weight.to(dt), tensor)
    return pallas_quant_dot_partial(x.to(dt), layer.weight.to(dt), tensor)


class QuantLinear(Linear):
    """`QuantDense`: `Linear` with its product on int8 codes (W8A8, dynamic
    activation and per-channel weight scales); the bias add and every
    gradient stay in the compute dtype. The weight is cast to the compute
    dtype before it is quantized, as flax's `promote_dtype` casts the
    kernel. impl 'xla': `quant_dot` (one scale for all of x); 'pallas': the
    row-8 kernel (one scale per row of x)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, impl: str = "xla"):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)
        self.impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        dot = quant_dot if self.impl == "xla" else pallas_quant_dot
        y = dot(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


def dense(quantize: str, in_features: int, out_features: int, *,
          bias: bool = True, dtype: torch.dtype = torch.float32) -> Linear:
    """The linear layer for a site's mode (`site_mode`): 'none' -> `Linear`;
    'w8a8' -> `QuantLinear` (impl 'xla'); 'w8a8_pallas' -> `QuantLinear`
    (the row-8 kernel). The parameters are the same in all three."""
    if quantize == "none":
        return Linear(in_features, out_features, bias=bias, dtype=dtype)
    if quantize in ("w8a8", "w8a8_pallas"):
        return QuantLinear(in_features, out_features, bias=bias, dtype=dtype,
                           impl="xla" if quantize == "w8a8" else "pallas")
    raise ValueError(f"unknown model.quantize={quantize!r} "
                     "(none|w8a8|w8a8_pallas|w8a8_pallas_mlp)")


def site_mode(quantize: str, site: str) -> str:
    """A `model.quantize` value resolved for a call site ('qkv'|'proj'|
    'mlp'): 'w8a8_pallas_mlp' quantizes the MLP only (the int8 whole-MLP
    kernel), 'w8a8_pallas_noproj' everything but proj."""
    if quantize == "w8a8_pallas_mlp":
        return "w8a8_pallas" if site == "mlp" else "none"
    if quantize == "w8a8_pallas_noproj":
        return "none" if site == "proj" else "w8a8_pallas"
    return quantize
