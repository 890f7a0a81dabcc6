"""Fused bf16 MLP forward: the CUDA kernel's wrapper and its plain version.

Counterpart of `exploremultimodal_tpu/ops/mlp_pallas.py` (`fused_bf16_mlp`,
`_mlp_kernel`). The kernel is `csrc/fused_mlp_fwd.cu`. The weights are in
nn.Linear's layout: w1 (hidden, in), w2 (out, hidden); the biases are fp32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from exploremultimodal_torch.ops import _build

# The JAX package sends a shape to its fused kernel only while both bf16
# weight matrices fit this budget (mlp_pallas.py `fits_vmem`), and to the
# erf-gelu XLA path otherwise. The port keeps the same predicate so the two
# packages pick the same function (and gelu form) at every width.
_RESIDENT_BYTES_CAP = 10 * 1024 * 1024
OUT_DIMS = (768,)  # output widths the kernel is instantiated for

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def fits_vmem(in_dim: int, hidden_dim: int, out_dim: int) -> bool:
    return 2 * (in_dim * hidden_dim + hidden_dim * out_dim) <= _RESIDENT_BYTES_CAP


def gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + torch.tanh(
        0.7978845608028654 * (h + 0.044715 * h * h * h)))


def fused_mlp_fwd_plain(x, w1, b1, w2, b2):
    """x: (M, K). fp32 products of the input-dtype operands, fp32 biases,
    the hidden rounded to x's dtype before the second product."""
    h = F.linear(x.float(), w1.to(x.dtype).float()) + b1.float()
    h = gelu_tanh(h).to(x.dtype)
    y = F.linear(h.float(), w2.to(x.dtype).float()) + b2.float()
    return y.to(x.dtype)


def fused_mlp_fwd(x, w1, b1, w2, b2):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_mlp_fwd_plain(x, w1, b1, w2, b2)
    m, k = x.shape
    hdim, ndim = w1.shape[0], w2.shape[0]
    ok = (x.dtype == w1.dtype == w2.dtype == torch.bfloat16
          and b1.dtype == b2.dtype == torch.float32
          and w1.shape == (hdim, k) and w2.shape == (ndim, hdim)
          and b1.shape == (hdim,) and b2.shape == (ndim,)
          and k % 16 == 0 and hdim % 32 == 0 and ndim in OUT_DIMS
          and all(t.is_contiguous() and t.device == x.device
                  and t.data_ptr() % 16 == 0 for t in (x, w1, b1, w2, b2)))
    if not ok:
        raise ValueError(
            "fused_mlp_fwd: needs contiguous, 16-byte aligned bf16 x (M, K), "
            f"w1 (H, K), w2 (N, H) and fp32 b1, b2 on one device, K % 16 == 0, "
            f"H % 32 == 0, N in {OUT_DIMS}; got x {tuple(x.shape)} {x.dtype}, "
            f"w1 {tuple(w1.shape)} {w1.dtype}, w2 {tuple(w2.shape)} {w2.dtype}, "
            f"b1 {b1.dtype}, b2 {b2.dtype}")
    y = torch.empty((m, ndim), dtype=x.dtype, device=x.device)
    fn = _build.load("fused_mlp_fwd", _ARGTYPES)
    rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), y.data_ptr(), m, k, hdim, ndim,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("fused_mlp_fwd", rc)
    fused_mlp_fwd.launches += 1
    return y


fused_mlp_fwd.launches = 0


def fused_mlp(x, w1, b1, w2, b2):
    """gelu_tanh(x . w1^T + b1) . w2^T + b2 over the last axis of x."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise NotImplementedError(
            "fused_mlp has no backward yet: call it under "
            "torch.inference_mode() or torch.no_grad()")
    *lead, k = x.shape
    y = fused_mlp_fwd(x.reshape(-1, k).contiguous(), w1.to(x.dtype).contiguous(),
                      b1.float().contiguous(), w2.to(x.dtype).contiguous(),
                      b2.float().contiguous())
    return y.reshape(*lead, w2.shape[0])
