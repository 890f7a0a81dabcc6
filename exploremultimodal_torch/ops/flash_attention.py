"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of `exploremultimodal_tpu/ops/flash_attention.py` `_fwd_call` /
`_attn_kernel` (the full-row forward used by `attn_impl='pallas'`). The
kernel is `csrc/flash_attention_fwd.cu`. Serving needs no gradient, so there
is no autograd.Function yet: the wrapper refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes

import torch

from exploremultimodal_torch.ops import _build

HEAD_DIM = 64  # the only head dim the kernel takes (every preset's but vlmo_debug)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def flash_attention_fwd_plain(qf, kf, vf, key_bias, scale: float):
    """qf/kf/vf: (B*H, N, D); key_bias: (B, N) fp32. Returns (out in the
    input dtype, lse (B*H, N) fp32), computed as `_attn_kernel` does: fp32
    scores, bias added after scaling, max-subtracted exp, fp32 p.v / denom."""
    bh, n, _ = qf.shape
    heads = bh // key_bias.shape[0]
    s = torch.matmul(qf.float(), kf.float().transpose(1, 2)) * scale
    s = s + key_bias.float().repeat_interleave(heads, dim=0)[:, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vf.float()) / denom
    return out.to(qf.dtype), (m + torch.log(denom)).squeeze(-1)


def flash_attention_fwd(qf, kf, vf, key_bias, scale: float):
    """The kernel on CUDA tensors, the plain version on CPU tensors. Same
    arguments and results as `flash_attention_fwd_plain`."""
    if qf.device.type == "cpu":
        return flash_attention_fwd_plain(qf, kf, vf, key_bias, scale)
    bh, n, d = qf.shape
    b = key_bias.shape[0]
    for name, t in (("q", qf), ("k", kf), ("v", vf)):
        if t.dtype != torch.bfloat16 or t.shape != (bh, n, HEAD_DIM) \
                or not t.is_contiguous() or t.device != qf.device \
                or t.data_ptr() % 16 != 0:
            raise ValueError(
                f"flash_attention_fwd: {name} must be a contiguous, 16-byte aligned bf16 "
                f"({bh}, {n}, {HEAD_DIM}) tensor on {qf.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if key_bias.dtype != torch.float32 or key_bias.shape != (b, n) \
            or not key_bias.is_contiguous() or bh % b != 0 \
            or key_bias.device != qf.device:
        raise ValueError("flash_attention_fwd: key_bias must be a contiguous "
                         f"fp32 (B, {n}) tensor with B dividing {bh}")
    out = torch.empty_like(qf)
    lse = torch.empty((bh, n), dtype=torch.float32, device=qf.device)
    fn = _build.load("flash_attention_fwd", _ARGTYPES)
    rc = fn(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), key_bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), bh, bh // b, n, scale,
            torch.cuda.current_stream(qf.device).cuda_stream)
    _build.check("flash_attention_fwd", rc)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, *, bias=None, scale: float):
    """q, k, v: (B, H, N, D); bias: (B, 1, 1, N) additive key-padding bias or
    None. Returns (B, H, N, D), as the JAX `flash_attention` forward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet: call it under "
            "torch.inference_mode() or torch.no_grad()")
    b, h, n, d = q.shape
    if bias is None:
        key_bias = torch.zeros((b, n), dtype=torch.float32, device=q.device)
    else:
        key_bias = bias.to(torch.float32).reshape(b, n).contiguous()
    out, _ = flash_attention_fwd(
        q.reshape(b * h, n, d).contiguous(), k.reshape(b * h, n, d).contiguous(),
        v.reshape(b * h, n, d).contiguous(), key_bias, scale)
    return out.reshape(b, h, n, d)
