"""Multi-head attention compute paths.

Counterpart of `exploremultimodal_tpu/ops/attention.py`. `'pallas'` goes to
the flash-attention kernels (fp32 scores, as the TPU kernels keep them),
with the dropout mask made inside the kernels when attention dropout is
live, keyed by each row's index in the global batch (`StepRng.row_index`). `'auto'` resolves as JAX's does: `'pallas'` while attention dropout
is live, `'recompute'` otherwise. `'recompute'` and `'xla'` run the plain
chain, which rounds the scores to the compute dtype before the fp32
softmax, as the XLA chain does, and draws a Bernoulli dropout mask on the
step's generator. (JAX's `'recompute'` rematerializes the chain in the
backward; here autograd stores it, which changes memory, not values.)
`'saveprobs'` (JAX's chain that keeps only the probabilities for the
backward) and `'jax_flash'` (an upstream TPU library kernel, which JAX
takes only on a TPU and otherwise sends to the stored-probs chain) run the
plain chain as well, as JAX does off the TPU.
"""

from __future__ import annotations

import torch

from exploremultimodal_torch.ops.flash_attention import (
    LONG_SEQ_THRESHOLD,
    flash_attention,
)
from exploremultimodal_torch.ops.stochastic import StepRng

NEG_INF = -1e30
IMPLS = ("auto", "recompute", "xla", "saveprobs", "jax_flash", "pallas")


def key_padding_bias(mask: torch.Tensor | None) -> torch.Tensor | None:
    """(B, N) {0,1} key mask -> (B, 1, 1, N) fp32 additive bias (0 keep,
    -1e30 drop)."""
    if mask is None:
        return None
    return ((1.0 - mask.to(torch.float32)) * NEG_INF)[:, None, None, :]


def multi_head_attention(q, k, v, *, bias=None, scale: float | None = None,
                         dropout_rate: float = 0.0,
                         dropout_rng: StepRng | None = None,
                         impl: str = "recompute", heads_total: int | None = None,
                         head0: int = 0):
    """q, k, v: (B, H, N, D) -> (B, H, N, D). Attention dropout is live
    when `dropout_rate` > 0 and a step's `dropout_rng` is given. Under
    tensor parallelism the H heads are head0 .. head0 + H - 1 of each row's
    `heads_total`, and the dropout masks are those of the whole call's
    heads: the hash keyed by the global head, or the plain chain's draw of
    every head, of which this call keeps its own."""
    if impl not in IMPLS:
        raise ValueError(f"attn_impl {impl!r} not in {IMPLS}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    use_dropout = dropout_rate > 0.0 and dropout_rng is not None
    if impl == "auto":
        impl = "pallas" if use_dropout else "recompute"
    if impl == "pallas" and q.shape[-2] == k.shape[-2] and (
            not use_dropout or q.shape[-2] <= LONG_SEQ_THRESHOLD):
        if use_dropout:
            return flash_attention(q, k, v, bias=bias, scale=scale,
                                   dropout_rate=dropout_rate,
                                   dropout_seed=dropout_rng.attention_seed(),
                                   row_index=dropout_rng.row_index(q.shape[0], q.device),
                                   heads_total=heads_total, head0=head0)
        return flash_attention(q, k, v, bias=bias, scale=scale)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.to(v.dtype).float(), dim=-1)
    if use_dropout:
        b, h, n, m = probs.shape
        draw = (b, h if heads_total is None else heads_total, n, m)
        keep = torch.rand(draw, generator=dropout_rng.generator,
                          device=probs.device)[:, head0:head0 + h] < 1.0 - dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate),
                            torch.zeros_like(probs))
    return torch.matmul(probs.to(v.dtype), v)
