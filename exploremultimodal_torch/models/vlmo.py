"""VLMo mixture-of-modality-experts backbone.

Counterpart of `exploremultimodal_tpu/models/vlmo.py`, module for module and
with the same parameter names, so `convert.from_flax_params` is a rename and
a transpose. Numerics follow the JAX modules:
  - Linear/Conv weights and biases are cast to the compute dtype at use, as
    flax `Dense(dtype=...)` casts them. Serving stores the weights in the
    compute dtype (the cast is then free); training keeps fp32 master
    weights, as the JAX trainer does;
  - LayerNorm runs in fp32 with flax's statistics (var = E[x^2] - E[x]^2),
    and its output is cast back to the compute dtype by the caller;
  - q/v biases are added after the head split; k has none;
  - `model.quantize` picks each site's linear layer (`ops/quant.py`
    `site_mode`, `dense`): bf16, or int8 products;
  - the FFN expert is the int8 whole-MLP kernel under an int8 MLP mode,
    else the bf16 fused kernel (tanh gelu, the hidden dropout inside
    either) under `mlp_impl='fused'` where `fits_vmem` admits the shape,
    else two linear layers with erf gelu.
Dropout and DropPath draw on the step's `StepRng`; without one (`rng=None`)
the forward is deterministic, as JAX's `deterministic=True`. Images are
NHWC, as in the JAX package.

`remat` (`parallel.remat`, JAX's `nn.remat` over each block) checkpoints
every block under autograd: `True` keeps only its inputs and runs it again
in the backward; 'dots' keeps the outputs of its matrix products (JAX's
`dots_with_no_batch_dims_saveable`: the 2-D GEMMs, not attention's batched
products) and runs the elementwise chains and the kernels again. The
block's random streams are rewound for the recomputation
(`StepRng.replay`), so it draws the first forward's masks.

Tensor parallelism (`parallel.partitioning.shard_tensor_parallel` sets
`tensor`, a `TensorAxis`, on each `Attention` and `Mlp`): a rank holds H/T
heads of q, k and v and the matching input columns of proj, and hidden/T
rows of fc1 with their columns of fc2 (Megatron's split). The block's
input enters each through `copy_to_tensor_region`; proj and fc2 give
partial sums without their biases, which `reduce_from_tensor_region` adds
over the ranks in fp32 before the bias and one rounding; the int8 sites
take the whole call's codes, their scales maxed over the ranks where K or
the hidden is split (`ops/quant.py` `partial_dense`, `w8a8_mlp`'s split
mode). The dropout masks
are the one-process step's: attention's hash keyed by the global head
(`heads_total`, `head0`), the hidden dropout this rank's columns of the
whole draw, every draw after a reduce (proj and post-fc2 dropout, DropPath)
made whole on each rank from generators the ranks share.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from exploremultimodal_torch.ops.attention import key_padding_bias, multi_head_attention
from exploremultimodal_torch.ops.mlp_fused import fits_vmem, fused_mlp
from exploremultimodal_torch.ops.quant import Linear, dense, partial_dense, site_mode
from exploremultimodal_torch.ops.quant_fused import w8a8_mlp
from exploremultimodal_torch.ops.stochastic import (
    StepRng,
    bits16,
    drop_path,
    dropout_threshold16,
    fast_dropout,
)
from exploremultimodal_torch.parallel.collectives import TensorAxis


def _share(tensor: TensorAxis | None) -> tuple[int, int] | None:
    return None if tensor is None else (tensor.rank, tensor.size)


def _partial_linear(layer: Linear, x: torch.Tensor, tensor: TensorAxis) -> torch.Tensor:
    """A row-parallel layer: this rank's product without the bias, summed
    over the tensor group, then the bias (`Linear`'s dtype). An int8 layer's
    partial sums are fp32, added before the bias and one rounding."""
    dt = layer.dtype
    part = partial_dense(layer, x, tensor)
    if part.dtype == dt:
        return tensor.reduce(part) + layer.bias.to(dt)
    return (tensor.reduce(part) + layer.bias.float()).to(dt)

ROUTES = ("v", "l", "vl")


class LayerNorm(nn.LayerNorm):
    """fp32 LayerNorm computed as flax's (fast variance E[x^2] - E[x]^2)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class Mlp(nn.Module):
    """FFN expert: fc1 -> gelu -> drop -> fc2 -> drop.

    The site's mode (`site_mode(quantize, 'mlp')`) picks the route, in
    JAX's order: 'w8a8_pallas' -> the int8 whole-MLP kernel (tanh gelu, the
    hidden dropout inside it), whose fc1/fc2 weights stay fp32 in every
    compute dtype because JAX's int8 MLP quantizes its fp32 parameters;
    'none' with `mlp_impl='fused'` where `fits_vmem` admits the shape -> the
    bf16 fused kernel; else two `dense` layers with erf gelu. The route is
    chosen at the whole hidden, so a tensor rank's share of it takes the
    same one; the fused kernel then runs in its partial mode (fp32, no b2),
    the int8 one in its split mode (rows 9/10: the hidden's row scales and
    W2's channel scales maxed over the tensor group), and the unfused fc2
    without its bias, before the reduce."""

    def __init__(self, dim: int, hidden_dim: int, dtype: torch.dtype,
                 mlp_impl: str = "xla", drop_rate: float = 0.0,
                 quantize: str = "none"):
        super().__init__()
        self.drop_rate = drop_rate
        mode = site_mode(quantize, "mlp")
        self.int8 = mode == "w8a8_pallas"
        self.fused = (mode == "none" and mlp_impl == "fused"
                      and fits_vmem(dim, hidden_dim, dim))
        if self.int8:
            self.fc1 = Linear(dim, hidden_dim, dtype=dtype, param_dtype=torch.float32)
            self.fc2 = Linear(hidden_dim, dim, dtype=dtype, param_dtype=torch.float32)
        else:
            self.fc1 = dense(mode, dim, hidden_dim, dtype=dtype)
            self.fc2 = dense(mode, hidden_dim, dim, dtype=dtype)
        self.tensor: TensorAxis | None = None

    def forward(self, x: torch.Tensor, rng: StepRng | None = None) -> torch.Tensor:
        tp = self.tensor
        if tp is not None:
            x = tp.copy(x)
        if self.int8 or self.fused:
            # the hidden dropout inside the kernel, from uint16 bits drawn
            # here (JAX's `fused_*_mlp_dropout`), then the post-fc2 one
            t = dropout_threshold16(self.drop_rate) if rng is not None else 0
            # this rank's hidden columns (the weight's rows; `out_features`
            # stays the whole hidden)
            shape = x.shape[:-1] + (self.fc1.weight.shape[0],)
            bits = (None if t == 0 else bits16(rng, shape, x.device) if tp is None
                    else bits16(rng, shape, x.device, share=_share(tp)))
            mlp = w8a8_mlp if self.int8 else fused_mlp
            if tp is None:
                y = mlp(x.to(self.fc1.dtype), self.fc1.weight, self.fc1.bias,
                        self.fc2.weight, self.fc2.bias, bits, t)
            else:
                # the partial mode: the int8 MLP's codes and scales need the
                # tensor group (maxima over the whole hidden)
                split = {"tensor": tp} if self.int8 else {}
                part = mlp(x.to(self.fc1.dtype), self.fc1.weight, self.fc1.bias,
                           self.fc2.weight, None, bits, t, **split)
                y = (tp.reduce(part) + self.fc2.bias.float()).to(x.dtype)
            return fast_dropout(y, self.drop_rate, rng)
        h = fast_dropout(F.gelu(self.fc1(x)), self.drop_rate, rng, _share(tp))
        y = self.fc2(h) if tp is None else _partial_linear(self.fc2, h, tp)
        return fast_dropout(y, self.drop_rate, rng)


class Attention(nn.Module):
    """Shared MHSA with separate q/v biases and no k bias."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 impl: str = "xla", attn_drop: float = 0.0,
                 proj_drop: float = 0.0, quantize: str = "none"):
        super().__init__()
        self.num_heads = num_heads
        self.impl = impl
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.qkv = dense(site_mode(quantize, "qkv"), dim, 3 * dim, bias=False,
                         dtype=dtype)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = dense(site_mode(quantize, "proj"), dim, dim, dtype=dtype)
        # under tensor parallelism: heads head0 .. head0 + H/T - 1 of H
        self.tensor: TensorAxis | None = None

    def forward(self, x: torch.Tensor, bias: torch.Tensor | None,
                rng: StepRng | None = None) -> torch.Tensor:
        b, n, c = x.shape
        tp = self.tensor
        hd = c // self.num_heads
        h = self.num_heads if tp is None else self.num_heads // tp.size
        if tp is not None:
            x = tp.copy(x)
        qkv = self.qkv(x).reshape(b, n, 3, h, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        q = q + self.q_bias.reshape(h, 1, hd).to(q.dtype)
        v = v + self.v_bias.reshape(h, 1, hd).to(v.dtype)
        heads = {} if tp is None else {"heads_total": self.num_heads, "head0": tp.rank * h}
        out = multi_head_attention(q, k, v, bias=bias, scale=hd ** -0.5,
                                   dropout_rate=self.attn_drop,
                                   dropout_rng=rng, impl=self.impl, **heads)
        out = out.transpose(1, 2).reshape(b, n, h * hd)
        out = self.proj(out) if tp is None else _partial_linear(self.proj, out, tp)
        return fast_dropout(out, self.proj_drop, rng)


# the products 'dots' keeps: the 2-D GEMMs of the linear layers (bf16,
# fp32 and int8); attention's batched products and every kernel run again
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten._int_mm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


class Block(nn.Module):
    """Pre-LN block: x += DropPath(g1 * Attn(LN1 x));
    x += DropPath(g2 * MLP[route](LN2 x)). `remat` (False, True or 'dots')
    checkpoints it under autograd."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 norm_eps: float, init_values: float | None,
                 experts: Sequence[str], dtype: torch.dtype, attn_impl: str,
                 mlp_impl: str, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path_rate: float = 0.0, quantize: str = "none",
                 remat: bool | str = False):
        super().__init__()
        self.remat = remat
        self.dtype = dtype
        self.experts = tuple(experts)
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim, eps=norm_eps)
        self.attn = Attention(dim, num_heads, dtype, attn_impl, attn_drop, drop,
                              quantize)
        self.norm2 = LayerNorm(dim, eps=norm_eps)
        for route in self.experts:
            setattr(self, f"mlp_{route}",
                    Mlp(dim, int(dim * mlp_ratio), dtype, mlp_impl, drop, quantize))
        if init_values is not None and init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values)))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values)))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x: torch.Tensor, bias: torch.Tensor | None, route: str,
                rng: StepRng | None = None) -> torch.Tensor:
        if route not in self.experts:
            raise ValueError(f"route {route!r} not among experts {self.experts}")
        if not self.remat or not torch.is_grad_enabled():
            return self._forward(x, bias, route, rng)
        replay = None if rng is None else rng.replay()

        def run(x, bias):
            if replay is None:
                return self._forward(x, bias, route, rng)
            with replay:
                return self._forward(x, bias, route, rng)

        return checkpoint(run, x, bias, use_reentrant=False, preserve_rng_state=False,
                          **({"context_fn": _DOTS_CONTEXT} if self.remat == "dots" else {}))

    def _forward(self, x: torch.Tensor, bias: torch.Tensor | None, route: str,
                 rng: StepRng | None) -> torch.Tensor:
        def residual(branch, gamma):
            if gamma is not None:
                branch = branch * gamma.to(branch.dtype)
            return drop_path(branch, self.drop_path_rate, rng)

        x = x + residual(self.attn(self.norm1(x).to(self.dtype), bias, rng),
                         self.gamma_1)
        mlp = getattr(self, f"mlp_{route}")
        return x + residual(mlp(self.norm2(x).to(self.dtype), rng), self.gamma_2)


class BertTextEmbeddings(nn.Module):
    """word + position + BERT token type 0 -> LayerNorm -> drop (fp32
    tables)."""

    def __init__(self, vocab_size: int, dim: int, max_len: int,
                 norm_eps: float, dtype: torch.dtype, drop_rate: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.word_embeddings = nn.Embedding(vocab_size, dim)
        self.position_embeddings = nn.Embedding(max_len, dim)
        self.token_type_embeddings = nn.Embedding(2, dim)
        self.LayerNorm = LayerNorm(dim, eps=norm_eps)

    def forward(self, ids: torch.Tensor, rng: StepRng | None = None) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = (self.word_embeddings(ids) + self.position_embeddings(pos)[None]
             + self.token_type_embeddings.weight[0])
        x = fast_dropout(self.LayerNorm(x), self.drop_rate, rng)
        return x.to(self.dtype)


class Pooler(nn.Module):
    """BertPooler: dense + tanh over token 0."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dense = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(x[:, 0]))


def expert_layout(depth: int, fusion_layer: int,
                  phase: str | None) -> tuple[tuple[str, ...], ...]:
    """Which FFN experts exist in each block for a train phase: those of
    JAX's parameter tree. pretrain_txt has no fused expert; every other
    phase has it above the fusion layer only. (JAX's `expert_layout` lists
    all three routes in every block for the phases beyond pretrain_txt,
    pretrain_mum and finetune_vqa, but flax makes a parameter only where the
    forwards of `VLMO.init_streams` reach it, and route 'vl' runs only
    above the fusion layer.)"""
    if phase in ("pretrain_txt",):
        return tuple(("v", "l") for _ in range(depth))
    return tuple(("v", "l") if i < fusion_layer else ROUTES for i in range(depth))


class VLMO(nn.Module):
    """The shared-attention, modality-routed-FFN transformer."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 norm_eps: float = 1e-12, init_values: float | None = None,
                 vocab_size: int = 30522, max_text_len: int = 40,
                 fusion_layer: int = 6, num_token_types: int = 2,
                 experts_per_block=None, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "xla", mlp_impl: str = "xla",
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, quantize: str = "none",
                 remat: bool | str = False):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.fusion_layer = fusion_layer
        self.num_patches = (img_size // patch_size) ** 2
        self.patch_embed = nn.Conv2d(in_chans, embed_dim, patch_size,
                                     stride=patch_size)
        self.patch_embed.weight = nn.Parameter(
            self.patch_embed.weight.detach().to(dtype))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.num_patches + 1, embed_dim))
        self.img_cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.img_mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        # 3 rows for NLVR2: its second image takes token type 2
        self.token_type_embeddings = nn.Embedding(num_token_types, embed_dim)
        self.txt_embeddings = BertTextEmbeddings(vocab_size, embed_dim,
                                                 max_text_len, norm_eps, dtype,
                                                 drop_rate)
        layout = experts_per_block or tuple(ROUTES for _ in range(depth))
        dpr = [float(x) for x in np.linspace(0.0, drop_path_rate, depth)]
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, norm_eps, init_values,
                  layout[i], dtype, attn_impl, mlp_impl, drop_rate,
                  attn_drop_rate, dpr[i], quantize, remat)
            for i in range(depth))
        self.norm = LayerNorm(embed_dim, eps=norm_eps)
        self.pooler = Pooler(embed_dim, dtype)

    # ------------------------------------------------------------------ embed

    def embed_img(self, img: torch.Tensor, bool_masked_pos=None,
                  rng: StepRng | None = None,
                  img_token_type_idx: int = 1) -> torch.Tensor:
        """img: (B, H, W, C) NHWC -> (B, 1 + num_patches, D), token type
        `img_token_type_idx` (1; NLVR2's second image 2). Patches where
        `bool_masked_pos` (B, num_patches) is set become `img_mask_token`
        (the masked-image objectives)."""
        dt, pe = self.dtype, self.patch_embed
        x = F.conv2d(img.to(dt).permute(0, 3, 1, 2), pe.weight.to(dt),
                     pe.bias.to(dt), stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)
        if bool_masked_pos is not None:
            w = bool_masked_pos[..., None].to(x.dtype)
            x = x * (1.0 - w) + self.img_mask_token.to(x.dtype) * w
        cls = self.img_cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        x = fast_dropout(x, self.drop_rate, rng)
        return x + self.token_type_embeddings.weight[img_token_type_idx].to(x.dtype)

    def embed_txt(self, ids: torch.Tensor, rng: StepRng | None = None) -> torch.Tensor:
        x = self.txt_embeddings(ids, rng)
        return x + self.token_type_embeddings.weight[0].to(x.dtype)

    # ------------------------------------------------------------------ blocks

    def run_blocks(self, x, mask, route: str, in_layer: int = 0,
                   out_layer: int | None = None,
                   rng: StepRng | None = None) -> torch.Tensor:
        bias = key_padding_bias(mask)
        for blk in self.blocks[in_layer:out_layer]:
            x = blk(x, bias, route, rng)
        return x

    def _img_mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.ones(x.shape[:2], dtype=torch.int32, device=x.device)

    def forward_features(self, img=None, txt=None, txt_mask=None,
                         bool_masked_pos=None, rng: StepRng | None = None,
                         img_token_type_idx: int = 1):
        """img-only -> route 'v' through every block; txt-only -> route 'l';
        both -> separate streams below the fusion layer, then [txt, img]
        concatenated on route 'vl'. The image takes token type
        `img_token_type_idx`. Returns (features, mask)."""
        if txt is None:
            x = self.embed_img(img, bool_masked_pos, rng, img_token_type_idx)
            mask = self._img_mask(x)
            x = self.run_blocks(x, mask, "v", rng=rng)
            return self.norm(x).to(self.dtype), mask
        if img is None:
            x = self.run_blocks(self.embed_txt(txt, rng), txt_mask, "l", rng=rng)
            return self.norm(x).to(self.dtype), txt_mask

        # the two streams block by block, in JAX's order, so the random
        # draws come in the same order as JAX's
        img_x = self.embed_img(img, bool_masked_pos, rng, img_token_type_idx)
        txt_x = self.embed_txt(txt, rng)
        img_bias = key_padding_bias(self._img_mask(img_x))
        txt_bias = key_padding_bias(txt_mask)
        for blk in self.blocks[:self.fusion_layer]:
            img_x = blk(img_x, img_bias, "v", rng)
            txt_x = blk(txt_x, txt_bias, "l", rng)
        return self.fuse_from_hidden(img_x, txt_x, txt_mask, rng)

    def stream_below_fusion(self, img=None, txt=None, txt_mask=None,
                            rng: StepRng | None = None):
        """Embed one modality and run blocks[:fusion_layer] on its route."""
        if img is not None:
            x = self.embed_img(img, rng=rng)
            return self.run_blocks(x, self._img_mask(x), "v", 0,
                                   self.fusion_layer, rng)
        return self.run_blocks(self.embed_txt(txt, rng), txt_mask, "l", 0,
                               self.fusion_layer, rng)

    def continue_single_stream(self, x, mask, route: str,
                               rng: StepRng | None = None) -> torch.Tensor:
        """blocks[fusion_layer:] on one modality, then the final norm."""
        x = self.run_blocks(x, mask, route, self.fusion_layer, rng=rng)
        return self.norm(x).to(self.dtype)

    def fuse_from_hidden(self, img_hidden, txt_hidden, txt_mask,
                         rng: StepRng | None = None):
        """Concatenate below-fusion [txt, img] states, run blocks[fusion:]."""
        co = torch.cat([txt_hidden, img_hidden], dim=1)
        co_mask = torch.cat([txt_mask.to(torch.int32), self._img_mask(img_hidden)],
                            dim=1)
        co = self.run_blocks(co, co_mask, "vl", self.fusion_layer, rng=rng)
        return self.norm(co).to(self.dtype), co_mask

    def pool(self, co_feats: torch.Tensor) -> torch.Tensor:
        return self.pooler(co_feats)

    def attend_vocab(self, x: torch.Tensor) -> torch.Tensor:
        """x . word_embedding^T, the tied MLM decoder. fp32, as flax's
        `Embed.attend` promotes the compute-dtype input to the table's fp32."""
        return torch.matmul(x.float(), self.txt_embeddings.word_embeddings.weight.T)
