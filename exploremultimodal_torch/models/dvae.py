"""DALL-E dVAE encoder: the frozen image tokenizer of MIM.

Counterpart of `exploremultimodal_tpu/models/dvae.py` (`_Conv`,
`EncoderBlock`, `DalleEncoder`, `DalleVAE` with `fused` and `quantize`,
`init_random`, `create_d_vae`), with the same module names so
`convert.from_flax_params` maps the JAX encoder's parameters. Eager cuDNN
convolution in the compute dtype, the bias added after it in that dtype, as
flax does; `quantize` runs the input conv and the trunk on int8 codes
(`ops/quant_conv.py`), and `DalleVAE(fused=True)` runs the blocks JAX's
selector fuses through the fused block kernel (`ops/dvae_conv.py`), as
JAX's `encoder_apply_fused` does, and the others as here. The final
1x1 projection to the 8192 codes stays fp32 and is never quantized, for
stable argmax ties, as in JAX. Images are NHWC at the public functions, as
in the JAX package; the module convolutions run NCHW.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from exploremultimodal_torch.models.task import resolve_device
from exploremultimodal_torch.ops.dvae_conv import fused_encoder_block, fuses
from exploremultimodal_torch.ops.quant_conv import quant_conv

LOGIT_LAPLACE_EPS = 0.1
# `train.discrete_vae_quantize` / `quantize` -> the int8 conv emitter
QUANT_IMPLS = {"none": None, "w8a8": "direct", "w8a8_shifted": "shifted"}


def map_pixels(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] pixels -> the logit-Laplace domain."""
    return (1 - 2 * LOGIT_LAPLACE_EPS) * x + LOGIT_LAPLACE_EPS


class _Conv(nn.Module):
    """SAME-padded conv (flax `nn.Conv` under the name `conv`), computed in
    `dtype`: input and kernel are cast to it and the bias is added after
    the conv in it, as flax does. With `quantize` ('w8a8' or
    'w8a8_shifted') the product runs on int8 codes of the dtype input and the
    fp32 kernel (`_QuantConvCore`)."""

    def __init__(self, cin: int, cout: int, kernel: int, dtype: torch.dtype,
                 quantize: str = "none"):
        super().__init__()
        if quantize not in QUANT_IMPLS:
            raise ValueError(f"unknown dVAE quantize={quantize!r} "
                             f"({'|'.join(QUANT_IMPLS)})")
        self.dtype = dtype
        self.impl = QUANT_IMPLS[quantize]
        self.conv = nn.Conv2d(cin, cout, kernel, padding=(kernel - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        if self.impl is not None:
            y = quant_conv(x.to(self.dtype), c.weight, c.padding[0], self.impl)
        else:
            y = F.conv2d(x.to(self.dtype), c.weight.to(self.dtype), padding=c.padding)
        return y + c.bias.to(y.dtype)[:, None, None]


class EncoderBlock(nn.Module):
    """id_path(x) + post_gain * conv1x1(relu 3x3 relu 3x3 relu 3x3 relu), in
    the compute dtype (JAX's `EncoderBlock` and `_xla_block`)."""

    def __init__(self, cin: int, n_out: int, post_gain: float, dtype: torch.dtype,
                 quantize: str = "none"):
        super().__init__()
        n_hid = n_out // 4
        self.post_gain = post_gain
        q = quantize
        self.id_conv = _Conv(cin, n_out, 1, dtype, q) if cin != n_out else None
        self.conv_1 = _Conv(cin, n_hid, 3, dtype, q)
        self.conv_2 = _Conv(n_hid, n_hid, 3, dtype, q)
        self.conv_3 = _Conv(n_hid, n_hid, 3, dtype, q)
        self.conv_4 = _Conv(n_hid, n_out, 1, dtype, q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.id_conv(x) if self.id_conv is not None else x
        h = self.conv_1(F.relu(x))
        h = self.conv_2(F.relu(h))
        h = self.conv_3(F.relu(h))
        h = self.conv_4(F.relu(h))
        # JAX multiplies by post_gain rounded to h's dtype
        return identity + h * float(torch.tensor(self.post_gain, dtype=h.dtype))


class DalleEncoder(nn.Module):
    """OpenAI dVAE encoder: NCHW logit-Laplace pixels -> fp32 code logits.
    `quantize` reaches the input conv and every block, never `output_conv`.
    `forward(x, fused=True)` is JAX's `encoder_apply_fused`: each block
    JAX's selector fuses runs through `fused_encoder_block` on NHWC
    activations (its group's pool fused into the group's last block), the
    others as `EncoderBlock`s, on the same channels-last memory."""

    def __init__(self, group_count: int = 4, n_hid: int = 256,
                 n_blk_per_group: int = 2, vocab_size: int = 8192,
                 dtype: torch.dtype = torch.float32, quantize: str = "none"):
        super().__init__()
        self.vocab_size = vocab_size
        self.dtype = dtype
        self.quantize = quantize
        self.post_gain = 1.0 / (group_count * n_blk_per_group) ** 2
        self.input_conv = _Conv(3, n_hid, 7, dtype, quantize)
        cin = n_hid
        self.groups = []
        for g, mult in enumerate((1, 2, 4, 8), start=1):
            names = []
            for b in range(1, n_blk_per_group + 1):
                name = f"group_{g}_block_{b}"
                setattr(self, name, EncoderBlock(cin, mult * n_hid, self.post_gain,
                                                 dtype, quantize))
                cin = mult * n_hid
                names.append(name)
            self.groups.append(names)
        self.output_conv = _Conv(cin, vocab_size, 1, torch.float32)

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        if fused and self.quantize != "none":
            raise ValueError("fused kernel and int8 encoder paths are exclusive")
        x = self.input_conv(x)
        for g, names in enumerate(self.groups):
            pool = g < len(self.groups) - 1
            for i, name in enumerate(names):
                blk = getattr(self, name)
                if fused and fuses(blk, x.shape[2], x.shape[3], x.element_size()):
                    fuse_pool = pool and i == len(names) - 1
                    x = fused_encoder_block(x.permute(0, 2, 3, 1).contiguous(), blk,
                                            self.post_gain, fuse_pool).permute(0, 3, 1, 2)
                    pool = pool and not fuse_pool
                else:
                    x = blk(x)
            if pool:
                x = F.max_pool2d(x, 2)
        return self.output_conv(F.relu(x).float())

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        """flax's Conv init: lecun_normal kernels (a normal of variance
        1 / fan_in, truncated at 2 std) and zero biases, from `generator`."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                tmp = torch.empty(mod.weight.shape, dtype=torch.float32)
                nn.init.trunc_normal_(tmp, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                mod.weight.copy_(tmp)
                mod.bias.zero_()


class DalleVAE(nn.Module):
    """The frozen tokenizer (JAX `DalleVAE`, encoder only), on `device`
    (CUDA by default; without a GPU it raises unless given 'cpu').
    `fused=True` runs the blocks JAX's selector fuses through the fused
    block kernel, `quantize` the trunk on int8 codes; the two are exclusive,
    as in JAX."""

    def __init__(self, image_size: int, dtype: torch.dtype = torch.float32,
                 fused: bool = False, quantize: str = "none",
                 device: str | torch.device = "cuda"):
        super().__init__()
        if fused and quantize != "none":
            raise ValueError("fused kernel and int8 encoder paths are exclusive")
        self.image_size = image_size
        self.fused = fused
        self.encoder = DalleEncoder(dtype=dtype, quantize=quantize)
        self.to(resolve_device(device))

    def _encode(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC logit-Laplace images -> NHWC fp32 logits."""
        x = images.permute(0, 3, 1, 2)
        return self.encoder(x, fused=self.fused).permute(0, 2, 3, 1)

    @torch.no_grad()
    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC logit-Laplace images -> (B, H/8 * W/8) int64 token ids."""
        return self._encode(images).argmax(dim=-1).flatten(1)

    @torch.no_grad()
    def get_codebook_probs(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC logit-Laplace images -> (B, H/8, W/8, vocab) softmax."""
        return torch.softmax(self._encode(images), dim=-1)


def create_d_vae(d_vae_type: str, image_size: int, dtype: torch.dtype,
                 seed: int = 0, quantize: str = "none",
                 device: str | torch.device = "cuda") -> DalleVAE:
    """The tokenizer for `train.discrete_vae_type` on `device`, its trunk on
    int8 codes under `quantize` (`train.discrete_vae_quantize`). 'random'
    is the seeded random tokenizer (seed 0, as JAX's `jax.random.key(0)`);
    'dall-e' reaches here only when an `encoder.pkl` exists
    (`trainer.dvae_type` falls back to 'random' otherwise) and raises: the
    loader of the OpenAI weights is not ported yet (ROADMAP.md, queue A,
    item 2), and the port must not train on random codes where JAX would
    load weights."""
    if d_vae_type == "dall-e":
        raise NotImplementedError(
            "discrete_vae_type 'dall-e' with an encoder.pkl present: loading the "
            "DALL-E weights is not ported yet (ROADMAP.md, queue A, item 2)")
    if d_vae_type != "random":
        raise NotImplementedError(f"discrete_vae_type {d_vae_type!r} is not ported")
    vae = DalleVAE(image_size, dtype=dtype, quantize=quantize, device=device)
    vae.encoder.init_random(torch.Generator().manual_seed(seed))
    return vae.requires_grad_(False).eval()
