"""DALL-E dVAE encoder: the frozen image tokenizer of MIM.

Counterpart of `exploremultimodal_tpu/models/dvae.py` (`_Conv`,
`EncoderBlock`, `DalleEncoder`, `DalleVAE.get_codebook_indices`,
`init_random`), with the same module names so `convert.from_flax_params`
maps the JAX encoder's parameters. Eager cuDNN convolution in the compute
dtype; the final 1x1 projection to the 8192 codes stays fp32 for stable
argmax ties, as in JAX. Images are NHWC at the public functions, as in the
JAX package; the convolutions run NCHW.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LOGIT_LAPLACE_EPS = 0.1


def map_pixels(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] pixels -> the logit-Laplace domain."""
    return (1 - 2 * LOGIT_LAPLACE_EPS) * x + LOGIT_LAPLACE_EPS


class _Conv(nn.Module):
    """SAME-padded conv (flax `nn.Conv` under the name `conv`), computed in
    `dtype`: input, kernel and bias are cast to it, as flax does."""

    def __init__(self, cin: int, cout: int, kernel: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, cout, kernel, padding=(kernel - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        return F.conv2d(x.to(self.dtype), c.weight.to(self.dtype),
                        c.bias.to(self.dtype), padding=c.padding)


class EncoderBlock(nn.Module):
    """id_path(x) + post_gain * conv1x1(relu 3x3 relu 3x3 relu 3x3 relu)."""

    def __init__(self, cin: int, n_out: int, post_gain: float, dtype: torch.dtype):
        super().__init__()
        n_hid = n_out // 4
        self.post_gain = post_gain
        self.id_conv = _Conv(cin, n_out, 1, dtype) if cin != n_out else None
        self.conv_1 = _Conv(cin, n_hid, 3, dtype)
        self.conv_2 = _Conv(n_hid, n_hid, 3, dtype)
        self.conv_3 = _Conv(n_hid, n_hid, 3, dtype)
        self.conv_4 = _Conv(n_hid, n_out, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.id_conv(x) if self.id_conv is not None else x
        h = self.conv_1(F.relu(x))
        h = self.conv_2(F.relu(h))
        h = self.conv_3(F.relu(h))
        h = self.conv_4(F.relu(h))
        return identity + self.post_gain * h


class DalleEncoder(nn.Module):
    """OpenAI dVAE encoder: NCHW logit-Laplace pixels -> fp32 code logits."""

    def __init__(self, group_count: int = 4, n_hid: int = 256,
                 n_blk_per_group: int = 2, vocab_size: int = 8192,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.group_count = group_count
        post_gain = 1.0 / (group_count * n_blk_per_group) ** 2
        self.input_conv = _Conv(3, n_hid, 7, dtype)
        cin = n_hid
        self.groups = []
        for g, mult in enumerate((1, 2, 4, 8), start=1):
            names = []
            for b in range(1, n_blk_per_group + 1):
                name = f"group_{g}_block_{b}"
                setattr(self, name, EncoderBlock(cin, mult * n_hid, post_gain, dtype))
                cin = mult * n_hid
                names.append(name)
            self.groups.append(names)
        self.output_conv = _Conv(cin, vocab_size, 1, torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.input_conv(x)
        for g, names in enumerate(self.groups):
            for name in names:
                x = getattr(self, name)(x)
            if g < len(self.groups) - 1:
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
    """The frozen tokenizer (JAX `DalleVAE`, encoder only)."""

    def __init__(self, image_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_size = image_size
        self.encoder = DalleEncoder(dtype=dtype)

    @torch.no_grad()
    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC logit-Laplace images -> (B, H/8 * W/8) int64 token ids."""
        logits = self.encoder(images.permute(0, 3, 1, 2))
        return logits.argmax(dim=1).flatten(1)


def create_d_vae(d_vae_type: str, image_size: int, dtype: torch.dtype,
                 seed: int = 0) -> DalleVAE:
    """The tokenizer for `train.discrete_vae_type`. Only 'random' (seeded
    random weights) is ported: the repository holds no DALL-E weights."""
    if d_vae_type != "random":
        raise NotImplementedError(
            f"discrete_vae_type {d_vae_type!r}: only 'random' is ported (no "
            "DALL-E weights are in the repository); pass "
            "train.discrete_vae_type=random")
    vae = DalleVAE(image_size, dtype=dtype)
    vae.encoder.init_random(torch.Generator().manual_seed(seed))
    return vae.requires_grad_(False).eval()
