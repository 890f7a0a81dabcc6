"""DALL-E dVAE: the frozen image tokenizer of MIM, its decoder, and the
trainable `DiscreteVAE`.

Counterpart of `exploremultimodal_tpu/models/dvae.py` (`map_pixels`,
`unmap_pixels`, `_Conv`, `EncoderBlock`, `DecoderBlock`, `DalleEncoder`,
`DalleDecoder`, `DalleVAE` with `fused`, `quantize` and `decode`,
`init_random`, `create_d_vae`, `import_dalle_torch_state`, `load_dalle_vae`,
`DiscreteVAE` and `_ResBlock`), with the same module names so
`convert.from_flax_params` maps the JAX modules' parameters. Eager cuDNN
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
import os

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


def unmap_pixels(x: torch.Tensor) -> torch.Tensor:
    """The logit-Laplace domain -> [0, 1] pixels, clipped."""
    return ((x - LOGIT_LAPLACE_EPS) / (1 - 2 * LOGIT_LAPLACE_EPS)).clamp(0.0, 1.0)


@torch.no_grad()
def lecun_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's Conv init on every conv of `module`: lecun_normal kernels (a
    normal of variance 1 / fan_in, truncated at 2 std) and zero biases,
    from `generator`."""
    for mod in module.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            tmp = torch.empty(mod.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(tmp, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            mod.weight.copy_(tmp)
            mod.bias.zero_()


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


class DecoderBlock(nn.Module):
    """The decoder's residual block: id_path(x) + post_gain * conv3x3(relu
    conv3x3 relu conv3x3 relu conv1x1 relu), in the compute dtype."""

    def __init__(self, cin: int, n_out: int, post_gain: float, dtype: torch.dtype):
        super().__init__()
        n_hid = n_out // 4
        self.post_gain = post_gain
        self.id_conv = _Conv(cin, n_out, 1, dtype) if cin != n_out else None
        self.conv_1 = _Conv(cin, n_hid, 1, dtype)
        self.conv_2 = _Conv(n_hid, n_hid, 3, dtype)
        self.conv_3 = _Conv(n_hid, n_hid, 3, dtype)
        self.conv_4 = _Conv(n_hid, n_out, 3, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.id_conv(x) if self.id_conv is not None else x
        h = self.conv_1(F.relu(x))
        h = self.conv_2(F.relu(h))
        h = self.conv_3(F.relu(h))
        h = self.conv_4(F.relu(h))
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

    def init_random(self, generator: torch.Generator) -> None:
        lecun_init_(self, generator)


class DalleDecoder(nn.Module):
    """OpenAI dVAE decoder: NCHW one-hot codes -> NCHW fp32 logit-Laplace
    statistics (2 x 3 channels). The input and output 1x1 convs run in
    fp32, the blocks in the compute dtype; each group but the last ends in
    a 2x nearest upsampling (each pixel repeated, as `jax.image.resize`
    gives at an exact 2x)."""

    def __init__(self, group_count: int = 4, n_init: int = 128, n_hid: int = 256,
                 n_blk_per_group: int = 2, output_channels: int = 3,
                 vocab_size: int = 8192, dtype: torch.dtype = torch.float32):
        super().__init__()
        post_gain = 1.0 / (group_count * n_blk_per_group) ** 2
        self.input_conv = _Conv(vocab_size, n_init, 1, torch.float32)
        cin = n_init
        self.groups = []
        for g, mult in enumerate((8, 4, 2, 1), start=1):
            names = []
            for b in range(1, n_blk_per_group + 1):
                name = f"group_{g}_block_{b}"
                setattr(self, name, DecoderBlock(cin, mult * n_hid, post_gain, dtype))
                cin = mult * n_hid
                names.append(name)
            self.groups.append(names)
        self.output_conv = _Conv(cin, 2 * output_channels, 1, torch.float32)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.input_conv(z)
        for g, names in enumerate(self.groups):
            for name in names:
                x = getattr(self, name)(x)
            if g < len(self.groups) - 1:
                x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.output_conv(F.relu(x).float())

    def init_random(self, generator: torch.Generator) -> None:
        lecun_init_(self, generator)


class DalleVAE(nn.Module):
    """The frozen tokenizer (JAX `DalleVAE`), on `device` (CUDA by default;
    without a GPU it raises unless given 'cpu'). `fused=True` runs the
    blocks JAX's selector fuses through the fused block kernel, `quantize`
    the trunk on int8 codes; the two are exclusive, as in JAX. With
    `decoder` it also holds the `DalleDecoder` that `decode` runs (the
    inpainting endpoint's); the trainer's tokenizer goes without."""

    def __init__(self, image_size: int, dtype: torch.dtype = torch.float32,
                 fused: bool = False, quantize: str = "none",
                 device: str | torch.device = "cuda", decoder: bool = False):
        super().__init__()
        if fused and quantize != "none":
            raise ValueError("fused kernel and int8 encoder paths are exclusive")
        self.image_size = image_size
        self.fused = fused
        self.encoder = DalleEncoder(dtype=dtype, quantize=quantize)
        self.decoder = DalleDecoder(dtype=dtype) if decoder else None
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

    @torch.no_grad()
    def decode(self, img_seq: torch.Tensor) -> torch.Tensor:
        """(B, N) token ids on a square grid -> NHWC fp32 logit-Laplace
        statistics at 8x the grid (the first 3 channels the means)."""
        if self.decoder is None:
            raise RuntimeError("this tokenizer has no decoder: build it with "
                               "decoder=True, or load a decoder.pkl with weights")
        b, n = img_seq.shape
        grid = math.isqrt(n)
        one_hot = F.one_hot(img_seq.reshape(b, grid, grid).long(),
                            self.encoder.vocab_size).to(torch.float32)
        return self.decoder(one_hot.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def import_dalle_torch_state(state: dict) -> dict[str, torch.Tensor]:
    """An OpenAI `dall_e` encoder state dict as `DalleEncoder`'s state dict.

    The `dall_e` names (its `encoder.py`) and the port's:
      blocks.input.{w,b}                            -> input_conv.conv
      blocks.group_{g}.block_{b}.id_path.{w,b}      -> group_{g}_block_{b}.id_conv.conv
      blocks.group_{g}.block_{b}.res_path.conv_{k}.{w,b}
                                                    -> group_{g}_block_{b}.conv_{k}.conv
      blocks.output.conv.{w,b}                      -> output_conv.conv
    Both keep torch's OIHW kernels, so the tensors pass as they are (in
    fp32)."""
    out = {}
    for name, w in state.items():
        if not name.endswith(".w"):
            continue
        b = state[name[:-2] + ".b"]
        parts = name.split(".")
        if parts[1] in ("input", "output"):
            mod = f"{parts[1]}_conv"
        else:
            g, blk = parts[1].split("_")[1], parts[2].split("_")[1]
            leaf = "id_conv" if parts[3] == "id_path" else parts[4]
            mod = f"group_{g}_block_{blk}.{leaf}"
        out[f"{mod}.conv.weight"] = torch.as_tensor(w).detach().float().cpu()
        out[f"{mod}.conv.bias"] = torch.as_tensor(b).detach().float().cpu()
    return out


def load_dalle_vae(weight_dir: str, image_size: int, dtype: torch.dtype = torch.float32,
                   quantize: str = "none",
                   device: str | torch.device = "cuda") -> DalleVAE:
    """The tokenizer with OpenAI's weights from `<weight_dir>/encoder.pkl`
    and `decoder.pkl` (each a pickled module or a state dict, both read
    through the same name map), on `device`. Both files must exist, as
    JAX's loader opens both; a `decoder.pkl` without weights leaves the
    tokenizer without a decoder (JAX's then holds an empty tree), so
    `decode` raises."""
    states = {}
    for part in ("encoder", "decoder"):
        obj = torch.load(os.path.join(weight_dir, f"{part}.pkl"), map_location="cpu",
                         weights_only=False)
        states[part] = import_dalle_torch_state(
            obj if isinstance(obj, dict) else obj.state_dict())
    vae = DalleVAE(image_size, dtype=dtype, quantize=quantize, device="cpu",
                   decoder=bool(states["decoder"]))
    vae.encoder.load_state_dict(states["encoder"], strict=True)
    if vae.decoder is not None:
        vae.decoder.load_state_dict(states["decoder"], strict=True)
    return vae.to(resolve_device(device)).requires_grad_(False).eval()


def create_d_vae(d_vae_type: str, image_size: int, dtype: torch.dtype,
                 seed: int = 0, quantize: str = "none",
                 device: str | torch.device = "cuda",
                 weight_path: str = "", decoder: bool = False) -> DalleVAE:
    """The tokenizer for `train.discrete_vae_type` on `device`, its trunk on
    int8 codes under `quantize` (`train.discrete_vae_quantize`). 'dall-e'
    loads OpenAI's encoder and decoder from `weight_path`
    (`load_dalle_vae`; the trainer's `dvae_type` falls back to 'random'
    where no `encoder.pkl` exists); 'random' is the seeded random tokenizer
    (seed 0, as JAX's `jax.random.key(0)`), with a random decoder, drawn
    after the encoder, under `decoder`. Every other type raises, as in JAX
    (`DiscreteVAE` has no entry point there either)."""
    if d_vae_type == "dall-e":
        return load_dalle_vae(weight_path, image_size, dtype, quantize, device)
    if d_vae_type != "random":
        raise NotImplementedError(f"discrete_vae_type {d_vae_type!r} is not ported")
    vae = DalleVAE(image_size, dtype=dtype, quantize=quantize, device="cpu",
                   decoder=decoder)
    generator = torch.Generator().manual_seed(seed)
    vae.encoder.init_random(generator)
    if vae.decoder is not None:
        vae.decoder.init_random(generator)
    return vae.to(resolve_device(device)).requires_grad_(False).eval()


# --------------------------------------------------- trainable DiscreteVAE


def _conv_in(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`conv` on NCHW `x` in `dtype` (input, kernel and bias cast to it, as
    flax's `Conv(dtype=...)`)."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride, conv.padding)


class _ResBlock(nn.Module):
    """relu(conv3x3) -> relu(conv3x3) -> conv1x1, plus the input (flax's
    auto-named `Conv_0`, `Conv_1`, `Conv_2`)."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(dim, dim, 3, padding=1)
        self.Conv_1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.Conv_2 = nn.Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(_conv_in(self.Conv_0, x, self.dtype))
        h = F.relu(_conv_in(self.Conv_1, h, self.dtype))
        return _conv_in(self.Conv_2, h, self.dtype) + x


class DiscreteVAE(nn.Module):
    """The trainable dVAE (JAX's `DiscreteVAE`): `num_layers` stride-2 4x4
    convs with residual blocks down to the code logits, a Gumbel-softmax
    (or plain softmax) mix of the codebook, and `num_layers` stride-2 4x4
    transposed convs with residual blocks back to pixels. NHWC at the
    public methods. The transposed convs `dec_convs_<i>` are JAX's
    `ConvTranspose(4, stride 2, 'SAME')`: a correlation of the 2x dilated
    input, padded by 2, with the unflipped kernel, which
    `ConvTranspose2d(4, 2, padding=1)` computes with the kernel flipped
    (`convert.from_flax_params` flips it)."""

    def __init__(self, image_size: int = 256, num_tokens: int = 8192,
                 codebook_dim: int = 512, num_layers: int = 3, hidden_dim: int = 64,
                 channels: int = 3, temperature: float = 0.9,
                 straight_through: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_size = image_size
        self.num_tokens = num_tokens
        self.num_layers = num_layers
        self.temperature = temperature
        self.straight_through = straight_through
        self.dtype = dtype
        self.codebook = nn.Embedding(num_tokens, codebook_dim)
        for i in range(num_layers):
            setattr(self, f"enc_convs_{i}", nn.Conv2d(
                channels if i == 0 else hidden_dim, hidden_dim, 4, stride=2, padding=1))
            setattr(self, f"dec_convs_{i}", nn.ConvTranspose2d(
                codebook_dim if i == 0 else hidden_dim, hidden_dim, 4, stride=2,
                padding=1))
            setattr(self, f"enc_res_{i}", _ResBlock(hidden_dim, dtype))
            setattr(self, f"dec_res_{i}", _ResBlock(hidden_dim, dtype))
        self.to_logits = nn.Conv2d(hidden_dim, num_tokens, 1)
        self.to_pixels = nn.Conv2d(hidden_dim, channels, 1)

    def encode_logits(self, img: torch.Tensor) -> torch.Tensor:
        """NHWC images -> NHWC fp32 code logits at 1 / 2^num_layers."""
        x = img.permute(0, 3, 1, 2)
        for i in range(self.num_layers):
            x = F.relu(_conv_in(getattr(self, f"enc_convs_{i}"), x, self.dtype))
            x = getattr(self, f"enc_res_{i}")(x)
        return _conv_in(self.to_logits, x.float(), torch.float32).permute(0, 2, 3, 1)

    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """NHWC codebook vectors -> NHWC fp32 pixels."""
        x = codes.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(self.num_layers):
            conv = getattr(self, f"dec_convs_{i}")
            x = F.relu(F.conv_transpose2d(x, conv.weight.to(self.dtype),
                                          conv.bias.to(self.dtype), conv.stride,
                                          conv.padding))
            x = getattr(self, f"dec_res_{i}")(x)
        return _conv_in(self.to_pixels, x.float(), torch.float32).permute(0, 2, 3, 1)

    @torch.no_grad()
    def get_codebook_indices(self, img: torch.Tensor) -> torch.Tensor:
        """NHWC images -> (B, h * w) int64 code ids."""
        return self.encode_logits(img).argmax(dim=-1).flatten(1)

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None,
                temp: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(reconstruction, mean squared reconstruction loss). With a
        `generator`, Gumbel noise drawn on it perturbs the logits before the
        softmax at `temp` (the module's temperature by default); without
        one the softmax is deterministic. `straight_through` takes the
        one-hot argmax forward and the soft gradient backward."""
        logits = self.encode_logits(img)
        temp = self.temperature if temp is None else temp
        if generator is not None:
            u = torch.rand(logits.shape, generator=generator, device=logits.device)
            logits = logits - torch.log(-torch.log(u + 1e-20) + 1e-20)
        soft = torch.softmax(logits / temp, dim=-1)
        if self.straight_through:
            hard = F.one_hot(soft.argmax(-1), self.num_tokens).to(soft.dtype)
            soft = hard + soft - soft.detach()
        recon = self.decode_codes(soft @ self.codebook.weight)
        return recon, ((recon - img) ** 2).mean()
