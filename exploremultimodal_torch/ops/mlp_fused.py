"""Fused bf16 MLP: the CUDA kernels' wrappers, their plain versions, and the
differentiable `fused_mlp`.

Counterpart of `exploremultimodal_tpu/ops/mlp_pallas.py`:
  - `fused_mlp_fwd`       `_mlp_kernel`
  - `fused_mlp_fwd_drop`  `_mlp_dropout_kernel` (hidden dropout from uint16 bits)
  - `fused_mlp`           `fused_bf16_mlp` / `fused_bf16_mlp_dropout`, with
                          the backward of `_vjp_bwd` / `_vjpd_bwd`
Both forwards are `csrc/fused_mlp_sm90.cu` (wgmma, TMA, clusters; the
dropout forward is its `DROP` variant), at the widths JAX sends to its
kernel: K = N in `WIDTHS` (vlmo_debug's 96, vlmo_tiny's 192, vlmo_small's
384, vlmo_base's 768), any hidden of whole 64-column chunks. The weights are in nn.Linear's
layout: w1 (hidden, in), w2 (out, hidden); the biases are fp32. The
dropout bits are uint16 draws u held as the int16 u - 32768
(`stochastic.bits16`); an element is kept where u >= t.

With b2 None each function is in its partial mode: the output is the fp32
sum over the given hidden, without b2 and unrounded. That is a tensor
rank's share of a row-parallel fc2 (`models.vlmo.Mlp` under tensor
parallelism), which the all-reduce adds to the other ranks' before b2 and
the one rounding, so the sum is the whole kernel's but for the order of
the fp32 additions.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from exploremultimodal_torch.ops import _build
from exploremultimodal_torch.ops.stochastic import keep16, keep_scale16

# The JAX package sends a shape to its fused kernel only while both bf16
# weight matrices fit this budget (mlp_pallas.py `fits_vmem`), and to the
# erf-gelu XLA path otherwise. The port keeps the same predicate so the two
# packages pick the same function (and gelu form) at every width.
_RESIDENT_BYTES_CAP = 10 * 1024 * 1024
# the widths K = N the sm90 kernel takes (x's 64 x K tile stays in shared
# memory): every preset that `fits_vmem` sends to it
WIDTHS = (96, 192, 384, 768)

_P, _I = ctypes.c_void_p, ctypes.c_int
# maps, biases, y, part, then m, k, hidden, splits, partial (and the threshold)
_SM90_ARGTYPES = [_P] * 7 + [_I] * 5 + [_P]
_ENCODE_ARGTYPES = [_P, _P] + [_I] * 2
_DROP_ARGTYPES = [_P] * 8 + [_I] * 6 + [ctypes.c_float, _P]

# the sm90 kernel's tiling: 64-row tiles in clusters of 2 CTAs, the hidden
# walked in 64-column chunks (csrc/fused_mlp_sm90.cu); its weight ring of
# RING_STAGES stages of STAGE_BOXES 64 x 64 bf16 boxes
ROW_TILE, CLUSTER, HIDDEN_CHUNK = 64, 2, 64
RING_STAGES, STAGE_BOXES, BOX_BYTES = 3, 4, 8192
# tensor maps (128-byte host buffers, 64 x 64 boxes) by `tensor_map_key`; a
# map depends only on the address and shape, never on the contents, so a hit
# is always right (the int16 dropout bits and a bf16 matrix of one shape at
# one address encode the same 2-byte map); the cache is emptied when it
# reaches the cap
_MAPS: dict = {}
_MAPS_CAP = 256
_SMS: dict = {}
SMEM_LIMIT = 232448  # dynamic shared memory an H100 block may use


def fits_vmem(in_dim: int, hidden_dim: int, out_dim: int) -> bool:
    return 2 * (in_dim * hidden_dim + hidden_dim * out_dim) <= _RESIDENT_BYTES_CAP


def gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + torch.tanh(
        0.7978845608028654 * (h + 0.044715 * h * h * h)))


def _plain(x, w1, b1, w2, b2, bits, threshold):
    h = gelu_tanh(F.linear(x.float(), w1.to(x.dtype).float()) + b1.float())
    if bits is not None:
        scale = torch.tensor(keep_scale16(threshold), dtype=torch.float32,
                             device=x.device)
        h = torch.where(keep16(bits, threshold), h * scale, torch.zeros_like(h))
    y = F.linear(h.to(x.dtype).float(), w2.to(x.dtype).float())
    return y if b2 is None else (y + b2.float()).to(x.dtype)


def fused_mlp_fwd_plain(x, w1, b1, w2, b2):
    """x: (M, K). fp32 products of the input-dtype operands, fp32 biases,
    the hidden rounded to x's dtype before the second product. With b2
    None, the partial mode: the fp32 product, no b2, not rounded."""
    return _plain(x, w1, b1, w2, b2, None, 0)


def fused_mlp_fwd_drop_plain(x, w1, b1, w2, b2, bits, threshold: int):
    """`fused_mlp_fwd_plain` with the hidden dropout of
    `_mlp_dropout_kernel`: after the gelu, in fp32, keep where the uint16
    `bits` (M, H) are >= `threshold` and scale by 65536 / (65536 - t), then
    round the hidden to x's dtype."""
    return _plain(x, w1, b1, w2, b2, bits, threshold)


def _check(name, x, w1, b1, w2, b2, bits=None):
    m, k = x.shape
    hdim, ndim = w1.shape[0], w2.shape[0]
    tensors = tuple(t for t in (x, w1, b1, w2, b2, bits) if t is not None)
    ok = (x.dtype == w1.dtype == w2.dtype == torch.bfloat16
          and b1.dtype == torch.float32
          and (b2 is None or (b2.dtype == torch.float32 and b2.shape == (ndim,)))
          and w1.shape == (hdim, k) and w2.shape == (ndim, hdim)
          and b1.shape == (hdim,)
          and (bits is None or (bits.dtype == torch.int16
                                and bits.shape == (m, hdim)))
          and k % 16 == 0 and hdim % 32 == 0 and ndim in WIDTHS
          and all(t.is_contiguous() and t.device == x.device
                  and t.data_ptr() % 16 == 0 for t in tensors))
    if not ok:
        raise ValueError(
            f"{name}: needs contiguous, 16-byte aligned bf16 x (M, K), "
            f"w1 (H, K), w2 (N, H), fp32 b1, b2 or None (and int16 bits (M, H)) on "
            f"one device, K % 16 == 0, H % 32 == 0, N in {WIDTHS}; got x "
            f"{tuple(x.shape)} {x.dtype}, w1 {tuple(w1.shape)} {w1.dtype}, "
            f"w2 {tuple(w2.shape)} {w2.dtype}, b1 {b1.dtype}, "
            f"b2 {None if b2 is None else b2.dtype}"
            + ("" if bits is None else f", bits {tuple(bits.shape)} {bits.dtype}"))
    return m, k, hdim, ndim


def row_tiles(m: int) -> int:
    """The sm90 kernel's 64-row tiles for M rows, rounded up to whole
    clusters of 2 (a spare CTA stores nothing), as its launcher counts
    them."""
    tiles = -(-m // ROW_TILE)
    return tiles + -tiles % CLUSTER


def hidden_splits(m: int, hdim: int, sms: int) -> int:
    """How many CTAs share one row tile's hidden dimension in the sm90
    kernel. The rule: the largest divisor s of the hidden's 64-column chunks
    with tiles * s <= sms, where tiles is `row_tiles`, so that a call fills
    at most one wave of the card; 1 where the tiles alone pass half a wave
    (M > ~4,200 on 132 SMs). Each split writes an fp32 partial of y, added
    in a second pass."""
    tiles = row_tiles(m)
    chunks = hdim // HIDDEN_CHUNK
    return max(s for s in range(1, chunks + 1)
               if chunks % s == 0 and tiles * s <= max(sms, tiles))


def tensor_map_key(t: torch.Tensor) -> tuple:
    """The key of a matrix's tensor map: device, address, shape."""
    return (t.device.index, t.data_ptr(), tuple(t.shape))


def _tensor_map(t: torch.Tensor):
    key = tensor_map_key(t)
    buf = _MAPS.get(key)
    if buf is None:
        if len(_MAPS) >= _MAPS_CAP:
            _MAPS.clear()
        buf = ctypes.create_string_buffer(128)
        fn = _build.load("fused_mlp_sm90", _ENCODE_ARGTYPES, "fused_mlp_sm90_encode")
        _build.check("fused_mlp_sm90_encode",
                     fn(ctypes.addressof(buf), t.data_ptr(), t.shape[0], t.shape[1]))
        _MAPS[key] = buf
    return buf


def _sm_count(device: torch.device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device.index]


def _sm90_shapes(name, x, w1, b1, w2, b2, bits=None):
    """`_check`, plus what the sm90 kernel alone needs: K == N (in WIDTHS)
    and a hidden of whole 64-column chunks."""
    m, k, hdim, ndim = _check(name, x, w1, b1, w2, b2, bits)
    if k != ndim or hdim % HIDDEN_CHUNK:
        raise ValueError(f"{name}: needs K == N in {WIDTHS} and hidden % "
                         f"{HIDDEN_CHUNK} == 0, got K {k}, N {ndim}, hidden {hdim}")
    return m, hdim, ndim


def sm90_smem(drop: bool = False) -> int:
    """The sm90 kernel's dynamic shared memory, the same at every width:
    x's tile at K = 768, the ring, two h tiles, (DROP) two bits slots, the
    barriers and 1024 bytes of slack."""
    box = BOX_BYTES
    before_bars = 768 // 64 * box + RING_STAGES * STAGE_BOXES * box + 2 * box
    bars = 1 + 2 * RING_STAGES + 4
    return before_bars + (2 * box if drop else 0) + 8 * bars + 1024


def _launch_sm90(name, x, w1, b1, w2, b2, bits=None, threshold=0):
    """Check the shapes and run the sm90 kernel (its DROP variant where
    `bits` is given): maps from the cache, the hidden split of
    `hidden_splits` and its fp32 scratch; with b2 None its partial mode,
    into an fp32 y."""
    m, hdim, ndim = _sm90_shapes(name, x, w1, b1, w2, b2, bits)
    dev = x.device
    partial = b2 is None
    y = torch.empty((m, ndim), dtype=torch.float32 if partial else x.dtype, device=dev)
    splits = hidden_splits(m, hdim, _sm_count(dev))
    part = (torch.empty((splits, m, ndim), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    tensors = (x, w1, w2) if bits is None else (x, w1, w2, bits)
    # the buffers themselves, not their addresses: the list keeps each one
    # alive through the call even if a later lookup empties the cache
    maps = [_tensor_map(t) for t in tensors]
    args = (b1.data_ptr(), None if partial else b2.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(), m, ndim, hdim, splits, int(partial))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if bits is None:
        rc = _build.load("fused_mlp_sm90", _SM90_ARGTYPES)(*maps, *args, stream)
    else:
        fn = _build.load("fused_mlp_sm90", _DROP_ARGTYPES, "fused_mlp_sm90_drop")
        rc = fn(*maps, *args, threshold, keep_scale16(threshold), stream)
    _build.check(name, rc)
    return y


def fused_mlp_fwd(x, w1, b1, w2, b2):
    """The sm90 kernel on CUDA tensors (x (M, K), output N = K in WIDTHS,
    hidden a multiple of 64), the plain version on CPU tensors; with b2
    None the partial mode (fp32, no b2)."""
    if x.device.type == "cpu":
        return fused_mlp_fwd_plain(x, w1, b1, w2, b2)
    y = _launch_sm90("fused_mlp_fwd", x, w1, b1, w2, b2)
    fused_mlp_fwd.launches += 1
    return y


def fused_mlp_fwd_drop(x, w1, b1, w2, b2, bits, threshold: int):
    """As `fused_mlp_fwd_drop_plain`: the sm90 kernel's DROP variant on
    CUDA tensors (bits int16 (M, H), the shapes of `fused_mlp_fwd`), the
    plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_mlp_fwd_drop_plain(x, w1, b1, w2, b2, bits, threshold)
    if not 0 < threshold < 65536:
        raise ValueError(f"fused_mlp_fwd_drop: threshold {threshold} not in (0, 65536)")
    y = _launch_sm90("fused_mlp_fwd_drop", x, w1, b1, w2, b2, bits, threshold)
    fused_mlp_fwd_drop.launches += 1
    return y


fused_mlp_fwd.launches = 0
fused_mlp_fwd_drop.launches = 0


def mlp_backward(g, x2, w1, b1, w2, bits, threshold: int, b2_dtype,
                 approximate: str):
    """The fused MLPs' recompute backward (`mlp_pallas._vjp_bwd`/`_vjpd_bwd`,
    `quant_pallas._mlp_vjp_bwd`/`_mlpd_vjp_bwd`): the hidden recomputed in
    x's dtype, the gelu VJP of the given form ("tanh" for the bf16 MLP,
    "none", erf, for the int8 one), the mask on the activation and on its
    gradient, and five plain products, as JAX leaves them to XLA. Returns
    (dx, dw1, db1, dw2, db2), each in its input's dtype; the master weights
    may be fp32 while x is bf16."""
    dt = x2.dtype
    g2 = g.to(dt)
    w1c, w2c = w1.to(dt), w2.to(dt)
    h1 = F.linear(x2, w1c) + b1.to(dt)
    act = F.gelu(h1, approximate=approximate)
    dh_post = g2 @ w2c
    if bits is not None:
        keep = keep16(bits, threshold)
        scale = torch.tensor(keep_scale16(threshold), dtype=dt, device=x2.device)
        act = torch.where(keep, act * scale, torch.zeros_like(act))
        dh_post = torch.where(keep, dh_post * scale, torch.zeros_like(dh_post))
    dh = torch.ops.aten.gelu_backward(dh_post, h1, approximate=approximate)
    dx = dh @ w1c
    dw1 = (dh.T @ x2).to(w1.dtype)
    db1 = dh.sum(0, dtype=torch.float32).to(b1.dtype)
    dw2 = (g2.T @ act).to(w2.dtype)
    db2 = g2.sum(0, dtype=torch.float32).to(b2_dtype)
    return dx, dw1, db1, dw2, db2


class _FusedMlp(torch.autograd.Function):
    """`fused_bf16_mlp` (bits None) and `fused_bf16_mlp_dropout`: the
    forward kernel, and the backward of `_vjp_bwd` / `_vjpd_bwd`
    (`mlp_backward` with the tanh gelu's VJP)."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, bits, threshold):
        args = (x2, w1.to(x2.dtype).contiguous(), b1.float().contiguous(),
                w2.to(x2.dtype).contiguous(), None if b2 is None else b2.float().contiguous())
        y = fused_mlp_fwd(*args) if bits is None else fused_mlp_fwd_drop(
            *args, bits, threshold)
        ctx.save_for_backward(x2, w1, b1, w2, bits)
        ctx.threshold = threshold
        ctx.b2_dtype = None if b2 is None else b2.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x2, w1, b1, w2, bits = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = mlp_backward(g, x2, w1, b1, w2, bits, ctx.threshold,
                                              ctx.b2_dtype or torch.float32,
                                              approximate="tanh")
        return dx, dw1, db1, dw2, None if ctx.b2_dtype is None else db2, None, None


def fused_mlp(x, w1, b1, w2, b2, bits=None, threshold: int = 0):
    """gelu_tanh(x . w1^T + b1) [hidden dropout] . w2^T + b2 over the last
    axis of x, differentiable in x, w1, b1, w2 and b2. The weights may be
    fp32 masters: they are cast to x's dtype for the kernels. With `bits`
    (x.shape[:-1] + (hidden,), as `stochastic.bits16` draws them) the hidden
    is dropped where bits < `threshold`. With b2 None, the partial mode: the
    fp32 product over this hidden, no b2, not rounded; its backward is the
    whole one's but db2 (and dx is this hidden's share)."""
    *lead, k = x.shape
    x2 = x.reshape(-1, k).contiguous()
    if bits is not None:
        bits = bits.reshape(x2.shape[0], -1).contiguous()
    y = _FusedMlp.apply(x2, w1, b1, w2, b2, bits, threshold)
    return y.reshape(*lead, w2.shape[0])
