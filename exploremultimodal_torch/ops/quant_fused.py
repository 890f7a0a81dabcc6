"""W8A8 kernels (int8 weights and activations): the CUDA kernels' wrappers,
their plain versions, and the differentiable functions over them.

Counterpart of `exploremultimodal_tpu/ops/quant_pallas.py`:
  - `quantize_weights`   `quantize_weights` (per output channel)
  - `w8a8_matmul`        `_fused_kernel` (row 8): dequant(row_quant(x) . qw^T)
  - `pallas_quant_dot`   `pallas_quant_dot`, with the straight-through (STE)
                         backward of `_pqd_bwd`
  - `w8a8_mlp_fwd`       `_mlp_kernel` (row 9): the whole MLP on int8 products
  - `w8a8_mlp_fwd_drop`  `_mlp_dropout_kernel` (row 10): with hidden dropout
  - `w8a8_mlp`           `fused_w8a8_mlp` / `fused_w8a8_mlp_dropout`, with the
                         backward of `_mlp_vjp_bwd` / `_mlpd_vjp_bwd`
and the tensor-split modes, which give a tensor rank's share of the whole
call under `parallel=tp` (GSPMD's partition of these sites in JAX):
  - `w8a8_matmul_partial`   row 8 on a row-parallel share (proj: K / T of its
                            K input columns): x's rows quantized at their
                            absmax over the whole K, given from outside, and
                            the fp32 partial product (acc * sx) * sw,
                            unrounded
  - `w8a8_mlp_fwd_split`, `w8a8_mlp_fwd_drop_split`
                            rows 9 and 10 on a rank's hidden columns in two
                            launches: the first pass's row absmax of h, then,
                            after the caller's all-reduce-max of it, the second
                            pass at the global scale, writing the fp32 partial
                            output without b2
  - `pallas_quant_dot_partial`, `w8a8_mlp(tensor=...)`
                            the differentiable functions over them, whose
                            weight scales are maxima over the tensor group
Row 8 is `csrc/w8a8_matmul_sm90.cu`, rows 9 and 10 `csrc/w8a8_mlp_sm90.cu`
(all three on int8 wgmma and TMA; row 10 row 9's `DROP` variant). Row 8
takes any K % 64 == 0 in [MATMUL_K_MIN, MATMUL_K_MAX] and any N % 64 == 0
(every preset's qkv and proj and their tensor shares); rows 9 and 10 take
K = N in MLP_WIDTHS (every preset's) and any hidden of whole 64-column
chunks. Weights
are in nn.Linear's layout, (out, in), and so are their int8 codes, with one
fp32 scale per output channel. The plain versions take each int8 product
exactly, as a float64 product of the codes (every sum is an integer below
2**53), so they run on the card as well, where integer matmuls do not.
"""

from __future__ import annotations

import ctypes

import torch

from exploremultimodal_torch.ops import _build
from exploremultimodal_torch.ops.mlp_fused import (
    _sm_count,
    gelu_tanh,
    mlp_backward,
    tensor_map_key,
)
from exploremultimodal_torch.ops.stochastic import keep16, keep_scale16

_EPS = 1e-8
# row 8's input widths: K % 64 == 0 in [MATMUL_K_MIN, MATMUL_K_MAX] (qkv
# and proj of every preset, 192 to 1,024, and their row shares down to
# vlmo_base's 768 / 4); any N % 64 == 0 (the column shares of qkv: 576 at
# vlmo_base and T = 4)
MATMUL_K_MIN, MATMUL_K_MAX = 192, 1024
# rows 9 and 10's widths K = N: vlmo_tiny, vlmo_small, vlmo_base, vlmo_large
MLP_WIDTHS = (192, 384, 768, 1024)
HIDDEN_CHUNK = 64  # the MLP kernels walk the hidden in chunks this wide
# the row-9 kernel's layout, as csrc/w8a8_mlp_sm90.cu sets it (`layout`):
# 64-row tiles in clusters of 2 CTAs along M, or, split, of 2 CTAs along
# the hidden; the weight codes in TMA boxes of (bytes a row, rows, swizzle
# bytes): qW1 (H, K) in K-major 128 x 64 boxes, qW2 (N, H) in 64 x 128
# boxes (a chunk's 64 hidden bytes a row, 128 output columns: a piece);
# x's codes (64 x K), a ring of 2 stages of `mlp_layout`'s boxes (a chunk
# of W1, or of W2 for a part of the output), two h code tiles, 4 x 64 row
# scales, the barriers, then (with dropout) MLP_BITS_SLOTS bits slots and
# 1024 bytes of slack. The int16 dropout bits (M, H) are read as (M, 2 H)
# bytes in qW1's box: 64 rows of a chunk's 64 values. Past MLP_PART_MAX
# output columns the second product runs in two parts
MLP_ROW_TILE, MLP_CLUSTER = 64, 2
MLP_BOXES = {"w1": (128, 64, 128), "w2": (64, 128, 64), "bits": (128, 64, 128)}
MLP_RING_STAGES, MLP_BOX_BYTES, MLP_BITS_SLOTS, MLP_PART_MAX = 2, 8192, 2, 768
# the row-8 kernel's layout, as csrc/w8a8_matmul_sm90.cu sets it: a CTA per
# 128-row block; output tiles of 128 columns (its two consumer warpgroups
# take them in turn), split over the grid's y where the row blocks leave
# SMs idle; x's codes (128 x the layout's widest K), a ring of stages of
# two 64-row boxes of qw (128 K bytes a row, 128-byte swizzle), four 64 x
# 64 bf16 boxes of y staged for their TMA stores, 128 row scales, the
# barriers and 1024 bytes of slack. Three layouts: {widest K: ring stages}
MATMUL_ROW_TILE, MATMUL_COL_TILE = 128, 128
MATMUL_LAYOUTS = {384: 6, 768: 6, 1024: 4}
# the tensor maps' boxes (columns, rows) and swizzle bytes: qw's int8 codes
# and y's bf16 values, each box 8 KB
MATMUL_BOXES = {"w": (128, 64, 128), "y": (64, 64, 128)}
# the row-8/9/10 maps by (operand, `tensor_map_key`), emptied at the cap
_MAPS: dict = {}
_MAPS_CAP = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_MATMUL_ARGTYPES = [_P] * 4 + [_I] * 5 + [_P]
_MATMUL_PARTIAL_ARGTYPES = [_P] * 5 + [_I] * 5 + [_P]
_MLP_SM90_ARGTYPES = [_P] * 10 + [_I] * 5 + [_P]
_MLP_SM90_DROP_ARGTYPES = [_P] * 11 + [_I] * 6 + [ctypes.c_float, _P]
_ENCODE_ARGTYPES = [_P, _P] + [_I] * 5


def quantize_weights(w: torch.Tensor, absmax: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 codes of w (N, K): sw =
    max(absmax, 1e-8) / 127 and qw = round(w / sw), clipped to +-127, both
    divisions as in JAX's `quantize_weights`. `absmax` (N,), where given,
    replaces each channel's own (a row-parallel share's: the max over the
    whole K). Returns (qw int8 (N, K), sw fp32 (N,))."""
    w = w.float()
    if absmax is None:
        absmax = w.abs().amax(1)
    sw = divide_by_127(absmax.clamp_min(_EPS))
    qw = torch.round(w / sw[:, None]).clamp(-127, 127)
    return qw.to(torch.int8), sw


def divide_by_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as an IEEE division on every device. The divisor is a tensor
    filled on t's device: CUDA turns a division by a host scalar into a
    product with its reciprocal, which can move a bit, and a tensor made on
    the host would cost a copy to the card on every call."""
    return t / torch.full_like(t, 127.0)


def row_quant(t: torch.Tensor, absmax: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """`_row_quant` of fp32 t (M, K): per row, s = max(absmax, 1e-8) *
    (1/127) and codes round(t * (1/s)) (half to even, as jnp.round), clipped
    to +-127. `absmax` (M,), where given, replaces each row's own (a share's
    row: the max over the whole row). Returns (int8 (M, K), fp32 (M, 1))."""
    amax = t.abs().amax(1, keepdim=True) if absmax is None else absmax.reshape(-1, 1)
    scale = amax.clamp_min(_EPS) * (1.0 / 127.0)
    q = torch.round(t * torch.reciprocal(scale)).clamp(-127, 127)
    return q.to(torch.int8), scale


def int8_product(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """qa (M, K) . qb (N, K)^T of int8 codes, summed exactly in float64 and
    rounded to fp32 as an int32 sum converts."""
    return (qa.double() @ qb.double().T).float()


def w8a8_matmul_plain(x, qw, sw):
    """x (M, K) -> (M, N) in x's dtype: x's rows quantized with their own
    scales, the exact int8 product with qw (N, K), then (acc * sx) * sw."""
    qx, sx = row_quant(x.float())
    return (int8_product(qx, qw) * sx * sw).to(x.dtype)


def w8a8_matmul_partial_plain(x, qw, sw, amax):
    """Row 8's partial mode on a row-parallel share: x (M, K) with its rows
    quantized at `amax` (M,), their absmax over the whole K, the exact int8
    product with the share's qw (N, K), and (acc * sx) * sw in fp32,
    unrounded (the ranks' partial sums add in fp32)."""
    qx, sx = row_quant(x.float(), amax)
    return int8_product(qx, qw) * sx * sw


def _mlp_hidden(x, qw1, sw1, b1, bits, threshold):
    """The int8 MLP's fp32 hidden (M, H), after the dropout where `bits`."""
    qx, sx = row_quant(x.float())
    h = gelu_tanh(int8_product(qx, qw1) * sx * sw1 + b1)
    if bits is not None:
        scale = torch.tensor(keep_scale16(threshold), dtype=torch.float32,
                             device=x.device)
        h = torch.where(keep16(bits, threshold), h * scale, torch.zeros_like(h))
    return h


def _mlp_plain(x, qw1, sw1, b1, qw2, sw2, b2, bits, threshold):
    qh, sh = row_quant(_mlp_hidden(x, qw1, sw1, b1, bits, threshold))
    return (int8_product(qh, qw2) * sh * sw2 + b2).to(x.dtype)


def w8a8_mlp_amax_plain(x, qw1, sw1, b1, bits=None, threshold: int = 0):
    """The split mode's first launch: each row's absmax (M,) of the hidden
    over this share's columns qw1 (H/T, K), after the dropout where
    `bits`."""
    return _mlp_hidden(x, qw1, sw1, b1, bits, threshold).abs().amax(1)


def w8a8_mlp_partial_plain(x, qw1, sw1, b1, qw2, sw2, amax, bits=None, threshold: int = 0):
    """The split mode's second launch: the share's hidden quantized at the
    rows' absmax `amax` over the whole hidden, the int8 product with qw2's
    share (N, H/T), and (acc * sh) * sw2 in fp32, without b2, unrounded."""
    qh, sh = row_quant(_mlp_hidden(x, qw1, sw1, b1, bits, threshold), amax)
    return int8_product(qh, qw2) * sh * sw2


def w8a8_mlp_fwd_plain(x, qw1, sw1, b1, qw2, sw2, b2):
    """`_mlp_kernel`: x (M, K) row-quantized, int8 product with qw1 (H, K),
    h = (acc * sx) * sw1 + b1 in fp32, tanh gelu, h row-quantized over all H
    columns, int8 product with qw2 (N, H), (acc * sh) * sw2 + b2, in x's
    dtype."""
    return _mlp_plain(x, qw1, sw1, b1, qw2, sw2, b2, None, 0)


def w8a8_mlp_fwd_drop_plain(x, qw1, sw1, b1, qw2, sw2, b2, bits, threshold: int):
    """`_mlp_dropout_kernel`: `w8a8_mlp_fwd_plain` with the hidden dropped
    after the gelu and before its row quantization, in fp32: kept where the
    uint16 bits (M, H), stored as `stochastic.bits16` stores them, are >= t,
    and scaled by 65536 / (65536 - t)."""
    return _mlp_plain(x, qw1, sw1, b1, qw2, sw2, b2, bits, threshold)


def _require(name: str, ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"{name}: {what}")


def _on_one_device(x, tensors) -> bool:
    return all(t.is_contiguous() and t.device == x.device and t.data_ptr() % 16 == 0
               for t in tensors)


def matmul_grid(m: int, n: int, sms: int) -> tuple[int, int, int]:
    """The row-8 kernel's grid for y (M, N) on `sms` SMs: (CTAs along M, the
    128-row blocks; CTAs along N; output tiles per CTA along N). The tiles
    are split while the row blocks leave SMs idle, as evenly as whole tiles
    allow."""
    grid_x = -(-m // MATMUL_ROW_TILE)
    tiles = -(-n // MATMUL_COL_TILE)  # a last tile of 64 columns where N % 128 == 64
    per = -(-tiles // max(1, min(tiles, sms // grid_x)))
    return grid_x, -(-tiles // per), per


def matmul_map_extents(rows: int, cols: int, operand: str):
    """The 2D tensor map of the row-8 kernel's row-major (rows, cols)
    operand "w" (qw's int8 codes) or "y" (the bf16 output): dims innermost
    first (cols, rows) in elements, the row stride in bytes, the box
    (elements a row, rows) and the swizzle in bytes."""
    box_cols, box_rows, swizzle = MATMUL_BOXES[operand]
    elem = 1 if operand == "w" else 2
    return (cols, rows), (cols * elem,), (box_cols, box_rows), swizzle


def matmul_layout(k: int) -> tuple[int, int]:
    """The row-8 layout at input width k: (its widest K, its ring stages)."""
    widest = min(w for w in MATMUL_LAYOUTS if k <= w)
    return widest, MATMUL_LAYOUTS[widest]


def matmul_smem(k: int = 768) -> int:
    """The row-8 kernel's dynamic shared memory at input width k (that of
    its layout)."""
    box = MLP_BOX_BYTES
    widest, stages = matmul_layout(k)
    x_codes = MATMUL_ROW_TILE * widest
    ring = stages * 2 * box
    return x_codes + ring + 4 * box + 4 * MATMUL_ROW_TILE + 8 * 2 * stages + 1024


def _cached_map(source: str, argtypes: list, key: tuple, *args):
    """The tensor map under `key`, encoded on a miss into a 128-byte buffer
    by `source`'s encoder (`<source>_encode`, taking `argtypes`) from
    `args`; the cache empties itself at the cap."""
    buf = _MAPS.get(key)
    if buf is None:
        if len(_MAPS) >= _MAPS_CAP:
            _MAPS.clear()
        buf = ctypes.create_string_buffer(128)
        fn = _build.load(source, argtypes, f"{source}_encode")
        _build.check(f"{source}_encode", fn(ctypes.addressof(buf), *args))
        _MAPS[key] = buf
    return buf


def _matmul_map(t: torch.Tensor, operand: str):
    """The cached tensor map of `t` as the row-8 kernel's `operand` ("w" or
    "y")."""
    (cols, rows), _, (box_cols, box_rows), _ = matmul_map_extents(t.shape[0], t.shape[1],
                                                                    operand)
    return _cached_map("w8a8_matmul_sm90", _ENCODE_ARGTYPES,
                       ("matmul_" + operand, *tensor_map_key(t)), t.data_ptr(), rows, cols,
                       box_cols, box_rows, t.element_size())


def matmul_width_ok(k: int, n: int) -> bool:
    """Whether row 8 takes x (M, k) and qw (n, k)."""
    return MATMUL_K_MIN <= k <= MATMUL_K_MAX and k % 64 == 0 and n > 0 and n % 64 == 0


def _check_matmul(name, x, qw, sw, amax=None):
    m, k = x.shape
    n = qw.shape[0]
    tensors = (x, qw, sw) + (() if amax is None else (amax,))
    _require(name,
             x.dtype == torch.bfloat16 and qw.dtype == torch.int8
             and sw.dtype == torch.float32 and matmul_width_ok(k, n) and qw.shape == (n, k)
             and sw.shape == (n,) and _on_one_device(x, tensors)
             and (amax is None or (amax.dtype == torch.float32 and amax.shape == (m,))),
             f"needs contiguous, 16-byte aligned bf16 x (M, K), int8 qw (N, K) with K % 64 "
             f"== 0 in [{MATMUL_K_MIN}, {MATMUL_K_MAX}] and N % 64 == 0, fp32 sw (N,)"
             + ("" if amax is None else ", fp32 amax (M,)")
             + f" on one device; got x {tuple(x.shape)} {x.dtype}, qw {tuple(qw.shape)} "
             f"{qw.dtype}, sw {tuple(sw.shape)} {sw.dtype}"
             + ("" if amax is None else f", amax {tuple(amax.shape)} {amax.dtype}"))
    return m, n, k


def w8a8_matmul(x, qw, sw):
    """As `w8a8_matmul_plain`: the row-8 kernel on CUDA tensors (bf16 x
    (M, K), int8 qw (N, K) with K % 64 == 0 in [192, 1024] and N % 64 ==
    0, fp32 sw (N,)), the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, qw, sw)
    m, n, k = _check_matmul("w8a8_matmul", x, qw, sw)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    # the buffers themselves, not their addresses: the list keeps each one
    # alive through the call even if a later lookup empties the cache
    maps = [_matmul_map(qw, "w"), _matmul_map(y, "y")]
    grid_x, _, per = matmul_grid(m, n, _sm_count(x.device))
    fn = _build.load("w8a8_matmul_sm90", _MATMUL_ARGTYPES)
    rc = fn(*maps, x.data_ptr(), sw.data_ptr(), m, n, k, grid_x, per,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("w8a8_matmul_sm90", rc)
    w8a8_matmul.launches += 1
    return y


def w8a8_matmul_partial(x, qw, sw, amax):
    """As `w8a8_matmul_partial_plain`: row 8's partial mode on CUDA tensors
    (bf16 x (M, K), int8 qw (N, K), fp32 sw (N,) and amax (M,); the widths
    of `w8a8_matmul`), storing fp32 y (M, N) from its registers; the plain
    version on CPU tensors."""
    if x.device.type == "cpu":
        return w8a8_matmul_partial_plain(x, qw, sw, amax)
    m, n, k = _check_matmul("w8a8_matmul_partial", x, qw, sw, amax)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    maps = [_matmul_map(qw, "w")]
    grid_x, _, per = matmul_grid(m, n, _sm_count(x.device))
    fn = _build.load("w8a8_matmul_sm90", _MATMUL_PARTIAL_ARGTYPES, "w8a8_matmul_sm90_partial")
    rc = fn(*maps, x.data_ptr(), sw.data_ptr(), amax.data_ptr(), y.data_ptr(), m, n, k,
            grid_x, per, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("w8a8_matmul_sm90_partial", rc)
    w8a8_matmul_partial.launches += 1
    return y


def _check_mlp(name, x, qw1, sw1, b1, qw2, sw2, b2, bits=None):
    m, k = x.shape
    hdim = qw1.shape[0]
    tensors = (x, qw1, sw1, b1, qw2, sw2, b2) + (() if bits is None else (bits,))
    tensors = tuple(t for t in tensors if t is not None)
    _require(name,
             x.dtype == torch.bfloat16 and qw1.dtype == qw2.dtype == torch.int8
             and sw1.dtype == sw2.dtype == b1.dtype == torch.float32
             and (b2 is None or (b2.dtype == torch.float32 and b2.shape == (k,)))
             and k in MLP_WIDTHS and qw1.shape == (hdim, k) and hdim % HIDDEN_CHUNK == 0
             and qw2.shape == (k, hdim) and sw1.shape == b1.shape == (hdim,)
             and sw2.shape == (k,)
             and (bits is None or (bits.dtype == torch.int16 and bits.shape == (m, hdim)))
             and _on_one_device(x, tensors),
             f"needs contiguous, 16-byte aligned bf16 x (M, K) with K in {MLP_WIDTHS}, int8 "
             f"qw1 (H, K) with H % {HIDDEN_CHUNK} == 0, int8 qw2 (K, H), fp32 scales and "
             f"biases (and int16 bits (M, H)) on one device; got x "
             f"{tuple(x.shape)} {x.dtype}, qw1 {tuple(qw1.shape)} {qw1.dtype}, qw2 "
             f"{tuple(qw2.shape)} {qw2.dtype}"
             + ("" if bits is None else f", bits {tuple(bits.shape)} {bits.dtype}"))
    return m, k, hdim


def mlp_splits(m: int, hdim: int, sms: int) -> int:
    """How many CTAs share a row tile's hidden in the row-9 kernel: 2 (a
    cluster of two, each with half the 64-column chunks, their int32 sums
    added in a second pass) while the doubled tiles fit one wave of `sms`
    and the chunks halve, else 1."""
    tiles = -(-m // MLP_ROW_TILE)
    return 2 if 2 * tiles <= sms and (hdim // HIDDEN_CHUNK) % 2 == 0 else 1


def mlp_grid(m: int, splits: int = 1) -> int:
    """The row-9 kernel's CTAs along M for M rows: the 64-row tiles, rounded
    up to whole clusters of 2 where the cluster runs along M (splits 1; a
    spare CTA stores nothing); the grid has `splits` CTAs along y."""
    tiles = -(-m // MLP_ROW_TILE)
    return tiles + -tiles % MLP_CLUSTER if splits == 1 else tiles


def mlp_map_extents(rows: int, cols: int, operand: str):
    """The 2D tensor map of a row-major (rows, cols) matrix of bytes for the
    row-9/10 kernel, `operand` "w1" (qW1), "w2" (qW2) or "bits" (the int16
    dropout bits, cols = 2 H bytes): dims innermost first (cols, rows), the
    row stride in bytes, the box (bytes a row, rows) and the swizzle in
    bytes."""
    box_cols, box_rows, swizzle = MLP_BOXES[operand]
    return (cols, rows), (cols,), (box_cols, box_rows), swizzle


def mlp_layout(k: int) -> dict:
    """The row-9 kernel's layout at width K = N = k, as the source's
    `layout`: x's code tiles (`xt`, a W1 stage's boxes), the parts the
    second product runs in, the 128-column pieces of a part (`pc`, a W2
    stage's boxes), the pieces a consumer warpgroup takes (`pw`) and the
    boxes a ring stage holds (`sb`)."""
    xt = -(-k // 128)
    parts = 2 if k > MLP_PART_MAX else 1
    pc = -(-(k // parts) // 128)
    pw = -(-pc // 2)
    return {"xt": xt, "parts": parts, "pc": pc, "pw": pw, "sb": max(xt, 2 * pw)}


def mlp_smem(drop: bool = False, k: int = 768) -> int:
    """The row-9 kernel's dynamic shared memory at width k; with `drop`,
    that of its DROP variant (row 10), with the two bits slots."""
    box = MLP_BOX_BYTES
    layout = mlp_layout(k)
    before_bars = (layout["xt"] * box + MLP_RING_STAGES * layout["sb"] * box + 2 * box
                   + 4 * MLP_ROW_TILE * 4)
    bars = 2 * MLP_RING_STAGES + 1 + 2 * MLP_BITS_SLOTS
    bits_off = -(-(before_bars + 8 * bars) // 1024) * 1024
    return bits_off + (MLP_BITS_SLOTS * box if drop else 0) + 1024


def _mlp_map(t: torch.Tensor, operand: str):
    """The cached tensor map of `t` as `operand` ("w1" or "w2": int8 codes;
    "bits": the int16 bits, as bytes)."""
    (cols, rows), _, (box_cols, box_rows), swizzle = mlp_map_extents(
        t.shape[0], t.shape[1] * t.element_size(), operand)
    return _cached_map("w8a8_mlp_sm90", _ENCODE_ARGTYPES, (operand, *tensor_map_key(t)),
                       t.data_ptr(), rows, cols, box_cols, box_rows, swizzle)


def _launch_mlp_sm90(x, qw1, sw1, b1, qw2, sw2, b2, bits=None, threshold: int = 0):
    """Check the inputs and run the row-9 kernel, or with `bits` its DROP
    variant (row 10): the weight (and bits) maps from the cache, the hidden
    split of `mlp_splits` with its scratch, the grid of `mlp_grid`."""
    name = "w8a8_mlp_fwd" if bits is None else "w8a8_mlp_fwd_drop"
    m, k, hdim = _check_mlp(name, x, qw1, sw1, b1, qw2, sw2, b2, bits)
    if bits is not None:
        _require(name, 0 < threshold < 65536, f"threshold {threshold} not in (0, 65536)")
    dev = x.device
    y = torch.empty((m, k), dtype=x.dtype, device=dev)
    splits = mlp_splits(m, hdim, _sm_count(dev))
    part = shs = None
    if splits > 1:
        part = torch.empty((splits, m, k), dtype=torch.int32, device=dev)
        shs = torch.empty((m,), dtype=torch.float32, device=dev)
    # the buffers themselves, not their addresses: the list keeps each one
    # alive through the call even if a later lookup empties the cache
    maps = [_mlp_map(qw1, "w1"), _mlp_map(qw2, "w2")]
    args = (x.data_ptr(), sw1.data_ptr(), b1.data_ptr(), sw2.data_ptr(), b2.data_ptr(),
            y.data_ptr(), None if part is None else part.data_ptr(),
            None if shs is None else shs.data_ptr(), m, k, hdim, mlp_grid(m, splits), splits)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if bits is None:
        rc = _build.load("w8a8_mlp_sm90", _MLP_SM90_ARGTYPES)(*maps, *args, stream)
    else:
        maps.append(_mlp_map(bits, "bits"))
        fn = _build.load("w8a8_mlp_sm90", _MLP_SM90_DROP_ARGTYPES, "w8a8_mlp_sm90_drop")
        rc = fn(*maps, *args, threshold, keep_scale16(threshold), stream)
    _build.check(name, rc)
    return y


def _launch_mlp_split(x, qw1, sw1, b1, qw2, sw2, reduce_max, bits=None, threshold: int = 0):
    """Check the inputs and run rows 9/10's split mode: the first pass
    (`w8a8_mlp_sm90_amax`, each row's absmax of this share's hidden),
    `reduce_max` of it in place (the all-reduce-max over the tensor group),
    then the second pass (`w8a8_mlp_sm90_partial`) at the rows' global
    scales into an fp32 y without b2; the hidden split of `mlp_splits`
    with its scratch, the grid of `mlp_grid`, in both."""
    name = "w8a8_mlp_fwd_split" if bits is None else "w8a8_mlp_fwd_drop_split"
    m, k, hdim = _check_mlp(name, x, qw1, sw1, b1, qw2, sw2, None, bits)
    if bits is not None:
        _require(name, 0 < threshold < 65536, f"threshold {threshold} not in (0, 65536)")
    dev = x.device
    amax = torch.empty((m,), dtype=torch.float32, device=dev)
    y = torch.empty((m, k), dtype=torch.float32, device=dev)
    splits = mlp_splits(m, hdim, _sm_count(dev))
    part = shs = None
    if splits > 1:
        part = torch.empty((splits, m, k), dtype=torch.int32, device=dev)
        shs = torch.empty((m,), dtype=torch.float32, device=dev)
    maps = [_mlp_map(qw1, "w1"), _mlp_map(qw2, "w2")]
    if bits is not None:
        maps.append(_mlp_map(bits, "bits"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    grid = mlp_grid(m, splits)
    scratch = (None if part is None else part.data_ptr(),
               None if shs is None else shs.data_ptr())
    drop = () if bits is None else (threshold, keep_scale16(threshold))
    # the whole kernel's arguments, the absmax where b2 was
    types = _MLP_SM90_ARGTYPES if bits is None else _MLP_SM90_DROP_ARGTYPES
    suffix = "" if bits is None else "_drop"
    for mode in ("amax", "partial"):
        if mode == "partial":
            reduce_max(amax)
        fn = _build.load("w8a8_mlp_sm90", types, f"w8a8_mlp_sm90_{mode}{suffix}")
        rc = fn(*maps, x.data_ptr(), sw1.data_ptr(), b1.data_ptr(), sw2.data_ptr(),
                amax.data_ptr(), y.data_ptr(), *scratch, m, k, hdim, grid, splits, *drop, stream)
        _build.check(f"w8a8_mlp_sm90_{mode}{suffix}", rc)
    return y


def w8a8_mlp_fwd_split(x, qw1, sw1, b1, qw2, sw2, reduce_max):
    """Row 9's split mode on a tensor rank's hidden share (bf16 x (M, K),
    qw1 (H/T, K), qw2 (K, H/T), the fp32 scales and b1; K in MLP_WIDTHS):
    the fp32 partial output (M, K) without b2, each row of h quantized at its
    absmax over the whole hidden (`reduce_max` makes the share's whole).
    Two kernel launches on CUDA tensors (one call counted); the plain
    versions on CPU tensors."""
    if x.device.type == "cpu":
        amax = reduce_max(w8a8_mlp_amax_plain(x, qw1, sw1, b1))
        return w8a8_mlp_partial_plain(x, qw1, sw1, b1, qw2, sw2, amax)
    y = _launch_mlp_split(x, qw1, sw1, b1, qw2, sw2, reduce_max)
    w8a8_mlp_fwd_split.launches += 1
    return y


def w8a8_mlp_fwd_drop_split(x, qw1, sw1, b1, qw2, sw2, bits, threshold: int, reduce_max):
    """Row 10's split mode: `w8a8_mlp_fwd_split` with the hidden dropout of
    this share's columns of the whole bits (int16 (M, H/T))."""
    if x.device.type == "cpu":
        amax = reduce_max(w8a8_mlp_amax_plain(x, qw1, sw1, b1, bits, threshold))
        return w8a8_mlp_partial_plain(x, qw1, sw1, b1, qw2, sw2, amax, bits, threshold)
    y = _launch_mlp_split(x, qw1, sw1, b1, qw2, sw2, reduce_max, bits, threshold)
    w8a8_mlp_fwd_drop_split.launches += 1
    return y


def w8a8_mlp_fwd(x, qw1, sw1, b1, qw2, sw2, b2):
    """As `w8a8_mlp_fwd_plain`: the row-9 kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if x.device.type == "cpu":
        return w8a8_mlp_fwd_plain(x, qw1, sw1, b1, qw2, sw2, b2)
    y = _launch_mlp_sm90(x, qw1, sw1, b1, qw2, sw2, b2)
    w8a8_mlp_fwd.launches += 1
    return y


def w8a8_mlp_fwd_drop(x, qw1, sw1, b1, qw2, sw2, b2, bits, threshold: int):
    """As `w8a8_mlp_fwd_drop_plain`: the row-9 kernel's DROP variant on
    CUDA tensors (bits int16 (M, H)), the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return w8a8_mlp_fwd_drop_plain(x, qw1, sw1, b1, qw2, sw2, b2, bits, threshold)
    y = _launch_mlp_sm90(x, qw1, sw1, b1, qw2, sw2, b2, bits, threshold)
    w8a8_mlp_fwd_drop.launches += 1
    return y


w8a8_matmul.launches = 0
w8a8_matmul_partial.launches = 0
w8a8_mlp_fwd.launches = 0
w8a8_mlp_fwd_drop.launches = 0
w8a8_mlp_fwd_split.launches = 0
w8a8_mlp_fwd_drop_split.launches = 0


class _PallasQuantDot(torch.autograd.Function):
    """`pallas_quant_dot`: the row-8 forward on the weight's codes, and the
    STE backward of `_pqd_bwd`, the unquantized product's gradients: dx =
    g . w in x's dtype, dw = g^T . x in w's dtype."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return w8a8_matmul(x2, *quantize_weights(w))

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        return _ste_backward(g, x2, w)


def pallas_quant_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) . w^T for w (N, K) in nn.Linear's layout, with the fused
    W8A8 forward (per-row activation scales) and the STE backward."""
    *lead, k = x.shape
    y = _PallasQuantDot.apply(x.reshape(-1, k).contiguous(), w)
    return y.reshape(*lead, w.shape[0])


def _ste_backward(g, x2, w):
    """`_pqd_bwd`: dx = g . w in x's dtype, dw = g^T . x in w's dtype."""
    return (g @ w.to(g.dtype)).to(x2.dtype), (g.T @ x2.to(g.dtype)).to(w.dtype)


class _PallasQuantDotPartial(torch.autograd.Function):
    """`_PallasQuantDot` on a row-parallel share (x2 (M, K/T), w (N, K/T)):
    each row's absmax of x2 and each channel's of w maxed over the tensor
    group (one all-reduce), the share's codes at those scales, row 8's
    partial mode. The backward is the whole one's on the share (the fp32
    gradient taken in x's dtype, as the whole call's output is)."""

    @staticmethod
    def forward(ctx, x2, w, tensor):
        m = x2.shape[0]
        amax = tensor.max_(torch.cat([x2.float().abs().amax(1), w.float().abs().amax(1)]))
        qw, sw = quantize_weights(w, amax[m:])
        ctx.save_for_backward(x2, w)
        return w8a8_matmul_partial(x2, qw, sw, amax[:m].contiguous())

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        return (*_ste_backward(g.to(x2.dtype), x2, w), None)


def pallas_quant_dot_partial(x: torch.Tensor, w: torch.Tensor, tensor) -> torch.Tensor:
    """This tensor rank's fp32 partial sum of `pallas_quant_dot(x, w)` for
    a row-parallel share: x (..., K/T) and w (N, K/T) its columns."""
    *lead, k = x.shape
    y = _PallasQuantDotPartial.apply(x.reshape(-1, k).contiguous(), w, tensor)
    return y.reshape(*lead, w.shape[0])


class _W8A8Mlp(torch.autograd.Function):
    """`fused_w8a8_mlp` (bits None) and `fused_w8a8_mlp_dropout`: rows 9/10
    on the fp32 weights' codes forward, and the STE backward of
    `_mlp_vjp_bwd` / `_mlpd_vjp_bwd`: the hidden recomputed in x's dtype
    from the unquantized weights, with the *erf* gelu's VJP although the
    forward takes tanh, as the JAX package does."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, bits, threshold, tensor):
        qw1, sw1 = quantize_weights(w1)
        ctx.save_for_backward(x2, w1, b1, w2, bits)
        ctx.threshold = threshold
        ctx.b2_dtype = None if b2 is None else b2.dtype
        if tensor is not None:
            # the split mode: W2's channels maxed over the whole hidden, and
            # h's rows over it inside the call
            qw2, sw2 = quantize_weights(w2, tensor.max_(w2.float().abs().amax(1)))
            args = (x2, qw1, sw1, b1.float().contiguous(), qw2, sw2)
            return (w8a8_mlp_fwd_split(*args, tensor.max_) if bits is None
                    else w8a8_mlp_fwd_drop_split(*args, bits, threshold, tensor.max_))
        qw2, sw2 = quantize_weights(w2)
        args = (x2, qw1, sw1, b1.float().contiguous(), qw2, sw2, b2.float().contiguous())
        return w8a8_mlp_fwd(*args) if bits is None else w8a8_mlp_fwd_drop(
            *args, bits, threshold)

    @staticmethod
    def backward(ctx, g):
        x2, w1, b1, w2, bits = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = mlp_backward(g, x2, w1, b1, w2, bits, ctx.threshold,
                                              ctx.b2_dtype or torch.float32,
                                              approximate="none")
        return dx, dw1, db1, dw2, None if ctx.b2_dtype is None else db2, None, None, None


def w8a8_mlp(x, w1, b1, w2, b2, bits=None, threshold: int = 0, tensor=None):
    """tanh-gelu(x . w1^T + b1) [hidden dropout] . w2^T + b2 over the last
    axis of x with both products on int8 codes (rows 9 and 10),
    differentiable in x, w1, b1, w2 and b2 (STE). The weights are quantized
    as given: JAX's int8 MLP quantizes its fp32 parameters. With `bits`
    (x.shape[:-1] + (hidden,), as `stochastic.bits16` draws them) the hidden
    is dropped where bits < `threshold`. With a `tensor` axis (and b2
    None), the split mode on this rank's hidden share (w1's rows, w2's
    columns, the bits' columns): the fp32 partial output without b2, every
    code and scale the whole call's; its backward is the whole one's but
    db2 (dx is this share's)."""
    *lead, k = x.shape
    x2 = x.reshape(-1, k).contiguous()
    if bits is not None:
        bits = bits.reshape(x2.shape[0], -1).contiguous()
    y = _W8A8Mlp.apply(x2, w1, b1, w2, b2, bits, threshold, tensor)
    return y.reshape(*lead, w2.shape[0])
