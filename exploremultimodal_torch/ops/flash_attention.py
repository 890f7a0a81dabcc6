"""Flash attention: the CUDA kernels' wrappers, their plain versions, and the
differentiable `flash_attention`.

Counterpart of `exploremultimodal_tpu/ops/flash_attention.py`:
  - `flash_attention_fwd`      `_fwd_call` / `_attn_kernel`
  - `flash_attention_fwd_drop` `_fwd_drop_call` / `_attn_drop_kernel`
  - `flash_attention_bwd`      `_bwd_call` / `_attn_bwd_kernel`
  - `flash_attention_bwd_drop` `_bwd_drop_call` / `_attn_drop_bwd_kernel`
  - `flash_attention_fwd_long` `_long_fwd_call` / `_attn_long_kernel`
Rows 1 and 3 (the forward without and with dropout) share
`csrc/flash_attention_fwd_sm90.cu` (wgmma and TMA, N <= SM90_FWD_MAX_N, row
3 its `DROP` variant) and, past SM90_FWD_MAX_N, the streamed kernel of
`csrc/flash_attention_long_sm90.cu` (wgmma and TMA; its `LSE` and `LSE` +
`DROP` variants), which also runs the long forward (row 5) without an lse.
Rows 2 and 4 (the backward without and with dropout) share
`csrc/flash_attention_bwd_sm90.cu` (wgmma and TMA, every N the fused
backward takes, row 4 its `DROP` variant). Each wrapper runs its kernel on
CUDA tensors and its plain PyTorch version on CPU tensors; there is no
other fallback.
The kernels work on the unpadded N: the JAX kernels pad N to 128, but rows
and columns keep their indices, so the dropout mask at every real (row,
col) is the same. Each kernel takes the presets' head dims, `HEAD_DIMS`:
64 (rows of 128 bytes in the 128-byte swizzle) and vlmo_debug's 32 (rows of
64 bytes in the 64-byte swizzle), one instantiation each; the host's
layout mirrors below take the head dim `d`.
"""

from __future__ import annotations

import ctypes

import torch

from exploremultimodal_torch.ops import _build
from exploremultimodal_torch.ops.mlp_fused import SMEM_LIMIT, _sm_count, tensor_map_key

HEAD_DIMS = (32, 64)  # the head dims the kernels take: vlmo_debug's, and every other preset's
# the fused backward (and so in-kernel dropout) covers N up to this; longer
# sequences take the forward kernel and a backward through the plain chain
LONG_SEQ_THRESHOLD = 512
# ... and past this padded N the forward is the long kernel (JAX: the
# full-row forward holds a (128, N) score tile in VMEM up to here)
FULL_ROW_FWD_MAX = 4096
# the streamed kernel's tiling: work items of 128 query rows, keys in
# 128-row blocks through a ring of LONG_STAGES stages, LONG_Q_SLOTS items'
# Q in flight (csrc/flash_attention_long_sm90.cu)
LONG_TILE = 128
LONG_STAGES = 3
LONG_Q_SLOTS = 2
# the forward's route, with and without dropout: up to this N the short
# sm90 kernel, which holds a head's whole K and V in shared memory
# (csrc/flash_attention_fwd_sm90.cu); past it the streamed kernel, which
# takes K and V in 128-key blocks (csrc/flash_attention_long_sm90.cu, its
# lse variants): up to FULL_ROW_FWD_MAX (or LONG_SEQ_THRESHOLD with
# dropout) for rows 1 and 3, past it for row 5
SM90_FWD_MAX_N = 256
# the sm90 forward's layout, as its source sets it: key widths in steps of
# 16 (its wgmma N), keys and query rows in 64-row TMA boxes and tiles, up to
# 4 heads in flight per CTA, each slot a head's Q, K and V (2 d bytes a row)
# and its fp32 bias row, then a full and an empty barrier per slot and 1024
# bytes of alignment slack
SM90_FWD_WIDTH_STEP = 16
SM90_FWD_BOX = 64
SM90_FWD_MAX_SLOTS = 4
# the backward, with and without dropout, runs the sm90 kernels, which hold
# a work unit's B-side pair in shared memory (csrc/flash_attention_bwd_sm90.cu),
# at every N up to this, the fused backward's reach
SM90_BWD_MAX_N = LONG_SEQ_THRESHOLD
# the sm90 backward's two kernels (roles): "dq" keeps queries as M and
# loads K and V per head, Q, dO and O per 64-row tile; "dkdv" keeps keys as
# M and loads Q and dO per head (with lse and delta), K and V per tile
SM90_BWD_ROLES = {"dq": (1, 3), "dkdv": (2, 2)}  # (column vectors, tile boxes)
_BAR_BYTES = 8 * 4 * SM90_FWD_MAX_SLOTS
# q/k/v tensor maps of the sm90 kernels by (kernel, `tensor_map_key`),
# emptied at the cap
_MAPS: dict = {}
_MAPS_CAP = 256
PAD_MULTIPLE = 128  # JAX pads N to its query block, BLOCK_Q; the routes read the padded N

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each forward's one entry: maps, bias, seed (null without dropout), row
# index (null: each row's own), out, lse (null for row 5), shape ints (bh,
# heads, the heads' total and first index, ...), then scale, threshold,
# factor, head dim, stream
_FWD_LONG_ARGS = [_P] * 8 + [_I] * 7 + [_F, ctypes.c_uint32, _F, _I, _P]
_FWD_SM90_ARGS = [_P] * 8 + [_I] * 7 + [_F, ctypes.c_uint32, _F, _I, _P]
_ENCODE_ARGS = [_P, _P, _I, _P, _P, _P]
_BWD_SM90_ARGS = [_P] * 13 + [_I] * 8 + [_F, ctypes.c_uint32, _F, _I, _P]


# ------------------------------------------------------------- dropout hash


def dropout_threshold(rate: float) -> int:
    """Keep where the uint32 hash bits are >= this (`_keep_mask`)."""
    return min(int(rate * 2**32), 2**32 - 1)


def dropout_scale(rate: float) -> float:
    """The inverted-dropout factor, rounded to fp32 as the kernels use it."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & 0xFFFFFFFF


def dropout_heads(bh: int, row_index: torch.Tensor | None, device: torch.device,
                  batch: int | None = None, heads_total: int | None = None,
                  head0: int = 0) -> torch.Tensor:
    """(bh,) int64: the batch*head that keys each head's mask
    (`dropout_head` in csrc/dropout_hash.cuh). The call's bh heads are B
    rows of H = bh // B heads (B: `row_index`'s length, else `batch`); its
    head h of row b keys (row_index[b] or b) * heads_total + head0 + h, the
    head's index in JAX's global batch: `row_index` ((B,) int32) gives each
    row's index in the global batch, `heads_total` (default H) and `head0`
    (default 0) the heads a rank holds under tensor parallelism, head0 ..
    head0 + H - 1 of each row's heads_total. By default each head's own
    index bh."""
    b = torch.arange(bh, dtype=torch.int64, device=device)
    if row_index is None and heads_total is None:
        return b
    heads = bh // (batch if row_index is None else row_index.numel())
    rows = b // heads
    if row_index is not None:
        rows = row_index.to(device=device, dtype=torch.int64)[rows]
    return rows * (heads if heads_total is None else heads_total) + head0 + b % heads


def dropout_keep_mask_plain(seed: torch.Tensor, bh: int, n: int, rate: float,
                            row_index: torch.Tensor | None = None, batch: int | None = None,
                            heads_total: int | None = None, head0: int = 0) -> torch.Tensor:
    """(bh, n, n) fp32 of {0, 1/(1-rate)}: the keep mask the dropout kernels
    make inside, for the int32 `seed` (one element, on the result's
    device) and the heads of `dropout_heads(bh, row_index, batch=batch,
    heads_total=heads_total, head0=head0)`. The uint32 hash of
    `_dropout_bits`/`_dropout_keys` is emulated in int64 masked to 32
    bits."""
    dev = seed.device
    s = seed.reshape(()).to(torch.int64) & 0xFFFFFFFF
    b = dropout_heads(bh, row_index, dev, batch, heads_total, head0).view(bh, 1, 1)
    key0 = (s ^ _mul32(b, 0x9E3779B9)) | 1
    key1 = _mul32(s, 0x85EBCA6B) ^ ((b + 0x165667B1) & 0xFFFFFFFF)
    r = torch.arange(n, dtype=torch.int64, device=dev).view(1, n, 1)
    c = torch.arange(n, dtype=torch.int64, device=dev).view(1, 1, n)
    x = (r * 65536 + c) ^ key0
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x ^ key1
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x27D4EB2F)
    x = x ^ (x >> 15)
    keep = torch.full((), dropout_scale(rate), dtype=torch.float32, device=dev)
    return torch.where(x >= dropout_threshold(rate), keep,
                       torch.zeros((), dtype=torch.float32, device=dev))


# ------------------------------------------------------------ plain versions


def _scores(qf, kf, key_bias, scale):
    heads = qf.shape[0] // key_bias.shape[0]
    s = torch.matmul(qf.float(), kf.float().transpose(1, 2)) * scale
    return s + key_bias.float().repeat_interleave(heads, dim=0)[:, None, :]


def flash_attention_fwd_plain(qf, kf, vf, key_bias, scale: float, keep=None):
    """qf/kf/vf: (B*H, N, D); key_bias: (B, N) fp32. Returns (out in the
    input dtype, lse (B*H, N) fp32), computed as `_attn_kernel` does: fp32
    scores, bias added after scaling, max-subtracted exp, fp32 p.v / denom.
    `keep` (B*H, N, N), where given, multiplies p before the p.v product
    (`_attn_drop_kernel`); denom and lse stay clean."""
    s = _scores(qf, kf, key_bias, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    if keep is not None:
        p = p * keep
    out = torch.matmul(p, vf.float()) / denom
    return out.to(qf.dtype), (m + torch.log(denom)).squeeze(-1)


def flash_attention_fwd_long_plain(qf, kf, vf, key_bias, scale: float):
    """`_attn_long_kernel`: the output of `flash_attention_fwd_plain`, no
    lse (fp32 scores, bias after scaling, softmax, fp32 p.v / l)."""
    return flash_attention_fwd_plain(qf, kf, vf, key_bias, scale)[0]


def flash_attention_fwd_drop_plain(qf, kf, vf, key_bias, seed, scale: float,
                                   rate: float, row_index=None, heads_total=None,
                                   head0: int = 0):
    """`_attn_drop_kernel`: the forward with the hash mask of `seed` (and
    `row_index`, `heads_total` and `head0`: `dropout_keep_mask_plain`)."""
    keep = dropout_keep_mask_plain(seed, qf.shape[0], qf.shape[1], rate, row_index,
                                   key_bias.shape[0], heads_total, head0)
    return flash_attention_fwd_plain(qf, kf, vf, key_bias, scale, keep)


def flash_attention_bwd_plain(qf, kf, vf, key_bias, of, dof, lse, scale: float,
                              keep=None):
    """`_attn_bwd_kernel`: (dq, dk, dv) in the input dtype, all math fp32,
    p rebuilt from lse. `keep`, where given, is the forward's dropout mask
    (`_attn_drop_bwd_kernel`)."""
    p = torch.exp(_scores(qf, kf, key_bias, scale) - lse[..., None])
    do, q, k = dof.float(), qf.float(), kf.float()
    delta = (do * of.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(do, vf.float().transpose(1, 2))
    pd = p
    if keep is not None:
        pd, dp = p * keep, dp * keep
    dv = torch.matmul(pd.transpose(1, 2), do)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(1, 2), q) * scale
    return dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vf.dtype)


def flash_attention_bwd_drop_plain(qf, kf, vf, key_bias, seed, of, dof, lse,
                                   scale: float, rate: float, row_index=None,
                                   heads_total=None, head0: int = 0):
    """`_attn_drop_bwd_kernel`: the backward with the mask of `seed` (and
    `row_index`, `heads_total` and `head0`)."""
    keep = dropout_keep_mask_plain(seed, qf.shape[0], qf.shape[1], rate, row_index,
                                   key_bias.shape[0], heads_total, head0)
    return flash_attention_bwd_plain(qf, kf, vf, key_bias, of, dof, lse, scale,
                                     keep)


# ----------------------------------------------------------- kernel wrappers


def _check(name: str, key_bias, *tensors, lse=None, seed=None, row_index=None,
           heads_total=None, head0: int = 0) -> None:
    """Raise unless the kernels take these inputs: contiguous, 16-byte
    aligned bf16 (B*H, N, D) tensors on one device with D in HEAD_DIMS, an
    fp32 (B, N) bias, an fp32 (B*H, N) lse, an int32 one-element seed, a
    contiguous int32 (B,) row index, and heads head0 .. head0 + H - 1
    within heads_total."""
    bh, n, d = tensors[0].shape
    dev = tensors[0].device
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: the kernels take head dims {HEAD_DIMS}, got {d}")
    for t in tensors:
        if t.dtype != torch.bfloat16 or t.shape != (bh, n, d) \
                or not t.is_contiguous() or t.device != dev \
                or t.data_ptr() % 16 != 0:
            raise ValueError(
                f"{name}: q/k/v/o/do must be contiguous, 16-byte aligned bf16 "
                f"({bh}, {n}, {d}) tensors on {dev}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    b = key_bias.shape[0]
    if key_bias.dtype != torch.float32 or key_bias.shape != (b, n) \
            or not key_bias.is_contiguous() or bh % b != 0 \
            or key_bias.device != dev:
        raise ValueError(f"{name}: key_bias must be a contiguous fp32 (B, {n}) "
                         f"tensor with B dividing {bh}")
    if lse is not None and (lse.dtype != torch.float32 or lse.shape != (bh, n)
                            or not lse.is_contiguous() or lse.device != dev):
        raise ValueError(f"{name}: lse must be a contiguous fp32 ({bh}, {n}) tensor")
    if seed is not None and (seed.dtype != torch.int32 or seed.numel() != 1
                             or seed.device != dev):
        raise ValueError(f"{name}: seed must be one int32 on {dev}")
    if row_index is not None and (row_index.dtype != torch.int32 or row_index.shape != (b,)
                                  or not row_index.is_contiguous()
                                  or row_index.device != dev):
        raise ValueError(f"{name}: row_index must be a contiguous int32 ({b},) tensor "
                         f"on {dev}")
    if heads_total is not None and not 0 <= head0 <= heads_total - bh // b:
        raise ValueError(f"{name}: heads {head0}..{head0 + bh // b - 1} not within "
                         f"{heads_total}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fwd_route(n: int) -> str:
    """The forward kernel (rows 1 and 3) that takes rows of N keys: "sm90"
    (the short kernel) up to SM90_FWD_MAX_N, "sm90_stream" (the streamed
    kernel, K and V in 128-key blocks) past it."""
    return "sm90" if n <= SM90_FWD_MAX_N else "sm90_stream"


def fwd_sm90_tile(n: int) -> int:
    """The sm90 forward's key width for N keys, the wgmma N of its Q K^T:
    N rounded up to 16 (48 at N = 40, 208 at 197, 240 at 237)."""
    return -(-n // SM90_FWD_WIDTH_STEP) * SM90_FWD_WIDTH_STEP


def fwd_sm90_grid(bh: int, sms: int) -> int:
    """The sm90 forward's persistent grid: one CTA per SM, or one per head
    where there are fewer heads; CTA c takes heads c, c + grid, ..."""
    return min(bh, sms)


def fwd_sm90_map_extents(bh: int, n: int, d: int):
    """The 3D tensor map of a (BH, N, D) bf16 q, k or v for the sm90
    forward: dims innermost first (D, N, BH), the byte strides of dims 1..,
    and the box (D, 64, 1), a row of 2 D bytes (the kernel's swizzle is
    that width); a box stops at its head's N and TMA fills the rest of the
    head's slot with zeros."""
    row = 2 * d
    return (d, n, bh), (row, row * n), (d, SM90_FWD_BOX, 1)


def _slot_bytes(nt: int, d: int) -> int:
    """A slot at key width nt and head dim d: Q, K and V of the rows its
    boxes load, and the bias row."""
    rows = -(-nt // SM90_FWD_BOX) * SM90_FWD_BOX
    return 3 * rows * 2 * d + 4 * rows


def fwd_sm90_slots(nt: int, d: int) -> int:
    """Heads in flight per CTA at key width nt and head dim d: as many
    slots as fit."""
    return min(SM90_FWD_MAX_SLOTS,
               (SMEM_LIMIT - 1024 - 16 * SM90_FWD_MAX_SLOTS) // _slot_bytes(nt, d))


def fwd_sm90_smem(nt: int, d: int) -> int:
    """The sm90 forward's dynamic shared memory at key width nt and head
    dim d."""
    return fwd_sm90_slots(nt, d) * (_slot_bytes(nt, d) + 16) + 1024


def flash_attention_fwd(qf, kf, vf, key_bias, scale: float):
    """The kernel of `fwd_route` on CUDA tensors, the plain version on CPU
    tensors. Same arguments and results as `flash_attention_fwd_plain`."""
    if qf.device.type == "cpu":
        return flash_attention_fwd_plain(qf, kf, vf, key_bias, scale)
    _check("flash_attention_fwd", key_bias, qf, kf, vf)
    out, lse = _launch_fwd(qf, kf, vf, key_bias, scale)
    flash_attention_fwd.launches += 1
    return out, lse


def _launch_fwd(qf, kf, vf, key_bias, scale: float, seed=None, rate: float = 0.0,
                row_index=None, heads_total=None, head0: int = 0):
    """Run the forward of `fwd_route` on checked inputs; with a `seed`, its
    dropout variant at `rate` (row 3), its masks keyed by `row_index`,
    `heads_total` and `head0` where given. Returns (out, lse)."""
    if fwd_route(qf.shape[1]) == "sm90":
        return _launch_fwd_sm90(qf, kf, vf, key_bias, scale, seed, rate, row_index,
                                heads_total, head0)
    return _launch_stream(qf, kf, vf, key_bias, scale, seed, rate, with_lse=True,
                          row_index=row_index, heads_total=heads_total, head0=head0)


def _heads(bh: int, key_bias, heads_total, head0: int) -> tuple[int, int, int]:
    """The kernels' (heads, heads_total, head0): a call of B rows holds H =
    bh // B heads of each, by default all of the row's."""
    heads = bh // key_bias.shape[0]
    return heads, heads if heads_total is None else heads_total, head0


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _launch_fwd_sm90(qf, kf, vf, key_bias, scale: float, seed=None,
                     rate: float = 0.0, row_index=None, heads_total=None, head0: int = 0):
    """Run the short sm90 forward on checked inputs: the q/k/v maps from
    the cache, the key width of `fwd_sm90_tile`, the grid of
    `fwd_sm90_grid`; with a `seed`, its dropout variant at `rate` (row 3),
    keyed by `row_index`, `heads_total` and `head0` where given."""
    bh, n, _ = qf.shape
    out = torch.empty_like(qf)
    lse = torch.empty((bh, n), dtype=torch.float32, device=qf.device)
    # the buffers themselves, not their addresses: the list keeps each one
    # alive through the call even if a later lookup empties the cache
    maps = [_map("short", t) for t in (qf, kf, vf)]
    fn = _build.load("flash_attention_fwd_sm90", _FWD_SM90_ARGS)
    rc = fn(*maps, key_bias.data_ptr(), _ptr(seed), _ptr(row_index),
            out.data_ptr(), lse.data_ptr(), bh, *_heads(bh, key_bias, heads_total, head0),
            n, fwd_sm90_tile(n), fwd_sm90_grid(bh, _sm_count(qf.device)), scale,
            dropout_threshold(rate), dropout_scale(rate), qf.shape[2], _stream(qf))
    _build.check("flash_attention_fwd_sm90", rc)
    return out, lse


def bwd_route(n: int) -> str:
    """The backward's kernels (rows 2 and 4) for rows of N keys: "sm90" up
    to SM90_BWD_MAX_N; longer rows take the plain chain's backward
    (`_FlashLong`) and no kernel."""
    if n > SM90_BWD_MAX_N:
        raise ValueError(f"the fused backward takes N <= {SM90_BWD_MAX_N}, got {n}")
    return "sm90"


def bwd_sm90_layout(nt: int, role: str, d: int) -> dict:
    """The sm90 backward's shared memory at key width nt and head dim d
    for `role` ("dq" or "dkdv"), as its source lays it out: head slots of
    the B-side pair (2 x nt rounded up to 64 rows of 2 d bytes) and their
    column vectors, tile stages of 64-row boxes; the stages take what
    leaves room for two head slots (or for one, where two would leave fewer
    than two stages), at most SM90_FWD_MAX_SLOTS, the slots what is
    left."""
    vectors, boxes = SM90_BWD_ROLES[role]
    ntb = -(-nt // SM90_FWD_BOX) * SM90_FWD_BOX
    head, vec = 2 * ntb * 2 * d, vectors * ntb * 4
    tile = boxes * SM90_FWD_BOX * 2 * d
    room = SMEM_LIMIT - 1024 - _BAR_BYTES
    stages = (room - 2 * (head + vec)) // tile
    if stages < 2:
        stages = (room - (head + vec)) // tile
    stages = min(SM90_FWD_MAX_SLOTS, stages)
    slots = min(SM90_FWD_MAX_SLOTS, (room - stages * tile) // (head + vec))
    smem = slots * (head + vec) + stages * tile + _BAR_BYTES + 1024
    return {"head_slots": slots, "tile_stages": stages, "smem": smem}


def bwd_sm90_units(bh: int, n: int, sms: int) -> tuple[int, int]:
    """The sm90 backward's work units for BH heads of N rows on `sms` SMs:
    (64-row tiles per unit, persistent CTAs per tile group). A unit is a
    head and a group of its tiles; the launch has one row of CTAs per group
    (its y), CTA (x, y) takes group y of heads x, x + grid, ..., and its two
    consumer warpgroups its tiles in turn. Of the groupings, the one whose
    busiest warpgroup runs the fewest tiles, and of those the fewest groups
    (each group loads the head's B-side pair again): whole heads wherever
    heads are at least the SMs, and at N <= 256."""
    tiles = -(-n // SM90_FWD_BOX)
    best = None
    for tpg in range(tiles, 0, -1):
        grid = max(1, min(bh, sms // -(-tiles // tpg)))
        busiest = -(-(-(-bh // grid) * tpg) // 2)
        if best is None or busiest < best[0]:
            best = (busiest, tpg, grid)
    return best[1], best[2]


def long_grid(bh: int, n: int) -> tuple[int, int]:
    """The streamed kernel's work (rows 5, and 1 and 3 past
    SM90_FWD_MAX_N): (query tiles of LONG_TILE rows, BH); an item is a
    tile of one head, the tile numbered fastest."""
    return -(-n // LONG_TILE), bh


def long_ctas(bh: int, n: int, sms: int) -> int:
    """The streamed kernel's persistent grid: one CTA per SM, or one per
    work item where there are fewer; CTA c takes items c, c + grid, ..."""
    tiles, _ = long_grid(bh, n)
    return min(tiles * bh, sms)


def stream_smem(d: int) -> int:
    """The streamed kernel's dynamic shared memory at head dim d, as its
    source lays it out: LONG_Q_SLOTS Q slots, LONG_STAGES stages of K and V
    blocks (LONG_TILE rows of 2 d bytes), their bias rows, a full and an
    empty barrier per slot and per stage, and 1024 bytes of alignment
    slack."""
    tile = LONG_TILE * d * 2
    return (LONG_Q_SLOTS * tile + 2 * LONG_STAGES * tile + LONG_STAGES * LONG_TILE * 4
            + 8 * (2 * LONG_Q_SLOTS + 2 * LONG_STAGES) + 1024)


def long_map_extents(bh: int, n: int, d: int):
    """The 3D tensor map of a (BH, N, D) bf16 q, k or v for the streamed
    kernel: dims innermost first (D, N, BH), the byte strides of dims 1..,
    and the box (D, LONG_TILE, 1). A box stops at its head's N, so TMA
    fills a ragged block with zeros instead of reading the next head."""
    row = 2 * d
    return (d, n, bh), (row, row * n), (d, LONG_TILE, 1)


# the sm90 kernels' q/k/v maps: source, and the extents for (BH, N); the
# backward's q, k, v, o and do take the short forward's boxes
_MAP_KINDS = {"long": ("flash_attention_long_sm90", long_map_extents),
              "short": ("flash_attention_fwd_sm90", fwd_sm90_map_extents),
              "bwd": ("flash_attention_bwd_sm90", fwd_sm90_map_extents)}


def _map(kind: str, t: torch.Tensor):
    """The cached 3D tensor map of q, k, v (o, do) `t` for the sm90 kernel
    `kind` ("long", "short" or "bwd"), encoded on a miss."""
    key = (kind, *tensor_map_key(t))
    buf = _MAPS.get(key)
    if buf is None:
        if len(_MAPS) >= _MAPS_CAP:
            _MAPS.clear()
        src, extents = _MAP_KINDS[kind]
        dims, strides, box = extents(*t.shape)
        buf = ctypes.create_string_buffer(128)
        fn = _build.load(src, _ENCODE_ARGS, f"{src}_encode")
        rc = fn(ctypes.addressof(buf), t.data_ptr(), len(dims),
                (ctypes.c_uint64 * 3)(*dims), (ctypes.c_uint64 * 2)(*strides),
                (ctypes.c_uint32 * 3)(*box))
        _build.check(f"{src}_encode", rc)
        _MAPS[key] = buf
    return buf


def _long_map(t: torch.Tensor):
    return _map("long", t)


def flash_attention_fwd_long(qf, kf, vf, key_bias, scale: float):
    """As `flash_attention_fwd_long_plain`: the sm90 kernel on CUDA
    tensors."""
    if qf.device.type == "cpu":
        return flash_attention_fwd_long_plain(qf, kf, vf, key_bias, scale)
    out = _launch_long(qf, kf, vf, key_bias, scale)
    flash_attention_fwd_long.launches += 1
    return out


def _launch_long(qf, kf, vf, key_bias, scale: float):
    """Check the inputs and run the streamed kernel without an lse (row
    5). Returns out."""
    _check("flash_attention_fwd_long", key_bias, qf, kf, vf)
    return _launch_stream(qf, kf, vf, key_bias, scale)[0]


def _launch_stream(qf, kf, vf, key_bias, scale: float, seed=None,
                   rate: float = 0.0, with_lse: bool = False, row_index=None,
                   heads_total=None, head0: int = 0):
    """Run the streamed kernel on checked inputs: the q/k/v maps from the
    cache, the work of `long_grid` on the CTAs of `long_ctas`; `with_lse`
    for rows 1 and 3, and with a `seed` the dropout variant at `rate` (row
    3), keyed by `row_index`, `heads_total` and `head0` where given.
    Returns (out, lse or None)."""
    bh, n, _ = qf.shape
    out = torch.empty_like(qf)
    lse = (torch.empty((bh, n), dtype=torch.float32, device=qf.device)
           if with_lse or seed is not None else None)
    # the buffers themselves, not their addresses: the list keeps each one
    # alive through the call even if a later lookup empties the cache
    maps = [_long_map(t) for t in (qf, kf, vf)]
    tiles, _ = long_grid(bh, n)
    fn = _build.load("flash_attention_long_sm90", _FWD_LONG_ARGS)
    rc = fn(*maps, key_bias.data_ptr(), _ptr(seed), _ptr(row_index), out.data_ptr(),
            _ptr(lse), bh, *_heads(bh, key_bias, heads_total, head0), n, tiles,
            long_ctas(bh, n, _sm_count(qf.device)), scale, dropout_threshold(rate),
            dropout_scale(rate), qf.shape[2], _stream(qf))
    _build.check("flash_attention_long_sm90", rc)
    return out, lse


def flash_attention_fwd_drop(qf, kf, vf, key_bias, seed, scale: float,
                             rate: float, row_index=None, heads_total=None, head0: int = 0):
    """As `flash_attention_fwd_drop_plain`: the kernel of `fwd_route` on
    CUDA tensors."""
    if qf.device.type == "cpu":
        return flash_attention_fwd_drop_plain(qf, kf, vf, key_bias, seed, scale,
                                              rate, row_index, heads_total, head0)
    _check("flash_attention_fwd_drop", key_bias, qf, kf, vf, seed=seed,
           row_index=row_index, heads_total=heads_total, head0=head0)
    out, lse = _launch_fwd(qf, kf, vf, key_bias, scale, seed, rate, row_index,
                           heads_total, head0)
    flash_attention_fwd_drop.launches += 1
    return out, lse


def flash_attention_bwd(qf, kf, vf, key_bias, of, dof, lse, scale: float):
    """(dq, dk, dv): the sm90 kernels on CUDA tensors,
    `flash_attention_bwd_plain` on CPU tensors."""
    if qf.device.type == "cpu":
        return flash_attention_bwd_plain(qf, kf, vf, key_bias, of, dof, lse, scale)
    _check("flash_attention_bwd", key_bias, qf, kf, vf, of, dof, lse=lse)
    grads = _launch_bwd_sm90(qf, kf, vf, key_bias, None, of, dof, lse, scale)
    flash_attention_bwd.launches += 1
    return grads


def flash_attention_bwd_drop(qf, kf, vf, key_bias, seed, of, dof, lse,
                             scale: float, rate: float, row_index=None, heads_total=None,
                             head0: int = 0):
    """As `flash_attention_bwd_drop_plain`: the sm90 kernels on CUDA
    tensors."""
    if qf.device.type == "cpu":
        return flash_attention_bwd_drop_plain(qf, kf, vf, key_bias, seed, of,
                                              dof, lse, scale, rate, row_index,
                                              heads_total, head0)
    _check("flash_attention_bwd_drop", key_bias, qf, kf, vf, of, dof, lse=lse,
           seed=seed, row_index=row_index, heads_total=heads_total, head0=head0)
    grads = _launch_bwd_sm90(qf, kf, vf, key_bias, seed, of, dof, lse, scale, rate,
                             row_index, heads_total, head0)
    flash_attention_bwd_drop.launches += 1
    return grads


def _launch_bwd_sm90(qf, kf, vf, key_bias, seed, of, dof, lse, scale: float,
                     rate: float = 0.0, row_index=None, heads_total=None, head0: int = 0):
    """Run the sm90 backward (its dq kernel, then its dk/dv kernel) on
    checked inputs: the q/k/v/o/do maps from the cache, the key width of
    `fwd_sm90_tile`, the work units and grid of `bwd_sm90_units`; without a
    `seed` the backward without dropout (row 2), with one its dropout
    variant at `rate` (row 4), keyed by `row_index`, `heads_total` and
    `head0` where given."""
    bh, n, _ = qf.shape
    bwd_route(n)
    dq, dk, dv = (torch.empty_like(t) for t in (qf, kf, vf))
    delta = torch.empty((bh, n), dtype=torch.float32, device=qf.device)
    # the buffers themselves, not their addresses: the list keeps each one
    # alive through the call even if a later lookup empties the cache
    maps = [_map("bwd", t) for t in (qf, kf, vf, of, dof)]
    tpg, grid = bwd_sm90_units(bh, n, _sm_count(qf.device))
    fn = _build.load("flash_attention_bwd_sm90", _BWD_SM90_ARGS)
    rc = fn(*maps, key_bias.data_ptr(), _ptr(seed), _ptr(row_index),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, *_heads(bh, key_bias, heads_total, head0), n, fwd_sm90_tile(n), grid, tpg,
            scale, dropout_threshold(rate), dropout_scale(rate), qf.shape[2], _stream(qf))
    _build.check("flash_attention_bwd_sm90", rc)
    return dq, dk, dv


for _fn in (flash_attention_fwd, flash_attention_fwd_drop, flash_attention_bwd,
            flash_attention_bwd_drop, flash_attention_fwd_long):
    _fn.launches = 0


# ------------------------------------------------------------ autograd


class _FlashCore(torch.autograd.Function):
    """`_flash_core`: the forward kernel, and the backward kernel on its lse."""

    @staticmethod
    def forward(ctx, qf, kf, vf, key_bias, scale):
        out, lse = flash_attention_fwd(qf, kf, vf, key_bias, scale)
        ctx.save_for_backward(qf, kf, vf, key_bias, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, key_bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(qf, kf, vf, key_bias, out,
                                         g.contiguous(), lse, ctx.scale)
        return dq, dk, dv, None, None


class _FlashCoreDrop(torch.autograd.Function):
    """`_flash_core_drop`: both kernels with the in-kernel dropout mask,
    keyed by `row_index` and the heads' (`heads_total`, `head0`) where
    given."""

    @staticmethod
    def forward(ctx, qf, kf, vf, key_bias, seed, scale, rate, row_index, heads):
        out, lse = flash_attention_fwd_drop(qf, kf, vf, key_bias, seed, scale,
                                            rate, row_index, *heads)
        ctx.save_for_backward(qf, kf, vf, key_bias, seed, out, lse, row_index)
        ctx.scale, ctx.rate, ctx.heads = scale, rate, heads
        return out

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, key_bias, seed, out, lse, row_index = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_drop(qf, kf, vf, key_bias, seed, out,
                                              g.contiguous(), lse, ctx.scale,
                                              ctx.rate, row_index, *ctx.heads)
        return dq, dk, dv, None, None, None, None, None, None


def _reference_flat(qf, kf, vf, key_bias, scale):
    """`_xla_reference_flat`: the plain chain, probabilities rounded to the
    input dtype before the p.v product."""
    probs = torch.softmax(_scores(qf, kf, key_bias, scale), dim=-1)
    return torch.matmul(probs.to(vf.dtype), vf)


def padded_len(n: int) -> int:
    """N rounded up to PAD_MULTIPLE, the length JAX's routes compare."""
    return -(-n // PAD_MULTIPLE) * PAD_MULTIPLE


class _FlashLong(torch.autograd.Function):
    """`_flash_long` for padded N > LONG_SEQ_THRESHOLD: the forward that
    `_long_primal` picks (row 1 up to FULL_ROW_FWD_MAX, read at call time,
    on the streamed kernel's lse variant; row 5, the same kernel without an
    lse, past it), and a backward that recomputes the plain chain
    (`_flash_long_bwd`)."""

    @staticmethod
    def forward(ctx, qf, kf, vf, key_bias, scale):
        if padded_len(qf.shape[1]) > FULL_ROW_FWD_MAX:
            out = flash_attention_fwd_long(qf, kf, vf, key_bias, scale)
        else:
            out, _ = flash_attention_fwd(qf, kf, vf, key_bias, scale)
        ctx.save_for_backward(qf, kf, vf, key_bias)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, key_bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (qf, kf, vf)]
            out = _reference_flat(*leaves, key_bias, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, bias=None, scale: float,
                    dropout_rate: float = 0.0, dropout_seed=None, row_index=None,
                    heads_total: int | None = None, head0: int = 0):
    """Differentiable fused attention, as JAX's `flash_attention`.

    q, k, v: (B, H, N, D); bias: (B, 1, 1, N) additive key-padding bias or
    None. With dropout_rate > 0, `dropout_seed` (one int32 on q's device)
    seeds the in-kernel mask, which the backward regenerates; that needs
    N <= LONG_SEQ_THRESHOLD. `row_index` ((B,) int32 on q's device, or
    None for each row's own index) gives each row's index in the global
    batch, which keys its mask; `heads_total` and `head0` say which of each
    row's heads the H are (head0 .. head0 + H - 1 of heads_total, a tensor
    rank's share; by default all), which key their masks by their global
    index. Returns (B, H, N, D)."""
    b, h, n, d = q.shape
    use_dropout = dropout_rate > 0.0
    long_seq = padded_len(n) > LONG_SEQ_THRESHOLD
    if use_dropout and long_seq:
        raise ValueError(
            f"in-kernel attention dropout needs the fused backward "
            f"(N <= {LONG_SEQ_THRESHOLD}); got N={n}")
    if bias is None:
        key_bias = torch.zeros((b, n), dtype=torch.float32, device=q.device)
    else:
        key_bias = bias.to(torch.float32).reshape(b, n).contiguous()
    qf, kf, vf = (t.reshape(b * h, n, d).contiguous() for t in (q, k, v))
    if use_dropout:
        seed = torch.as_tensor(dropout_seed, dtype=torch.int32,
                               device=q.device).reshape(1)
        out = _FlashCoreDrop.apply(qf, kf, vf, key_bias, seed, scale,
                                   float(dropout_rate), row_index, (heads_total, head0))
    elif long_seq:
        out = _FlashLong.apply(qf, kf, vf, key_bias, scale)
    else:
        out = _FlashCore.apply(qf, kf, vf, key_bias, scale)
    return out.reshape(b, h, n, d)
