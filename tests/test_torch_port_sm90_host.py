"""Host-side logic of the port's wgmma/TMA kernels, on the CPU.

The kernels themselves run only on the card (`chip_smoke.py` holds them
against their plain versions there); what their wrappers decide on the host
is tested here: the bf16 fused MLP's hidden-split rule (how many CTAs share
a row tile's hidden dimension, with partial sums added in a second pass),
its grid and its cache of tensor maps, keyed by what a map encodes (with
and without the dropout bits, rows 6 and 7); the long flash forward's grid
and 3D tensor maps (row 5); the routes of the flash forward and backward
by sequence length (rows 1 and 3: the short sm90 kernel up to 256 keys,
the streamed one of row 5 past it; rows 2 and 4: the sm90 kernels up to
512), the backward's work units, models of how the warpgroups wait on the
backward's tile ring and on the streamed forward's key ring, and the
arguments each launch passes; the W8A8
matmul's grid, shared memory and tensor maps (row 8); rows 6-10's stages,
layouts and shared memory at every preset's width (vlmo_tiny's 192 to
vlmo_large's 1,024), and a model of how their warpgroups wait on their
rings; and the shape and type checks by which the wrappers refuse what
their kernels do not take.
"""

import ctypes
import math
import struct
import types

import pytest
import torch

import exploremultimodal_torch.ops.flash_attention as fa
import exploremultimodal_torch.ops.mlp_fused as mf

H100_SMS = 132
HIDDEN = 3072  # vlmo_base's MLP hidden width: 48 chunks of 64


def _tiles(m: int) -> int:
    t = -(-m // mf.ROW_TILE)
    return t + (-t % mf.CLUSTER)


@pytest.mark.parametrize("m,splits", [
    (64, 48),      # one tile (two with its cluster's spare): a chunk per CTA
    (320, 16),     # the 1024^2 request's text stream
    (1000, 8),     # ragged, split
    (2560, 3),     # batch-64 text stream: 40 tiles
    (12608, 1),    # image stream: 198 tiles fill the card alone
    (15168, 1),    # fused stream
    (32776, 1),    # the 1024^2 request's image stream (ragged)
])
def test_hidden_splits_at_path_shapes(m, splits):
    assert mf.hidden_splits(m, HIDDEN, H100_SMS) == splits


@pytest.mark.parametrize("m", [1, 63, 64, 65, 127, 500, 2047, 4999, 8448, 8449, 20000])
def test_hidden_splits_fill_at_most_one_wave(m):
    """The split divides the hidden's chunks, keeps tiles x splits within
    one wave of SMs (or is 1 where the tiles alone exceed it), and is the
    largest such divisor."""
    chunks = HIDDEN // mf.HIDDEN_CHUNK
    s = mf.hidden_splits(m, HIDDEN, H100_SMS)
    tiles = _tiles(m)
    assert chunks % s == 0
    assert tiles * s <= H100_SMS or s == 1
    larger = [d for d in range(s + 1, chunks + 1) if chunks % d == 0]
    assert all(tiles * d > H100_SMS for d in larger)


def test_tensor_map_key_names_what_a_map_encodes():
    a = torch.zeros(128, 768, dtype=torch.bfloat16)
    key = mf.tensor_map_key(a)
    assert key == mf.tensor_map_key(a) == mf.tensor_map_key(a.view(128, 768))
    assert key != mf.tensor_map_key(a[:64])            # another shape, same address
    assert key != mf.tensor_map_key(a.clone())         # another address
    assert key != mf.tensor_map_key(a.view(256, 384))


def test_tensor_maps_are_encoded_once_and_the_cache_is_bounded(monkeypatch):
    """`_tensor_map` encodes a tensor's map once and reuses the buffer;
    past the cap the cache starts afresh instead of growing."""
    calls = []

    def fake_load(name, argtypes, symbol=None):
        assert (name, symbol) == ("fused_mlp_sm90", "fused_mlp_sm90_encode")

        def encode(buf, ptr, rows, cols):
            calls.append((ptr, rows, cols))
            return 0
        return encode

    monkeypatch.setattr(mf._build, "load", fake_load)
    monkeypatch.setattr(mf, "_MAPS", {})
    monkeypatch.setattr(mf, "_MAPS_CAP", 4)
    w = torch.zeros(3072, 768, dtype=torch.bfloat16)
    first = mf._tensor_map(w)
    assert mf._tensor_map(w) is first and len(calls) == 1
    assert calls[0] == (w.data_ptr(), 3072, 768)
    others = [torch.zeros(64, 768, dtype=torch.bfloat16) for _ in range(4)]
    for t in others:
        mf._tensor_map(t)
    assert len(calls) == 5 and len(mf._MAPS) <= 4
    mf._tensor_map(w)  # evicted with the rest when the cap was reached
    assert len(calls) == 6


# ------------------------------------------- row 7: the sm90 kernel's DROP variant

VQA_M = (1280, 6304, 7584)  # the finetune_vqa step's text, image and fused FFN rows


@pytest.mark.parametrize("m,tiles,splits", [
    (1280, 20, 6),    # text: 20 tiles x 6 splits = 120 CTAs
    (6304, 100, 1),   # image: 99 tiles and a cluster's spare, one wave
    (7584, 120, 1),   # fused: 118.5 tiles -> 120, one wave
    (1000, 16, 8),    # ragged, split
    (4999, 80, 1),    # ragged, whole tiles past half a wave
])
def test_row7_grid_at_path_shapes(m, tiles, splits):
    """Row 7 takes row 6's grid: 64-row tiles in whole clusters of 2 by
    hidden splits, at most one wave of the card."""
    assert mf.row_tiles(m) == tiles == _tiles(m)
    assert mf.hidden_splits(m, HIDDEN, H100_SMS) == splits
    assert tiles * splits <= H100_SMS
    assert tiles * mf.ROW_TILE >= m > (tiles - mf.CLUSTER) * mf.ROW_TILE


def test_bits_tensor_map_key_and_cache(monkeypatch):
    """The int16 dropout bits get their map through the same cache as x and
    the weights: one encode per (device, address, shape), as a 2-byte
    (M, H) matrix in 64 x 64 boxes, and the cache stays bounded."""
    calls = []

    def fake_load(name, argtypes, symbol=None):
        assert (name, symbol) == ("fused_mlp_sm90", "fused_mlp_sm90_encode")

        def encode(buf, ptr, rows, cols):
            calls.append((ptr, rows, cols))
            return 0
        return encode

    monkeypatch.setattr(mf._build, "load", fake_load)
    monkeypatch.setattr(mf, "_MAPS", {})
    monkeypatch.setattr(mf, "_MAPS_CAP", 3)
    bits = torch.zeros(1280, HIDDEN, dtype=torch.int16)
    assert mf.tensor_map_key(bits) == (None, bits.data_ptr(), (1280, HIDDEN))
    assert mf.tensor_map_key(bits) != mf.tensor_map_key(bits[:640])
    first = mf._tensor_map(bits)
    assert mf._tensor_map(bits) is first
    assert calls == [(bits.data_ptr(), 1280, HIDDEN)]
    for m in VQA_M:
        mf._tensor_map(torch.zeros(m, HIDDEN, dtype=torch.int16))
        assert len(mf._MAPS) <= 3
    assert len(calls) == 4


def _fake_encoder(calls):
    """An encoder that writes (address, dims) into the map buffer, so a map
    can be told apart from another by its bytes."""
    def encode(buf, ptr, *dims):
        calls.append(ptr)
        packed = struct.pack("<q", ptr) + repr(tuple(
            tuple(d) if hasattr(d, "__len__") else d for d in dims)).encode()
        ctypes.memmove(buf, packed, len(packed))
        return 0
    return encode


def _map_bytes(m) -> bytes:
    return bytes(m) if isinstance(m, ctypes.Array) else ctypes.string_at(m, 128)


@pytest.mark.parametrize("cap", [1, 2, 3, 256])
def test_row7_launch_passes_live_maps_across_an_eviction(monkeypatch, cap):
    """The cache may empty itself between two of a launch's lookups; every
    map the kernel receives must still be the one encoded for its tensor
    (x, w1, w2, bits in that order)."""
    calls, seen = [], []

    def kernel(*args):
        seen.append([_map_bytes(m) for m in args[:4]])
        return 0

    def fake_load(name, argtypes, symbol=None):
        assert name == "fused_mlp_sm90"
        return _fake_encoder(calls) if symbol == "fused_mlp_sm90_encode" else kernel

    monkeypatch.setattr(mf._build, "load", fake_load)
    monkeypatch.setattr(mf, "_MAPS", {})
    monkeypatch.setattr(mf, "_MAPS_CAP", cap)
    monkeypatch.setitem(mf._SMS, None, H100_SMS)
    monkeypatch.setattr(mf.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    x, w1, b1, w2, b2, bits = _mlp_args(m=128)
    for _ in range(2):
        mf._launch_sm90("fused_mlp_fwd_drop", x, w1, b1, w2, b2, bits, 6554)
    for maps in seen:
        assert [struct.unpack("<q", b[:8])[0] for b in maps] == [
            t.data_ptr() for t in (x, w1, w2, bits)]
    assert len(mf._MAPS) <= cap


def _mlp_args(m=64, k=768, h=HIDDEN, n=768, bits_dtype=torch.int16, bits_shape=None):
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    w1 = torch.zeros(h, k, dtype=torch.bfloat16)
    w2 = torch.zeros(n, h, dtype=torch.bfloat16)
    b1, b2 = torch.zeros(h), torch.zeros(n)
    bits = torch.zeros(bits_shape or (m, h), dtype=bits_dtype)
    return x, w1, b1, w2, b2, bits


def test_row7_shape_checks_pass_the_path_shape():
    assert mf._sm90_shapes("t", *_mlp_args(m=7584)) == (7584, HIDDEN, 768)


@pytest.mark.parametrize("bad", [
    {"bits_dtype": torch.int32},            # bits not int16
    {"bits_dtype": torch.uint8},
    {"bits_shape": (64, HIDDEN // 2)},      # bits not (M, H)
    {"bits_shape": (32, HIDDEN)},
    {"k": 512},                             # x's tile is 768 wide
    {"h": 3072 - 32},                       # hidden not whole 64-column chunks
    {"n": 512},                             # output width not instantiated
])
def test_row7_shape_checks_raise(bad):
    with pytest.raises(ValueError):
        mf._sm90_shapes("fused_mlp_fwd_drop", *_mlp_args(**bad))


def test_row7_checks_dtypes():
    x, w1, b1, w2, b2, bits = _mlp_args()
    with pytest.raises(ValueError):
        mf._sm90_shapes("t", x.half(), w1, b1, w2, b2, bits)
    with pytest.raises(ValueError):
        mf._sm90_shapes("t", x, w1, b1.half(), w2, b2, bits)


# ------------------------------------------- row 5: the long sm90 forward

@pytest.mark.parametrize("bh,n,tiles", [
    (96, 4097, 33),    # the 1024^2 request's image stream: 32 tiles + 1 row
    (96, 4137, 33),    # its fused stream: 32 tiles + 41 rows
    (12, 4097, 33),    # batch 1
    (3, 200, 2),       # small ragged N
    (3, 128, 1),
    (3, 129, 2),
    (96, 333, 3),      # rows 1 and 3 past 256 keys at batch 8, a ragged N
    (96, 512, 4),
    (96, 577, 5),      # 384^2 images
    (384, 512, 4),     # pretrain_txt at batch 32
])
def test_long_grid_and_map_extents(bh, n, tiles):
    """Query tiles x BH; the 3D map (D, N, BH) stops each box at its head's
    N, with byte strides TMA accepts (multiples of 16) and 128-key boxes
    that cover N, the last one ragged unless N is a multiple of 128."""
    assert fa.long_grid(bh, n) == (tiles, bh)
    dims, strides, box = fa.long_map_extents(bh, n, 64)
    assert dims == (64, n, bh)
    assert strides == (2 * 64, 2 * 64 * n)
    assert all(s % 16 == 0 for s in strides)
    assert box == (64, fa.LONG_TILE, 1) and box[0] * 2 == 128
    assert (tiles - 1) * fa.LONG_TILE < n <= tiles * fa.LONG_TILE


def test_long_maps_are_encoded_once_and_the_cache_is_bounded(monkeypatch):
    calls = []

    def fake_load(name, argtypes, symbol=None):
        assert (name, symbol) == ("flash_attention_long_sm90",
                                  "flash_attention_long_sm90_encode")

        def encode(buf, ptr, rank, dims, strides, box):
            calls.append((ptr, rank, tuple(dims), tuple(strides), tuple(box)))
            return 0
        return encode

    monkeypatch.setattr(fa._build, "load", fake_load)
    monkeypatch.setattr(fa, "_MAPS", {})
    monkeypatch.setattr(fa, "_MAPS_CAP", 2)
    q = torch.zeros(12, 4097, 64, dtype=torch.bfloat16)
    first = fa._long_map(q)
    assert fa._long_map(q) is first
    assert calls == [(q.data_ptr(), 3, *fa.long_map_extents(12, 4097, 64))]
    for n in (300, 4137, 129):
        fa._long_map(torch.zeros(3, n, 64, dtype=torch.bfloat16))
        assert len(fa._MAPS) <= 2
    assert len(calls) == 4


@pytest.mark.parametrize("cap", [1, 2, 256])
def test_long_launch_passes_live_maps_across_an_eviction(monkeypatch, cap):
    """Row 5's maps of q, k, v stay live across a cache eviction; it passes
    no seed and no lse (the output only), and the persistent grid."""
    calls, seen, launches = [], [], []

    def kernel(*args):
        seen.append([_map_bytes(m) for m in args[:3]])
        launches.append(args[3:])
        return 0

    def fake_load(name, argtypes, symbol=None):
        assert name == "flash_attention_long_sm90"
        return (_fake_encoder(calls) if symbol == "flash_attention_long_sm90_encode"
                else kernel)

    monkeypatch.setattr(fa._build, "load", fake_load)
    monkeypatch.setattr(fa, "_MAPS", {})
    monkeypatch.setattr(fa, "_MAPS_CAP", cap)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    monkeypatch.setattr(fa, "_sm_count", lambda dev: H100_SMS)
    kb, q, k, v = _attn_args(bh=6, n=300, b=2)
    for _ in range(2):
        out = fa._launch_long(q, k, v, kb, 0.125)
    assert out.shape == q.shape
    for maps in seen:
        assert [struct.unpack("<q", b[:8])[0] for b in maps] == [
            t.data_ptr() for t in (q, k, v)]
    # bias, no seed, no row index, out, no lse, (bh, heads, the heads' total
    # and first, n, tiles, CTAs)
    assert launches[-1][1] is None and launches[-1][2] is None and launches[-1][4] is None
    assert launches[-1][5:12] == (6, 3, 3, 0, 300, 3, 18)
    assert len(fa._MAPS) <= cap


def _attn_args(bh=24, n=4097, d=64, dtype=torch.bfloat16, b=2, bias_n=None,
               bias_dtype=torch.float32):
    q, k, v = (torch.zeros(bh, n, d, dtype=dtype) for _ in range(3))
    return torch.zeros(b, bias_n or n, dtype=bias_dtype), q, k, v


def test_long_checks_pass_the_path_shape():
    fa._check("flash_attention_fwd_long", *_attn_args(bh=96, n=4137, b=8))


@pytest.mark.parametrize("bad", [
    {"d": 16},                         # a head dim no preset has (32 and 64 taken)
    {"d": 128},
    {"dtype": torch.float16},          # not bf16
    {"dtype": torch.float32},
    {"bias_dtype": torch.bfloat16},    # bias not fp32
    {"bias_n": 4096},                  # bias not (B, N)
    {"b": 5},                          # B does not divide BH
])
def test_long_checks_raise(bad):
    with pytest.raises(ValueError):
        fa._check("flash_attention_fwd_long", *_attn_args(**bad))


# ------------------------------------------- row 1: the short sm90 forward

import exploremultimodal_torch.ops.quant_fused as qf  # noqa: E402

SMEM_LIMIT = mf.SMEM_LIMIT


@pytest.mark.parametrize("n,route", [
    (1, "sm90"), (40, "sm90"), (197, "sm90"), (237, "sm90"), (256, "sm90"),
    (257, "sm90_stream"), (577, "sm90_stream"), (4096, "sm90_stream"),
])
def test_row1_route_by_length(n, route):
    """Rows of up to 256 keys take the short sm90 kernel (a head's whole K
    and V in one slot); longer ones, up to FULL_ROW_FWD_MAX, the streamed
    kernel (K and V in 128-key blocks)."""
    assert fa.fwd_route(n) == route
    assert (n <= fa.SM90_FWD_MAX_N) == (route == "sm90")


@pytest.mark.parametrize("n,width", [
    (1, 16), (16, 16), (17, 32), (40, 48), (100, 112), (197, 208), (237, 240), (256, 256),
])
def test_row1_key_width(n, width):
    """The key width (the wgmma N of Q K^T) is N rounded up to 16, so at
    most 15 padded keys are computed."""
    assert fa.fwd_sm90_tile(n) == width
    assert width % 16 == 0 and 0 <= width - n < 16


@pytest.mark.parametrize("bh,grid", [(96, 96), (768, 132), (1152, 132), (12, 12)])
def test_row1_persistent_grid(bh, grid):
    """One CTA per SM, or one per head where there are fewer heads (the
    1024^2 request's text stream, BH = 96)."""
    assert fa.fwd_sm90_grid(bh, H100_SMS) == grid
    heads_per_cta = -(-bh // grid)
    assert heads_per_cta * grid >= bh > (heads_per_cta - 1) * grid


@pytest.mark.parametrize("bh,n", [(768, 40), (768, 197), (768, 237), (96, 40), (3, 1)])
def test_row1_map_extents(bh, n):
    """3D map (D, N, BH) with byte strides TMA accepts and 64-row boxes, so
    a box stops at its head's N and the slot's rows past N are zeros."""
    dims, strides, box = fa.fwd_sm90_map_extents(bh, n, 64)
    assert dims == (64, n, bh)
    assert strides == (2 * 64, 2 * 64 * n)
    assert all(s % 16 == 0 for s in strides)
    assert box == (64, fa.SM90_FWD_BOX, 1) and box[0] * 2 == 128
    boxes = -(-fa.fwd_sm90_tile(n) // fa.SM90_FWD_BOX)
    assert boxes * box[1] >= fa.fwd_sm90_tile(n) >= n


@pytest.mark.parametrize("nt", range(16, 257, 16))
def test_row1_shared_memory_budget(nt):
    """Every key width's slots fit a block, with at least one slot and at
    most SM90_FWD_MAX_SLOTS; the two VLMo-wide widths keep two heads in
    flight."""
    slots = fa.fwd_sm90_slots(nt, 64)
    assert 1 <= slots <= fa.SM90_FWD_MAX_SLOTS
    assert fa.fwd_sm90_smem(nt, 64) <= SMEM_LIMIT
    rows = -(-nt // 64) * 64
    assert fa.fwd_sm90_smem(nt, 64) >= slots * 3 * rows * 128
    if nt >= 208:
        assert slots == 2


def test_row1_maps_are_encoded_once_and_apart_from_row5(monkeypatch):
    calls = []

    def fake_load(name, argtypes, symbol=None):
        assert symbol == f"{name}_encode"

        def encode(buf, ptr, rank, dims, strides, box):
            calls.append((name, ptr, tuple(dims), tuple(box)))
            return 0
        return encode

    monkeypatch.setattr(fa._build, "load", fake_load)
    monkeypatch.setattr(fa, "_MAPS", {})
    q = torch.zeros(12, 197, 64, dtype=torch.bfloat16)
    first = fa._map("short", q)
    assert fa._map("short", q) is first
    assert fa._map("long", q) is not first  # another kernel, another box
    assert calls == [
        ("flash_attention_fwd_sm90", q.data_ptr(), (64, 197, 12), (64, 64, 1)),
        ("flash_attention_long_sm90", q.data_ptr(), (64, 197, 12), (64, 128, 1))]


@pytest.mark.parametrize("cap", [1, 2, 256])
def test_row1_launch_passes_live_maps_across_an_eviction(monkeypatch, cap):
    calls, seen, launches = [], [], []

    def kernel(*args):
        seen.append([_map_bytes(m) for m in args[:3]])
        launches.append(args[3:])
        return 0

    def fake_load(name, argtypes, symbol=None):
        assert name == "flash_attention_fwd_sm90"
        return (_fake_encoder(calls) if symbol == "flash_attention_fwd_sm90_encode"
                else kernel)

    monkeypatch.setattr(fa._build, "load", fake_load)
    monkeypatch.setattr(fa, "_MAPS", {})
    monkeypatch.setattr(fa, "_MAPS_CAP", cap)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    monkeypatch.setattr(fa, "_sm_count", lambda dev: H100_SMS)
    kb, q, k, v = _attn_args(bh=24, n=237, b=2)
    for _ in range(2):
        out, lse = fa._launch_fwd_sm90(q, k, v, kb, 0.125)
    assert out.shape == q.shape and lse.shape == (24, 237)
    for maps in seen:
        assert [struct.unpack("<q", b[:8])[0] for b in maps] == [
            t.data_ptr() for t in (q, k, v)]
    # bias, a null seed and row index, out, lse, then bh, heads, the heads'
    # total and first, n, the key width and the grid, the scale and no
    # dropout (threshold 0, factor 1)
    assert launches[-1][1] is None and launches[-1][2] is None
    assert launches[-1][5:12] == (24, 12, 12, 0, 237, 240, 24)
    assert launches[-1][12:15] == (0.125, 0, 1.0)
    assert len(fa._MAPS) <= cap


@pytest.mark.parametrize("bad", [
    {"d": 16}, {"dtype": torch.float16}, {"bias_dtype": torch.bfloat16},
    {"bias_n": 40}, {"b": 5},
])
def test_row1_checks_raise(bad):
    with pytest.raises(ValueError):
        fa._check("flash_attention_fwd", *_attn_args(**{"bh": 24, "n": 197, **bad}))


# ------------------------------------------- row 9: the W8A8 MLP on int8 wgmma

@pytest.mark.parametrize("m,grid,splits", [
    (64, 1, 2),        # one tile, its hidden over a cluster of two
    (1000, 16, 2),     # ragged
    (2560, 40, 2),     # the int8 request's text stream: 80 CTAs
    (4999, 80, 1),     # split would pass a wave: clusters along M
    (12608, 198, 1),   # image stream: 197 tiles and a cluster's spare
    (15168, 238, 1),   # fused stream: 237 tiles and a spare
])
def test_row9_grid_and_cluster_shape(m, grid, splits):
    """Split over the hidden (clusters of two along y) while the doubled
    tiles fit one wave, else clusters of two along M sharing the weight
    boxes, the tiles rounded up to whole clusters."""
    assert qf.mlp_splits(m, HIDDEN, H100_SMS) == splits
    assert qf.mlp_splits(m, HIDDEN - 64, H100_SMS) == 1  # 47 chunks do not halve
    assert qf.mlp_grid(m, splits) == grid
    tiles = -(-m // qf.MLP_ROW_TILE)
    if splits == 1:
        assert grid % qf.MLP_CLUSTER == 0 and tiles <= grid <= tiles + 1
    else:
        assert grid == tiles and grid * splits <= H100_SMS


@pytest.mark.parametrize("rows,cols,operand,box,swizzle", [
    (3072, 768, "w1", (128, 64), 128),   # qW1 (H, K): K-major 128-byte rows
    (768, 3072, "w2", (64, 128), 64),    # qW2 (N, H): a chunk's 64 hidden bytes
    (1024, 768, "w1", (128, 64), 128),
])
def test_row9_map_extents(rows, cols, operand, box, swizzle):
    dims, strides, got_box, got_swizzle = qf.mlp_map_extents(rows, cols, operand)
    assert dims == (cols, rows) and strides == (cols,) and strides[0] % 16 == 0
    assert got_box == box and got_swizzle == swizzle
    assert got_box[0] <= got_swizzle  # a box row within its swizzle span
    # at K = N = 768 six boxes make a chunk of W1 (64 rows x 768) or of W2
    # (768 rows x 64)
    assert got_box[0] * got_box[1] * qf.mlp_layout(768)["sb"] == 64 * 768


def test_row9_shared_memory_budget():
    """The kernel fits a block, and so does the layout with the two int16
    dropout-bits slots a dropout variant would add."""
    assert qf.mlp_smem() <= qf.mlp_smem(drop=True) <= SMEM_LIMIT
    assert qf.mlp_smem(drop=True) - qf.mlp_smem() == 2 * 64 * 64 * 2
    ring = qf.MLP_RING_STAGES * qf.mlp_layout(768)["sb"] * qf.MLP_BOX_BYTES
    assert qf.mlp_smem() > 64 * 768 + ring  # x's codes and the ring


def test_row9_maps_are_encoded_once_and_the_cache_is_bounded(monkeypatch):
    calls = []

    def fake_load(name, argtypes, symbol=None):
        assert (name, symbol) == ("w8a8_mlp_sm90", "w8a8_mlp_sm90_encode")

        def encode(buf, ptr, rows, cols, box_cols, box_rows, swizzle):
            calls.append((ptr, rows, cols, box_cols, box_rows, swizzle))
            return 0
        return encode

    monkeypatch.setattr(qf._build, "load", fake_load)
    monkeypatch.setattr(qf, "_MAPS", {})
    monkeypatch.setattr(qf, "_MAPS_CAP", 3)
    qw1 = torch.zeros(3072, 768, dtype=torch.int8)
    first = qf._mlp_map(qw1, "w1")
    assert qf._mlp_map(qw1, "w1") is first
    assert calls == [(qw1.data_ptr(), 3072, 768, 128, 64, 128)]
    others = [torch.zeros(768, 3072, dtype=torch.int8) for _ in range(4)]  # 4 addresses
    for t in others:
        qf._mlp_map(t, "w2")
        assert len(qf._MAPS) <= 3
    assert len(calls) == 5


def _w8a8_args(m=64, k=768, h=3072, n=768, x_dtype=torch.bfloat16, w_dtype=torch.int8):
    return (torch.zeros(m, k, dtype=x_dtype), torch.zeros(h, k, dtype=w_dtype),
            torch.zeros(h), torch.zeros(h), torch.zeros(n, h, dtype=w_dtype),
            torch.zeros(n), torch.zeros(n))


@pytest.mark.parametrize("m,cap", [(128, 1), (2560, 2), (15168, 256)])
def test_row9_launch_passes_live_maps_across_an_eviction(monkeypatch, m, cap):
    calls, seen, launches = [], [], []

    def kernel(*args):
        seen.append([_map_bytes(t) for t in args[:2]])
        launches.append(args[8:])
        return 0

    def fake_load(name, argtypes, symbol=None):
        assert name == "w8a8_mlp_sm90"
        return _fake_encoder(calls) if symbol == "w8a8_mlp_sm90_encode" else kernel

    monkeypatch.setattr(qf._build, "load", fake_load)
    monkeypatch.setattr(qf, "_MAPS", {})
    monkeypatch.setattr(qf, "_MAPS_CAP", cap)
    monkeypatch.setattr(qf, "_sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(qf.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    args = _w8a8_args(m=m)
    for _ in range(2):
        assert qf._launch_mlp_sm90(*args).shape == (m, 768)
    for maps in seen:
        assert [struct.unpack("<q", b[:8])[0] for b in maps] == [
            args[1].data_ptr(), args[4].data_ptr()]
    splits = qf.mlp_splits(m, HIDDEN, H100_SMS)
    part, shs, *rest = launches[-1]
    assert (part is None) == (shs is None) == (splits == 1)
    assert rest[:5] == [m, 768, 3072, qf.mlp_grid(m, splits), splits]
    assert len(qf._MAPS) <= cap


@pytest.mark.parametrize("bad", [
    {"k": 512},                      # K in MLP_WIDTHS
    {"h": 3072 - 32},                # hidden in whole 64-column chunks
    {"n": 512},                      # output width K
    {"x_dtype": torch.float16},      # x bf16
    {"w_dtype": torch.uint8},        # codes int8
])
def test_row9_checks_raise(bad):
    with pytest.raises(ValueError):
        qf._launch_mlp_sm90(*_w8a8_args(**bad))


# ------------------------------------------- row 8: the W8A8 matmul on int8 wgmma

MATMUL_SRC = qf._build.CSRC / "w8a8_matmul_sm90.cu"


@pytest.mark.parametrize("m,n,grid_x,grid_y,per", [
    (64, 2304, 1, 18, 1),      # one block: a tile per CTA
    (1000, 768, 8, 6, 1),      # ragged
    (1280, 2304, 10, 9, 2),    # the int8 finetune_vqa step's text rows: 90 CTAs
    (1280, 768, 10, 6, 1),
    (2560, 2304, 20, 6, 3),    # the int8 request's text stream: 120 CTAs
    (2560, 768, 20, 6, 1),
    (6304, 2304, 50, 2, 9),    # the step's image rows: two CTAs a block
    (7584, 768, 60, 2, 3),     # the step's fused rows
    (12608, 2304, 99, 1, 18),  # the request's image stream
    (15168, 2304, 119, 1, 18),  # the fused stream: 118.5 blocks
    (15168, 768, 119, 1, 6),
])
def test_row8_grid_and_split_at_path_shapes(m, n, grid_x, grid_y, per):
    """A CTA per 128-row block; the 128-column output tiles split over y
    while the blocks leave SMs idle, every CTA with at least one tile and
    the grid within one wave."""
    assert qf.matmul_grid(m, n, H100_SMS) == (grid_x, grid_y, per)
    tiles = n // 128
    assert grid_x == -(-m // 128)
    assert (grid_y - 1) * per < tiles <= grid_y * per
    assert grid_x * grid_y <= H100_SMS or grid_y == 1
    if per > 1:  # one tile fewer a CTA would pass one wave
        assert grid_x * -(-tiles // (per - 1)) > H100_SMS


@pytest.mark.parametrize("rows,cols,operand,box", [
    (2304, 768, "w", (128, 64)),   # qkv's codes: K-major rows of 768 bytes
    (768, 768, "w", (128, 64)),    # proj's
    (15168, 2304, "y", (64, 64)),  # y: 64 bf16 columns (128 bytes) a box row
    (1000, 768, "y", (64, 64)),
])
def test_row8_map_extents(rows, cols, operand, box):
    """Both maps in the 128-byte swizzle, each box 8 KB with rows of 128
    bytes, the boxes the source's encoder accepts (KB bytes a row, 64 rows);
    the row stride in bytes is a multiple of 16, as TMA needs."""
    dims, strides, got_box, swizzle = qf.matmul_map_extents(rows, cols, operand)
    elem = 1 if operand == "w" else 2
    assert dims == (cols, rows) and strides == (cols * elem,) and strides[0] % 16 == 0
    assert got_box == box and swizzle == 128 and got_box[0] * elem == swizzle
    assert got_box[0] * got_box[1] * elem == qf.MLP_BOX_BYTES
    src = MATMUL_SRC.read_text()
    assert "box_cols * elem_bytes != KB || box_rows != 64" in src
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in src


def test_row8_shared_memory_budget():
    """The mirror of the source's three layouts: x's codes for 128 rows at
    the layout's widest K (384, 768 or 1,024), six ring stages of two boxes
    up to K = 768 and four past it, four staged y boxes (a pair a
    warpgroup), the row scales, the barriers and the slack fit a block; the
    constants are the source's (K 192 to 1,024)."""
    src = MATMUL_SRC.read_text()
    for const in ("K_MIN = 192;", "K_LOW = 384;", "K_MID = 768;", "K_MAX = 1024;", "BM = 128;",
                  "BN = 128;", "KB = 128;", "BOX = 8192;", "STAGE = 2 * BOX;",
                  "THREADS = 384;"):
        assert f"constexpr int {const}" in src
    for off in ("NS = KMAX <= K_MID ? 6 : 4;", "SCALE_OFF = OUT_OFF + 4 * BOX;",
                "BAR_OFF = SCALE_OFF + BM * 4;", "SMEM = BAR_OFF + 8 * 2 * NS + 1024;"):
        assert f"static constexpr int {off}" in src
    assert (qf.MATMUL_ROW_TILE, qf.MATMUL_COL_TILE) == (128, 128)
    assert qf.MATMUL_LAYOUTS == {384: 6, 768: 6, 1024: 4}
    assert qf.matmul_smem(192) == qf.matmul_smem(384) == 181856
    assert qf.matmul_smem() == qf.matmul_smem(448) == 231008 <= SMEM_LIMIT
    assert qf.matmul_smem() > 128 * 768 + 6 * 2 * 8192 + 4 * 8192  # codes, ring, y boxes
    assert qf.matmul_smem(832) == qf.matmul_smem(1024) == 230976 <= SMEM_LIMIT
    assert qf.matmul_smem(1024) > 128 * 1024 + 4 * 2 * 8192 + 4 * 8192


def test_row8_maps_are_encoded_once_and_the_cache_is_bounded(monkeypatch):
    calls = []

    def fake_load(name, argtypes, symbol=None):
        assert (name, symbol) == ("w8a8_matmul_sm90", "w8a8_matmul_sm90_encode")

        def encode(buf, ptr, rows, cols, box_cols, box_rows, elem_bytes):
            calls.append((ptr, rows, cols, box_cols, box_rows, elem_bytes))
            return 0
        return encode

    monkeypatch.setattr(qf._build, "load", fake_load)
    monkeypatch.setattr(qf, "_MAPS", {})
    monkeypatch.setattr(qf, "_MAPS_CAP", 3)
    qw = torch.zeros(2304, 768, dtype=torch.int8)
    y = torch.zeros(64, 2304, dtype=torch.bfloat16)
    first = qf._matmul_map(qw, "w")
    assert qf._matmul_map(qw, "w") is first
    assert qf._matmul_map(y, "y") is not first  # another operand, another map
    assert calls == [(qw.data_ptr(), 2304, 768, 128, 64, 1), (y.data_ptr(), 64, 2304, 64, 64, 2)]
    for _ in range(4):
        qf._matmul_map(torch.zeros(64, 768, dtype=torch.bfloat16), "y")
        assert len(qf._MAPS) <= 3


@pytest.mark.parametrize("m,n,cap", [(64, 2304, 1), (2560, 768, 2), (15168, 2304, 256)])
def test_row8_launch_passes_live_maps_across_an_eviction(monkeypatch, m, n, cap):
    """On tensors of the meta device (neither CPU nor CUDA): the maps of qw
    and of the new y, each the one encoded for its tensor even where the
    cache empties itself between the lookups, then x and sw, (m, n), the
    grid's x and the tiles per CTA of `matmul_grid`, the stream; one
    launch counted per call."""
    calls, seen = [], []

    def kernel(*args):
        seen.append(([_map_bytes(t) for t in args[:2]], args[2:]))
        return 0

    def fake_load(name, argtypes, symbol=None):
        assert name == "w8a8_matmul_sm90"
        if symbol == "w8a8_matmul_sm90_encode":
            return _fake_encoder(calls)
        assert symbol is None and len(argtypes) == 10
        return kernel

    monkeypatch.setattr(qf._build, "load", fake_load)
    monkeypatch.setattr(qf, "_MAPS", {})
    monkeypatch.setattr(qf, "_MAPS_CAP", cap)
    monkeypatch.setattr(qf, "_sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(qf.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    x = torch.empty(m, 768, dtype=torch.bfloat16, device="meta")
    qw = torch.empty(n, 768, dtype=torch.int8, device="meta")
    sw = torch.empty(n, device="meta")
    before = qf.w8a8_matmul.launches
    for _ in range(2):
        y = qf.w8a8_matmul(x, qw, sw)
        assert y.shape == (m, n) and y.dtype == torch.bfloat16
    assert qf.w8a8_matmul.launches - before == 2
    maps, rest = seen[-1]
    assert [struct.unpack("<q", b[:8])[0] for b in maps] == [qw.data_ptr(), y.data_ptr()]
    grid_x, _, per = qf.matmul_grid(m, n, H100_SMS)
    assert rest == (x.data_ptr(), sw.data_ptr(), m, n, 768, grid_x, per, 0)
    assert len(qf._MAPS) <= cap


@pytest.mark.parametrize("bad", [
    {"k": 96},                       # K in [192, 1024]
    {"n": 1504},                     # N a multiple of 64
    {"x_dtype": torch.float16},      # x bf16
    {"w_dtype": torch.uint8},        # codes int8
    {"sw_dtype": torch.bfloat16},    # scales fp32
])
def test_row8_checks_raise(bad):
    x = torch.empty(64, bad.get("k", 768), dtype=bad.get("x_dtype", torch.bfloat16),
                    device="meta")
    n = bad.get("n", 2304)
    qw = torch.empty(n, bad.get("k", 768), dtype=bad.get("w_dtype", torch.int8), device="meta")
    sw = torch.empty(n, dtype=bad.get("sw_dtype", torch.float32), device="meta")
    with pytest.raises(ValueError):
        qf.w8a8_matmul(x, qw, sw)


# ------------------------------------------- row 4: the sm90 dropout backward

BWD_SRC = fa._build.CSRC / "flash_attention_bwd_sm90.cu"


# per row: the wrapper, its route function, and the (source, entry,
# argument types) it loads on the sm90 and on the sm90_stream route (the
# backward has no sm90_stream route)
ROUTED = {
    1: (fa.flash_attention_fwd, fa.fwd_route,
        ("flash_attention_fwd_sm90", "flash_attention_fwd_sm90", fa._FWD_SM90_ARGS),
        ("flash_attention_long_sm90", "flash_attention_long_sm90", fa._FWD_LONG_ARGS)),
    2: (fa.flash_attention_bwd, fa.bwd_route,
        ("flash_attention_bwd_sm90", "flash_attention_bwd_sm90", fa._BWD_SM90_ARGS), None),
    3: (fa.flash_attention_fwd_drop, fa.fwd_route,
        ("flash_attention_fwd_sm90", "flash_attention_fwd_sm90", fa._FWD_SM90_ARGS),
        ("flash_attention_long_sm90", "flash_attention_long_sm90", fa._FWD_LONG_ARGS)),
    4: (fa.flash_attention_bwd_drop, fa.bwd_route,
        ("flash_attention_bwd_sm90", "flash_attention_bwd_sm90", fa._BWD_SM90_ARGS), None),
}


def _routed_launch(monkeypatch, row: int, n: int, bh: int = 24, b: int = 2):
    """Call row `row`'s wrapper on (bh, n, 64) tensors on the meta device
    (neither CPU, which takes the plain version, nor CUDA) with a fake
    loader; returns the (source, entry, argument types) of each kernel it
    loaded and how far its launch count moved."""
    loaded = []

    def fake_load(name, argtypes, symbol=None):
        symbol = symbol or name
        if not symbol.endswith("_encode"):
            loaded.append((name, symbol, argtypes))
        return lambda *args: 0

    monkeypatch.setattr(fa._build, "load", fake_load)
    monkeypatch.setattr(fa, "_MAPS", {})
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    monkeypatch.setattr(fa, "_sm_count", lambda dev: H100_SMS)
    q, k, v, o, do = (torch.empty(bh, n, 64, dtype=torch.bfloat16, device="meta")
                      for _ in range(5))
    kb = torch.empty(b, n, device="meta")
    lse = torch.empty(bh, n, device="meta")
    seed = torch.empty(1, dtype=torch.int32, device="meta")
    wrapper = ROUTED[row][0]
    args = {1: (q, k, v, kb, 0.125), 2: (q, k, v, kb, o, do, lse, 0.125),
            3: (q, k, v, kb, seed, 0.125, 0.1),
            4: (q, k, v, kb, seed, o, do, lse, 0.125, 0.1)}[row]
    before = wrapper.launches
    wrapper(*args)
    return loaded, wrapper.launches - before


ROUTE_CASES = [
    (1, "sm90"), (40, "sm90"), (197, "sm90"), (237, "sm90"), (256, "sm90"),
    (257, "sm90_stream"), (512, "sm90_stream"),
]
# the backward's: every N the fused backward takes, on the sm90 kernels
BWD_ROUTE_CASES = [
    (1, "sm90"), (40, "sm90"), (197, "sm90"), (237, "sm90"), (256, "sm90"),
    (257, "sm90"), (333, "sm90"), (512, "sm90"),
]


def _check_route(monkeypatch, row: int, n: int, route: str):
    """Row `row`'s route at N keys, and the wrapper loads the entry of that
    route (its source, symbol and argument types), and only that, and
    counts one launch."""
    _, route_of, sm90, stream = ROUTED[row]
    limit = fa.SM90_FWD_MAX_N if route_of is fa.fwd_route else fa.SM90_BWD_MAX_N
    assert route_of(n) == route
    assert (n <= limit) == (route == "sm90") and n <= fa.LONG_SEQ_THRESHOLD
    loaded, launches = _routed_launch(monkeypatch, row, n)
    assert loaded == [sm90 if route == "sm90" else stream] and launches == 1
    source, symbol, _ = loaded[0]
    assert f'extern "C" int {symbol}(' in (fa._build.CSRC / f"{source}.cu").read_text()


@pytest.mark.parametrize("row", [1, 3])
@pytest.mark.parametrize("n,route", ROUTE_CASES)
def test_route_by_length(monkeypatch, row, n, route):
    """Rows of up to 256 keys take row 1's short sm90 forward, with or
    without the dropout mask; longer ones, up to LONG_SEQ_THRESHOLD, the
    streamed kernel of flash_attention_long_sm90.cu, row 5's, by its one
    entry. Each kernel has one entry for both rows."""
    _check_route(monkeypatch, row, n, route)


@pytest.mark.parametrize("n,route", BWD_ROUTE_CASES)
def test_row2_route_by_length(monkeypatch, n, route):
    """Row 2 takes the sm90 backward's one entry (no seed) at every N up to
    LONG_SEQ_THRESHOLD, past 256 keys too."""
    _check_route(monkeypatch, 2, n, route)


@pytest.mark.parametrize("n,route", BWD_ROUTE_CASES)
def test_row4_route_by_length(monkeypatch, n, route):
    """Row 4 takes the same entry (with its seed) at every N up to
    LONG_SEQ_THRESHOLD: a unit's B-side pair in one head slot past about
    320 keys."""
    _check_route(monkeypatch, 4, n, route)


def test_bwd_route_is_sm90_for_every_n_the_fused_backward_takes():
    """No N up to 512 leaves the sm90 backward, the threshold is the fused
    backward's own, and a longer row (the plain chain's backward) is refused."""
    assert fa.SM90_BWD_MAX_N == fa.LONG_SEQ_THRESHOLD == 512
    assert {fa.bwd_route(n) for n in range(1, 513)} == {"sm90"}
    with pytest.raises(ValueError):
        fa.bwd_route(513)
    assert "mma_sync" not in "".join(str(r[3]) for r in ROUTED.values() if r[1] is fa.bwd_route)
    assert not (fa._build.CSRC / "flash_attention_bwd.cu").exists()
    assert "flash_attention_bwd" not in fa._build.KERNELS


@pytest.mark.parametrize("bh,n,width,grid,tail", [
    (384, 40, 48, 132, 48),     # pretrain text stream: one 48-wide slab
    (384, 197, 208, 132, 16),   # image: three 64-wide slabs and a 16-wide one
    (384, 237, 240, 132, 48),   # MLM fused rows
    (1152, 237, 240, 132, 48),  # ITM fused pair rows
    (96, 256, 256, 96, 0),      # four whole slabs; fewer heads than SMs
])
def test_row4_widths_grid_and_slabs_at_path_shapes(bh, n, width, grid, tail):
    """The key width is N rounded up to 16 (as row 1's), walked in 64-wide
    slabs and a tail of width % 64; the grid is persistent, one CTA per SM
    or per head: at these shapes a work unit is a whole head."""
    assert fa.fwd_sm90_tile(n) == width and width % 64 == tail
    assert 0 <= width - n < 16
    assert fa.fwd_sm90_grid(bh, H100_SMS) == grid
    tiles = -(-n // fa.SM90_FWD_BOX)
    assert (tiles - 1) * 64 < n <= tiles * 64
    assert fa.bwd_sm90_units(bh, n, H100_SMS) == (tiles, grid)


@pytest.mark.parametrize("role", ["dq", "dkdv"])
@pytest.mark.parametrize("nt", range(16, 257, 16))
def test_row4_shared_memory_budget(nt, role):
    """Both kernels fit a block at every key width with at least two head
    slots (so the next head loads while one computes) and two tile stages,
    at most four of each; the slots hold the B-side pair of a head."""
    lay = fa.bwd_sm90_layout(nt, role, 64)
    assert 2 <= lay["head_slots"] <= fa.SM90_FWD_MAX_SLOTS
    assert 2 <= lay["tile_stages"] <= fa.SM90_FWD_MAX_SLOTS
    assert lay["smem"] <= SMEM_LIMIT
    rows = -(-nt // 64) * 64
    boxes = 3 if role == "dq" else 2
    assert lay["smem"] >= (lay["head_slots"] * 2 * rows * 128
                           + lay["tile_stages"] * boxes * 64 * 128)


@pytest.mark.parametrize("role", ["dq", "dkdv"])
@pytest.mark.parametrize("nt", range(16, 513, 16))
def test_row4_layout_fits_the_block_up_to_512(nt, role):
    """At every key width up to 512 both kernels fit a block with two to four
    tile stages and one to four head slots; two slots (the next unit's pair
    loading while one computes) wherever two still leave two stages, one
    past that (from 336 keys: a slot holds 2 x 384 rows of 128 bytes)."""
    lay = fa.bwd_sm90_layout(nt, role, 64)
    assert 2 <= lay["tile_stages"] <= fa.SM90_FWD_MAX_SLOTS
    assert 1 <= lay["head_slots"] <= fa.SM90_FWD_MAX_SLOTS
    assert lay["smem"] <= SMEM_LIMIT
    assert (lay["head_slots"] >= 2) == (nt <= 320)
    rows = -(-nt // 64) * 64
    boxes = 3 if role == "dq" else 2
    assert lay["smem"] >= (lay["head_slots"] * 2 * rows * 128
                           + lay["tile_stages"] * boxes * 64 * 128)


@pytest.mark.parametrize("bh,n,tpg,grid", [
    (96, 512, 2, 33),     # off-path batch 8 at N = 512: four groups of two tiles
    (96, 256, 4, 96),     # N = 256: no grouping shortens the busiest CTA
    (96, 333, 6, 96),     # ragged 333 (six tiles): whole heads
    (96, 40, 1, 96),      # one tile a head
    (384, 512, 8, 132),   # pretrain_txt's batch 32 x 12 heads: whole heads
    (384, 237, 4, 132),   # pretrain_mum's shapes keep whole heads
    (1152, 237, 4, 132),
])
def test_row4_work_units(bh, n, tpg, grid):
    """Work units are a head and a group of `tpg` of its 64-row tiles, one
    row of `grid` CTAs per group; the CTAs fill at least min(SMs, units)
    and at most the SMs, and the grouping shortens the busiest warpgroup's
    run of tiles or is a whole head."""
    tiles = -(-n // 64)
    assert fa.bwd_sm90_units(bh, n, H100_SMS) == (tpg, grid)
    groups = -(-tiles // tpg)
    assert min(H100_SMS, bh * groups) <= grid * groups <= H100_SMS or groups == 1
    assert grid == min(bh, H100_SMS) if groups == 1 else grid <= bh

    def busiest(t):
        g = max(1, min(bh, H100_SMS // -(-tiles // t)))
        return -(-(-(-bh // g) * t) // 2)
    assert busiest(tpg) == min(busiest(t) for t in range(1, tiles + 1))
    assert all(busiest(t) > busiest(tpg) for t in range(tpg + 1, tiles + 1))


@pytest.mark.parametrize("nt,role,slots,stages,smem", [
    (48, "dq", 4, 4, 166016), (48, "dkdv", 4, 4, 134272),
    (208, "dq", 2, 3, 208000), (240, "dq", 2, 3, 208000),
    (240, "dkdv", 2, 4, 201856), (256, "dkdv", 2, 4, 201856),
])
def test_row4_layout_at_path_widths(nt, role, slots, stages, smem):
    """The mirror of the source's `layout` at the path's widths (the source
    reports its own through `flash_attention_bwd_sm90_smem`, which
    `chip_smoke.py` holds against this mirror on the card), and the
    constants the mirror shares with the source."""
    lay = fa.bwd_sm90_layout(nt, role, 64)
    assert (lay["head_slots"], lay["tile_stages"], lay["smem"]) == (slots, stages, smem)
    src = BWD_SRC.read_text()
    for const in ("BOX = 64;", "MAX_SLOTS = 4;", "SMEM_LIMIT = 232448;",
                  "BAR_BYTES = 8 * 4 * MAX_SLOTS;"):
        assert f"constexpr int {const}" in src
    assert "constexpr int box_bytes(int d) { return BOX * d * 2; }" in src
    assert "L.head = 2 * L.ntb * d * 2;" in src
    assert SMEM_LIMIT == 232448 and fa.SM90_FWD_BOX == 64 and 64 in fa.HEAD_DIMS


def _ring_early_waits(stages: int, tiles: int, release_wait: bool, trials: int) -> int:
    """Runs the backward's tile ring under random schedules and counts the
    consumer waits that pass before their tile has landed. The producer
    loads tile u into stage u % stages once tile u - stages is released;
    loads land in any order; warpgroup u % 2 waits for tile u on the
    stage's full barrier by the parity (u // stages) & 1, which an mbarrier
    passes while the stage's current phase has the other parity. With
    `release_wait` it first waits, as the source does, on the stage's empty
    barrier by the producer's parity for tile u, ((u // stages) & 1) ^ 1."""
    import random
    rng = random.Random(stages * 1000 + tiles)
    early = 0
    for _ in range(trials):
        full = [0] * stages      # completed phases of each stage's full barrier
        empty = [0] * stages     # ... and of its empty barrier (tiles released)
        issued, landed = 0, set()
        nxt = [0, 1]             # each warpgroup's next tile
        step = [0, 0]            # 0: before its waits, 1: released seen, 2: holding
        while min(nxt) < tiles or 2 in step:
            moves = []
            if issued < tiles and empty[issued % stages] >= issued // stages:
                moves.append(("issue", 0))
            moves += [("land", u) for u in range(issued) if u not in landed]
            for w in (0, 1):
                u, st = nxt[w], nxt[w] % stages
                if step[w] == 2:
                    moves.append(("release", w))
                elif u >= tiles:
                    continue
                elif step[w] == 0 and release_wait:
                    if empty[st] % 2 != ((u // stages) & 1) ^ 1:
                        moves.append(("released", w))
                elif full[st] % 2 != (u // stages) & 1:
                    moves.append(("wait", w))
            if not moves:  # a schedule the race has wedged
                break
            kind, arg = rng.choice(moves)
            if kind == "issue":
                issued += 1
            elif kind == "land":
                landed.add(arg)
                full[arg % stages] += 1
            elif kind == "released":
                step[arg] = 1
            elif kind == "wait":
                early += nxt[arg] not in landed
                step[arg] = 2
            else:
                empty[nxt[arg] % stages] += 1
                step[arg], nxt[arg] = 0, nxt[arg] + 2
    return early


@pytest.mark.parametrize("stages", [2, 3, 4])
def test_row4_ring_waits_pass_only_for_landed_tiles(stages):
    """Rows 2 and 4 take alternate tiles from one ring in two warpgroups
    by parity waits, which cannot tell a phase from the one two phases
    earlier. With an odd stage count (3: the dq kernel at key widths
    208-256 and 464-512, the dk/dv kernel at 272-320) a stage's previous
    tile is the other warpgroup's, and a warpgroup that runs ahead can pass
    its wait before its tile has landed. The source's first wait, for the
    stage's previous tile to be released, leaves no such schedule at any
    stage count; the model finds the race without it, so it has teeth."""
    src = BWD_SRC.read_text()
    assert ("      mbar_wait(tempty0 + 8 * st, ((u / L.ts) & 1) ^ 1);\n"
            "      mbar_wait(tfull0 + 8 * st, (u / L.ts) & 1);\n") in src
    assert {fa.bwd_sm90_layout(nt, r, 64)["tile_stages"] for nt in range(16, 513, 16)
            for r in ("dq", "dkdv")} <= {2, 3, 4}
    assert _ring_early_waits(stages, 12, release_wait=True, trials=300) == 0
    unguarded = _ring_early_waits(stages, 12, release_wait=False, trials=300)
    assert (unguarded > 0) == (stages % 2 == 1)


@pytest.mark.parametrize("bh,n", [(384, 40), (384, 197), (1152, 237), (96, 256)])
def test_row4_map_extents(bh, n):
    """q, k, v, o and do take the forward's 3D map: (D, N, BH) in 64-row
    boxes that stop at the head's N, byte strides TMA accepts."""
    src, extents = fa._MAP_KINDS["bwd"]
    assert src == "flash_attention_bwd_sm90"
    dims, strides, box = extents(bh, n, 64)
    assert dims == (64, n, bh) and box == (64, 64, 1)
    assert all(s % 16 == 0 for s in strides)


def test_row4_maps_are_encoded_once_and_the_cache_is_bounded(monkeypatch):
    calls = []

    def fake_load(name, argtypes, symbol=None):
        assert symbol == f"{name}_encode"

        def encode(buf, ptr, rank, dims, strides, box):
            calls.append((name, ptr, tuple(dims), tuple(box)))
            return 0
        return encode

    monkeypatch.setattr(fa._build, "load", fake_load)
    monkeypatch.setattr(fa, "_MAPS", {})
    monkeypatch.setattr(fa, "_MAPS_CAP", 3)
    q = torch.zeros(12, 197, 64, dtype=torch.bfloat16)
    first = fa._map("bwd", q)
    assert fa._map("bwd", q) is first
    assert fa._map("short", q) is not first  # the forward's own map
    assert calls == [
        ("flash_attention_bwd_sm90", q.data_ptr(), (64, 197, 12), (64, 64, 1)),
        ("flash_attention_fwd_sm90", q.data_ptr(), (64, 197, 12), (64, 64, 1))]
    for _ in range(4):
        fa._map("bwd", torch.zeros(3, 40, 64, dtype=torch.bfloat16))
        assert len(fa._MAPS) <= 3


def _bwd_args(bh=24, n=237, b=2):
    kb, q, k, v = _attn_args(bh=bh, n=n, b=b)
    o, do = torch.zeros_like(q), torch.zeros_like(q)
    return (q, k, v, kb, torch.zeros(1, dtype=torch.int32), o, do,
            torch.zeros(bh, n))


@pytest.mark.parametrize("n,cap", [(40, 1), (237, 2), (256, 256)])
def test_row4_launch_passes_live_maps_across_an_eviction(monkeypatch, n, cap):
    """Five maps per launch (q, k, v, o, do): each one the kernel receives
    is the one encoded for its tensor, even where the cache empties itself
    between two lookups; then the bias, seed, lse, delta, dq, dk, dv
    pointers (a null row index), (bh, heads, the heads' total and first, n,
    key width, grid, tiles per unit), the scale and the dropout threshold
    and factor."""
    calls, seen, launches = [], [], []

    def kernel(*args):
        seen.append([_map_bytes(m) for m in args[:5]])
        launches.append(args[5:])
        return 0

    def fake_load(name, argtypes, symbol=None):
        assert name == "flash_attention_bwd_sm90"
        if symbol == "flash_attention_bwd_sm90_encode":
            return _fake_encoder(calls)
        assert symbol is None and argtypes is fa._BWD_SM90_ARGS and len(argtypes) == 26
        return kernel

    monkeypatch.setattr(fa._build, "load", fake_load)
    monkeypatch.setattr(fa, "_MAPS", {})
    monkeypatch.setattr(fa, "_MAPS_CAP", cap)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    monkeypatch.setattr(fa, "_sm_count", lambda dev: H100_SMS)
    q, k, v, kb, seed, o, do, lse = _bwd_args(n=n)
    for _ in range(2):
        dq, dk, dv = fa._launch_bwd_sm90(q, k, v, kb, seed, o, do, lse, 0.125, 0.1)
    assert dq.shape == dk.shape == dv.shape == q.shape
    for maps in seen:
        assert [struct.unpack("<q", b[:8])[0] for b in maps] == [
            t.data_ptr() for t in (q, k, v, o, do)]
    rest = launches[-1]
    assert rest[0] == kb.data_ptr() and rest[1] == seed.data_ptr() and rest[2] is None
    assert rest[3] == lse.data_ptr()
    assert rest[8:16] == (24, 12, 12, 0, n, fa.fwd_sm90_tile(n),
                          *fa.bwd_sm90_units(24, n, H100_SMS)[::-1])
    assert rest[16:] == (0.125, fa.dropout_threshold(0.1), fa.dropout_scale(0.1), 64, 0)
    assert len(fa._MAPS) <= cap


def _fake_sm90_loader(monkeypatch, source, entry, nargs, cap):
    """A loader for `source`'s encoder and its `entry` (checked to be given
    `nargs` argument types): the kernel records the maps' bytes and the
    rest of its arguments."""
    calls, launches = [], []

    def kernel(*args):
        launches.append(args)
        return 0

    def fake_load(name, argtypes, symbol=None):
        assert name == source
        if symbol == f"{source}_encode":
            return _fake_encoder(calls)
        assert (symbol or name) == entry and len(argtypes) == nargs
        return kernel

    monkeypatch.setattr(fa._build, "load", fake_load)
    monkeypatch.setattr(fa, "_MAPS", {})
    monkeypatch.setattr(fa, "_MAPS_CAP", cap)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    monkeypatch.setattr(fa, "_sm_count", lambda dev: H100_SMS)
    return launches


def _map_addresses(args, count):
    return [struct.unpack("<q", _map_bytes(m)[:8])[0] for m in args[:count]]


@pytest.mark.parametrize("n,cap", [(40, 1), (237, 2), (256, 256)])
def test_row2_launch_passes_live_maps_across_an_eviction(monkeypatch, n, cap):
    """Row 2 on the sm90 backward: its one entry (`flash_attention_bwd_sm90`)
    with a null seed and row index, no dropout (threshold 0, factor 1),
    gets the five maps of q, k, v, o, do, live across a cache eviction;
    then the bias, lse, delta, dq, dk, dv pointers, (bh, heads, the heads'
    total and first, n, key width, grid, tiles per unit), the scale and the
    stream."""
    launches = _fake_sm90_loader(monkeypatch, "flash_attention_bwd_sm90",
                                 "flash_attention_bwd_sm90", 26, cap)
    q, k, v, kb, _, o, do, lse = _bwd_args(n=n)
    for _ in range(2):
        dq, dk, dv = fa._launch_bwd_sm90(q, k, v, kb, None, o, do, lse, 0.125)
        assert _map_addresses(launches[-1], 5) == [t.data_ptr() for t in (q, k, v, o, do)]
    assert dq.shape == dk.shape == dv.shape == q.shape
    rest = launches[-1][5:]
    assert len(launches[-1]) == len(fa._BWD_SM90_ARGS) == 26
    assert rest[0] == kb.data_ptr() and rest[1] is None and rest[2] is None
    assert rest[3] == lse.data_ptr()
    assert rest[5:8] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    tpg, grid = fa.bwd_sm90_units(24, n, H100_SMS)
    assert rest[8:16] == (24, 12, 12, 0, n, fa.fwd_sm90_tile(n), grid, tpg)
    assert rest[16:] == (0.125, 0, 1.0, 64, 0)
    assert len(fa._MAPS) <= cap


@pytest.mark.parametrize("n,cap", [(40, 1), (197, 2), (256, 256)])
def test_row3_launch_passes_live_maps_across_an_eviction(monkeypatch, n, cap):
    """Row 3 on row 1's sm90 forward: its one entry
    (`flash_attention_fwd_sm90`) with the seed gets row 1's "short" maps of
    q, k, v, live across a cache eviction; then the bias, seed, row index
    (the global rows of a process's share of the batch), out, lse
    pointers, row 1's (bh, heads, the heads' total and first, n, key width,
    grid), the scale, the uint32 threshold, the fp32 factor and the
    stream."""
    launches = _fake_sm90_loader(monkeypatch, "flash_attention_fwd_sm90",
                                 "flash_attention_fwd_sm90", 20, cap)
    kb, q, k, v = _attn_args(bh=24, n=n, b=2)
    seed = torch.zeros(1, dtype=torch.int32)
    rows = torch.tensor([4, 5], dtype=torch.int32)
    for _ in range(2):
        out, lse = fa._launch_fwd_sm90(q, k, v, kb, 0.125, seed, 0.1, rows)
        assert _map_addresses(launches[-1], 3) == [t.data_ptr() for t in (q, k, v)]
    assert out.shape == q.shape and lse.shape == (24, n)
    rest = launches[-1][3:]
    assert len(launches[-1]) == len(fa._FWD_SM90_ARGS) == 20
    assert rest[:5] == (kb.data_ptr(), seed.data_ptr(), rows.data_ptr(), out.data_ptr(),
                        lse.data_ptr())
    assert rest[5:12] == (24, 12, 12, 0, n, fa.fwd_sm90_tile(n),
                          fa.fwd_sm90_grid(24, H100_SMS))
    assert rest[12:] == (0.125, fa.dropout_threshold(0.1), fa.dropout_scale(0.1), 64, 0)
    assert fa.dropout_threshold(0.1) == 429496729
    assert len(fa._MAPS) <= cap
    assert all(key[0] == "short" for key in fa._MAPS)


@pytest.mark.parametrize("bad", [
    {"lse_dtype": torch.bfloat16}, {"lse_shape": (24, 236)}, {"seed_dtype": torch.int64},
    {"seed_len": 2}, {"d": 16}, {"bias_n": 200},
])
def test_row4_checks_raise(bad):
    """What the backward kernels refuse: an lse not fp32 (BH, N), a seed not
    one int32, and the forward's shape rules for q, k, v, o, do and bias."""
    kb, q, k, v = _attn_args(bh=24, n=197, b=2, d=bad.get("d", 64),
                             bias_n=bad.get("bias_n"))
    lse = torch.zeros(bad.get("lse_shape", (24, 197)), dtype=bad.get("lse_dtype", torch.float32))
    seed = torch.zeros(bad.get("seed_len", 1), dtype=bad.get("seed_dtype", torch.int32))
    with pytest.raises(ValueError):
        fa._check("flash_attention_bwd_drop", kb, q, k, v, q.clone(), q.clone(), lse=lse,
                  seed=seed)


def test_row4_checks_pass_the_path_shape():
    q, k, v, kb, seed, o, do, lse = _bwd_args(bh=1152, n=237, b=96)
    fa._check("flash_attention_bwd_drop", kb, q, k, v, o, do, lse=lse, seed=seed)


# ------------------------------------------- row 10: row 9's kernel with dropout

@pytest.mark.parametrize("m,grid,splits", [
    (64, 1, 2),        # one tile, its hidden over a cluster of two
    (1000, 16, 2),     # ragged, split
    (1280, 20, 2),     # the int8 finetune_vqa step's text rows: 40 CTAs
    (4999, 80, 1),     # ragged, clusters along M
    (6304, 100, 1),    # image rows: 99 tiles and a cluster's spare
    (7584, 120, 1),    # fused rows: 119 tiles and a spare
])
def test_row10_grid_and_splits_at_path_shapes(m, grid, splits):
    """Row 10 takes row 9's grid: the hidden split over a cluster of two
    while the doubled tiles fit one wave, else clusters of two along M."""
    assert qf.mlp_splits(m, HIDDEN, H100_SMS) == splits
    assert qf.mlp_grid(m, splits) == grid
    assert grid * splits <= H100_SMS or splits == 1


@pytest.mark.parametrize("m", [64, 1280, 7584])
def test_row10_bits_map_extents(m):
    """The int16 bits (M, H) are mapped as (M, 2 H) bytes in qW1's box: 64
    rows of one chunk's 64 values (128 bytes) in the 128-byte swizzle, so
    a chunk's bits are one 8 KB box."""
    dims, strides, box, swizzle = qf.mlp_map_extents(m, 2 * HIDDEN, "bits")
    assert dims == (2 * HIDDEN, m) and strides == (2 * HIDDEN,)
    assert box == (2 * qf.HIDDEN_CHUNK, qf.MLP_ROW_TILE) and swizzle == 128
    assert box[0] * box[1] == qf.MLP_BOX_BYTES
    assert qf.MLP_BOXES["bits"] == qf.MLP_BOXES["w1"]


def test_row10_shared_memory_budget():
    """Two 8 KB bits slots past the barriers, within a block's shared
    memory (the kernel reports its own through `w8a8_mlp_sm90_smem(1)`,
    held against this on the card by `chip_smoke.py`)."""
    assert qf.mlp_smem(drop=True) == qf.mlp_smem() + 2 * qf.MLP_BOX_BYTES <= SMEM_LIMIT
    assert qf.mlp_smem(drop=True) == 183296


def test_row10_bits_maps_are_encoded_once_and_the_cache_is_bounded(monkeypatch):
    calls = []

    def fake_load(name, argtypes, symbol=None):
        assert (name, symbol) == ("w8a8_mlp_sm90", "w8a8_mlp_sm90_encode")

        def encode(buf, ptr, rows, cols, box_cols, box_rows, swizzle):
            calls.append((ptr, rows, cols, box_cols, box_rows, swizzle))
            return 0
        return encode

    monkeypatch.setattr(qf._build, "load", fake_load)
    monkeypatch.setattr(qf, "_MAPS", {})
    monkeypatch.setattr(qf, "_MAPS_CAP", 3)
    bits = torch.zeros(1280, HIDDEN, dtype=torch.int16)
    first = qf._mlp_map(bits, "bits")
    assert qf._mlp_map(bits, "bits") is first
    assert calls == [(bits.data_ptr(), 1280, 2 * HIDDEN, 128, 64, 128)]
    keep = [torch.zeros(m, HIDDEN, dtype=torch.int16) for m in (6304, 7584, 64, 1000)]
    for t in keep:
        qf._mlp_map(t, "bits")
        assert len(qf._MAPS) <= 3
    assert len(calls) == 5


@pytest.mark.parametrize("m,cap", [(64, 1), (1280, 2), (7584, 256)])
def test_row10_launch_passes_live_maps_across_an_eviction(monkeypatch, m, cap):
    """The DROP entry gets three live maps (qW1, qW2, the bits), the split's
    scratch where it splits, the grid and split, then the threshold and the
    keep factor."""
    calls, seen, launches = [], [], []

    def kernel(*args):
        seen.append([_map_bytes(t) for t in args[:3]])
        launches.append(args[3:])
        return 0

    def fake_load(name, argtypes, symbol=None):
        assert name == "w8a8_mlp_sm90"
        if symbol == "w8a8_mlp_sm90_encode":
            return _fake_encoder(calls)
        assert symbol == "w8a8_mlp_sm90_drop" and len(argtypes) == 19
        return kernel

    monkeypatch.setattr(qf._build, "load", fake_load)
    monkeypatch.setattr(qf, "_MAPS", {})
    monkeypatch.setattr(qf, "_MAPS_CAP", cap)
    monkeypatch.setattr(qf, "_sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(qf.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    args = _w8a8_args(m=m)
    bits = torch.zeros(m, HIDDEN, dtype=torch.int16)
    for _ in range(2):
        assert qf._launch_mlp_sm90(*args, bits, 6554).shape == (m, 768)
    for maps in seen:
        assert [struct.unpack("<q", b[:8])[0] for b in maps] == [
            args[1].data_ptr(), args[4].data_ptr(), bits.data_ptr()]
    splits = qf.mlp_splits(m, HIDDEN, H100_SMS)
    rest = launches[-1]
    part, shs = rest[6:8]
    assert (part is None) == (shs is None) == (splits == 1)
    assert rest[8:] == (m, 768, HIDDEN, qf.mlp_grid(m, splits), splits, 6554,
                        qf.keep_scale16(6554), 0)
    assert len(qf._MAPS) <= cap


@pytest.mark.parametrize("bad", [
    {"bits_dtype": torch.int32},     # bits int16
    {"bits_shape": (64, HIDDEN // 2)},
    {"bits_shape": (32, HIDDEN)},
    {"threshold": 0},                # a threshold in (0, 65536)
    {"threshold": 65536},
    {"k": 512},                      # row 9's shape rules hold too
])
def test_row10_checks_raise(bad):
    args = _w8a8_args(k=bad.get("k", 768))
    bits = torch.zeros(bad.get("bits_shape", (64, HIDDEN)), dtype=bad.get("bits_dtype",
                                                                          torch.int16))
    with pytest.raises(ValueError):
        qf._launch_mlp_sm90(*args, bits, bad.get("threshold", 6554))


# ------------------------------- rows 1 and 3 past 256 keys: the streamed kernel

STREAM_SRC = fa._build.CSRC / "flash_attention_long_sm90.cu"


@pytest.mark.parametrize("bh,n,tiles,ctas", [
    (96, 333, 3, 132),     # row 1 / 3 at batch 8, a ragged N
    (96, 512, 4, 132),     # the fused backward's longest
    (96, 577, 5, 132),     # 384^2 images
    (384, 512, 4, 132),    # pretrain_txt, batch 32
    (384, 333, 3, 132),
    (12, 300, 3, 36),      # fewer items than SMs: a CTA each
    (3, 257, 3, 9),
])
def test_stream_work_items_and_grid(bh, n, tiles, ctas):
    """Past 256 keys rows 1 and 3 take the streamed kernel: work items of
    128 query rows (tiles x BH, the last tile ragged unless N is a multiple
    of 128) on a persistent grid of one CTA per SM, or one per item where
    there are fewer; every CTA's share differs from another's by at most
    one item."""
    assert fa.fwd_route(n) == "sm90_stream"
    assert fa.long_grid(bh, n) == (tiles, bh)
    assert (tiles - 1) * fa.LONG_TILE < n <= tiles * fa.LONG_TILE
    assert fa.long_ctas(bh, n, H100_SMS) == ctas
    shares = [len(range(c, tiles * bh, ctas)) for c in range(ctas)]
    assert sum(shares) == tiles * bh and max(shares) - min(shares) <= 1


def test_stream_shared_memory_matches_its_source():
    """The host's mirror of the streamed kernel's layout (which
    `chip_smoke.py` holds against `flash_attention_long_sm90_smem` on the
    card) and the constants it shares with the source: two Q slots and
    three stages of 16 KB K and V blocks, 117 KB under a block's limit."""
    src = STREAM_SRC.read_text()
    for const in ("TILE = BK * D * 2;", "BQ = 128;", "BK = 128;", f"NS = {fa.LONG_STAGES};",
                  f"QS = {fa.LONG_Q_SLOTS};", "THREADS = 384;",
                  "SMEM = BAR_OFF + 8 * (2 * QS + 2 * NS) + 1024;"):
        assert f"constexpr int {const}" in src, const
    assert fa.LONG_TILE == 128 and 64 in fa.HEAD_DIMS
    assert fa.stream_smem(64) == 2 * 16384 + 6 * 16384 + 3 * 512 + 80 + 1024 == 133712
    assert fa.stream_smem(64) <= SMEM_LIMIT


def test_stream_entry_checks_its_launch():
    """The one C entry of rows 5, 1 and 3 refuses what it cannot run (a
    seed without an lse, a tile count that does not cover N, a grid
    beyond the items), picks its variant by the null pointers, and its
    argument list is the wrapper's."""
    src = STREAM_SRC.read_text()
    entry = src[src.index('extern "C" int flash_attention_long_sm90('):]
    for guard in ("tiles != (n + BQ - 1) / BQ", "grid <= 0 || grid > bh * tiles",
                  "(seed != nullptr && lse == nullptr)",
                  "(row_index != nullptr && seed == nullptr)"):
        assert guard in entry, guard
    assert "if (lse == nullptr)\n    return launch<false, false>" in entry
    assert "if (seed == nullptr)\n    return launch<true, false>" in entry
    assert "return launch<true, true>" in entry
    head = entry[:entry.index("{")]
    assert head.count(",") + 1 == len(fa._FWD_LONG_ARGS) == 20
    assert not (fa._build.CSRC / "flash_attention_fwd.cu").exists()
    assert not (fa._build.CSRC / "mma_bf16.cuh").exists()
    assert "flash_attention_fwd" not in fa._build.KERNELS
    assert all("mma_bf16" not in p.read_text() for p in fa._build.CSRC.iterdir())


@pytest.mark.parametrize("row", [1, 3])
@pytest.mark.parametrize("n,cap", [(257, 1), (333, 2), (512, 256)])
def test_stream_launch_passes_live_maps_across_an_eviction(monkeypatch, row, n, cap):
    """Rows 1 and 3 past 256 keys: the streamed kernel's one entry gets the
    "long" maps of q, k, v (row 5's cache) live across an eviction; then
    the bias, the seed and row index (null for row 1), out and lse
    pointers, (bh, heads, the heads' total and first, n, tiles, CTAs), the
    scale, the threshold and factor (0 and 1 without dropout) and the
    stream."""
    launches = _fake_sm90_loader(monkeypatch, "flash_attention_long_sm90",
                                 "flash_attention_long_sm90", 20, cap)
    monkeypatch.setattr(fa, "_sm_count", lambda dev: H100_SMS)
    kb, q, k, v = _attn_args(bh=24, n=n, b=2)
    seed = torch.zeros(1, dtype=torch.int32) if row == 3 else None
    rows = torch.tensor([6, 7], dtype=torch.int32) if row == 3 else None
    for _ in range(2):
        out, lse = fa._launch_fwd(q, k, v, kb, 0.125, seed, 0.1 if seed is not None else 0.0,
                                  rows)
        assert _map_addresses(launches[-1], 3) == [t.data_ptr() for t in (q, k, v)]
    assert out.shape == q.shape and lse.shape == (24, n)
    rest = launches[-1][3:]
    assert rest[:5] == (kb.data_ptr(), None if seed is None else seed.data_ptr(),
                        None if rows is None else rows.data_ptr(), out.data_ptr(),
                        lse.data_ptr())
    tiles, _ = fa.long_grid(24, n)
    assert rest[5:12] == (24, 12, 12, 0, n, tiles, fa.long_ctas(24, n, H100_SMS))
    if seed is None:
        assert rest[12:] == (0.125, 0, 1.0, 64, 0)
    else:
        assert rest[12:] == (0.125, fa.dropout_threshold(0.1), fa.dropout_scale(0.1), 64, 0)
    assert len(fa._MAPS) <= cap
    assert all(key[0] == "long" for key in fa._MAPS)


def _shared_ring_faults(stages: int, uses: int, release_count: int, trials: int) -> int:
    """Runs a ring that both warpgroups read in full (the streamed kernel's
    K/V stages and Q slots, the short forward's head slots) under random
    schedules, and counts the faults: a consumer wait that passes before
    its load has landed, a load issued into a stage that a warpgroup still
    reads, and a schedule that wedges. The producer waits for use u's stage
    on its empty barrier by the parity ((u // stages) & 1) ^ 1, each
    warpgroup for use u on the full barrier by (u // stages) & 1 (an
    mbarrier passes while its current phase has the other parity), reads,
    and arrives on the empty barrier; the empty phase completes after
    `release_count` arrivals (the source's count of 8 is both warpgroups'
    4 warps: 2 here)."""
    import random
    rng = random.Random(stages * 1000 + uses + release_count)
    faults = 0
    for _ in range(trials):
        full, empty, arrivals = [0] * stages, [0] * stages, [0] * stages
        issued, landed = 0, set()
        released = [set() for _ in range(uses)]
        nxt, holding = [0, 0], [False, False]
        while min(nxt) < uses or any(holding):
            moves = []
            if issued < uses and empty[issued % stages] % 2 == (issued // stages) & 1:
                moves.append(("issue", 0))
            moves += [("land", u) for u in range(issued) if u not in landed]
            for w in (0, 1):
                u = nxt[w]
                if holding[w]:
                    moves.append(("release", w))
                elif u < uses and full[u % stages] % 2 != (u // stages) & 1:
                    moves.append(("wait", w))
            if not moves:
                faults += 1
                break
            kind, arg = rng.choice(moves)
            if kind == "issue":
                faults += issued >= stages and len(released[issued - stages]) < 2
                issued += 1
            elif kind == "land":
                landed.add(arg)
                full[arg % stages] += 1
            elif kind == "wait":
                faults += nxt[arg] not in landed
                holding[arg] = True
            else:
                u = nxt[arg]
                released[u].add(arg)
                arrivals[u % stages] += 1
                if arrivals[u % stages] == release_count:
                    arrivals[u % stages] = 0
                    empty[u % stages] += 1
                holding[arg], nxt[arg] = False, u + 1
    return faults


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_shared_rings_of_rows_1_3_5_wait_only_for_landed_loads(stages):
    """The audit of the forward's rings (rows 1, 3 and 5): each is read in
    full by both warpgroups, and its empty barriers count every consumer
    warp, so a warpgroup runs at most one ring's length ahead of the other
    and no parity wait meets the phase two before its own; the model finds
    no fault at any stage count. Counting one warpgroup's release (as if
    each stage were read by one) lets the producer overwrite a stage the
    other still reads, which the model finds, so it has teeth."""
    stream = STREAM_SRC.read_text()
    short = (fa._build.CSRC / "flash_attention_fwd_sm90.cu").read_text()
    assert "mbar_init(qempty0 + 8 * s, 8);" in stream
    assert all("mbar_init(empty0 + 8 * s, 8);" in src for src in (stream, short))
    assert "mbar_wait(empty0 + 8 * s, kr.phase ^ 1u);" in stream
    assert "mbar_wait(full0 + 8 * kr.slot, kr.phase);" in stream
    assert "mbar_arrive(empty0 + 8 * prev.slot);" in stream
    assert "mbar_wait(qempty0 + 8 * qr.slot, qr.phase ^ 1u);" in stream
    assert "mbar_wait(qfull0 + 8 * qr.slot, qr.phase);" in stream
    assert _shared_ring_faults(stages, 10, release_count=2, trials=300) == 0
    assert _shared_ring_faults(stages, 10, release_count=1, trials=300) > 0


# ------------------------------------- rows 3 and 4: the global row index

@pytest.mark.parametrize("bad", [
    {"dtype": torch.int64}, {"shape": (3,)}, {"shape": (2, 1)}, {"strided": True},
])
def test_row_index_checks_raise(bad):
    """What rows 3 and 4 refuse as a row index: not int32, not (B,), not
    contiguous."""
    kb, q, k, v = _attn_args(bh=24, n=197, b=2)
    seed = torch.zeros(1, dtype=torch.int32)
    shape = bad.get("shape", (2,))
    rows = torch.arange(4 if bad.get("strided") else math.prod(shape),
                        dtype=bad.get("dtype", torch.int32))
    rows = rows[::2] if bad.get("strided") else rows.reshape(shape)
    with pytest.raises(ValueError, match="row_index"):
        fa._check("flash_attention_fwd_drop", kb, q, k, v, seed=seed, row_index=rows)


@pytest.mark.parametrize("n", [40, 237, 512])
def test_row4_launch_passes_the_row_index(monkeypatch, n):
    """Row 4 hands its row index to the backward's entry right after the
    seed, for both kernels the entry launches to key the mask by."""
    launches = _fake_sm90_loader(monkeypatch, "flash_attention_bwd_sm90",
                                 "flash_attention_bwd_sm90", 26, 256)
    q, k, v, kb, seed, o, do, lse = _bwd_args(n=n)
    rows = torch.tensor([8, 9], dtype=torch.int32)
    fa._launch_bwd_sm90(q, k, v, kb, seed, o, do, lse, 0.125, 0.1, rows)
    rest = launches[-1][5:]
    assert rest[1:4] == (seed.data_ptr(), rows.data_ptr(), lse.data_ptr())


@pytest.mark.parametrize("src,entry", [
    ("flash_attention_fwd_sm90.cu", "flash_attention_fwd_sm90("),
    ("flash_attention_long_sm90.cu", "flash_attention_long_sm90("),
    ("flash_attention_bwd_sm90.cu", "flash_attention_bwd_sm90("),
])
def test_entries_key_the_mask_by_the_row_index(src, entry):
    """Each dropout entry takes the row index after its seed and hands it
    to the kernel, which keys every head's hash by `dropout_head` (the
    head's own index where the pointer is null and the call holds every
    head of its rows); the streamed and backward entries refuse an index
    without a seed, the short forward passes none to its kernel without
    one. Each takes the heads' total and first index after `heads` and
    refuses heads beyond the total."""
    text = (fa._build.CSRC / src).read_text()
    head = text[text.index(f'extern "C" int {entry}'):]
    head = head[:head.index("{")]
    assert "const void* seed," in head and "const void* row_index" in head
    assert head.index("seed") < head.index("row_index")
    assert " ".join(head.split()).count("int heads, int heads_total, int head0,") == 1
    assert "emm::dropout_head(row_index, bh, heads, heads_total, head0)" in text
    assert "head0 + heads > heads_total" in text
    assert "emm::dropout_keys(sd, bh)" not in text
    if src != "flash_attention_fwd_sm90.cu":
        assert "(row_index != nullptr && seed == nullptr)" in text
    else:
        assert "nullptr, nullptr, heads_total, head0, 0u, 1.f, stream)" in text
    hash_src = (fa._build.CSRC / "dropout_hash.cuh").read_text()
    assert ("(row_index == nullptr ? b : row_index[b]) * heads_total + head0 + h"
            in hash_src)


# --------------------------- rows 6-10 at the presets' widths (vlmo_tiny to vlmo_large)

FUSED_SRC = mf._build.CSRC / "fused_mlp_sm90.cu"
MLP_SRC = qf._build.CSRC / "w8a8_mlp_sm90.cu"


def _chunk_stages(k: int) -> tuple[int, int]:
    """The source's `w1_stages` and `pieces` at K = N = k: W1 stages of
    STAGE_BOXES boxes of K (the last the rest; at 96 its second box runs
    32 columns past K), and the 128-column output pieces a consumer
    warpgroup takes (one W2 stage each)."""
    return -(-(-(-k // 64)) // mf.STAGE_BOXES), -(-(-(-k // 128)) // 2)


def _stage_boxes(k: int) -> list[tuple[int, ...]]:
    """The boxes each stage of a chunk loads at width k, as the source's
    `inside` decides: a W1 stage's boxes inside K, a W2 stage's boxes whose
    first output row is below N (box b for consumer warpgroup b // 2)."""
    s1, pw = _chunk_stages(k)
    sb = mf.STAGE_BOXES
    stages = [tuple(b for b in range(sb) if sb * st + b < -(-k // 64)) for st in range(s1)]
    stages += [tuple(b for b in range(sb) if 128 * (pw * (b // 2) + st) + 64 * (b % 2) < k)
               for st in range(pw)]
    return stages


@pytest.mark.parametrize("k,stages,boxes", [
    (96, (1, 1), [(0, 1), (0, 1)]),                    # vlmo_debug: 2 W1 boxes, 1.5 of K
    (192, (1, 1), [(0, 1, 2), (0, 1, 2)]),             # vlmo_tiny: 3 W1 boxes; box 3 past N
    (384, (2, 2), [(0, 1, 2, 3), (0, 1), (0, 1, 2, 3), (0, 1)]),  # vlmo_small
    (768, (3, 3), [(0, 1, 2, 3)] * 6),                 # vlmo_base: as before
])
def test_rows_6_7_chunk_stages_at_the_presets_widths(k, stages, boxes):
    """A chunk's ring stages at K = N = k: W1 stages of four 64 x 64 boxes
    of K (the last the rest), then one W2 stage per 128-column piece a
    consumer warpgroup takes (pieces split in halves, the first to
    warpgroup 0); the W1 boxes cover K once and the W2 boxes every output
    row below N once, and a box wholly past N is not loaded."""
    assert _chunk_stages(k) == stages
    got = _stage_boxes(k)
    assert got == boxes
    s1, pw = stages
    assert sum(len(b) for b in got[:s1]) == -(-k // 64)
    rows = sorted(128 * (pw * (b // 2) + st) + 64 * (b % 2)
                  for st, bs in enumerate(got[s1:]) for b in bs)
    assert rows == list(range(0, k, 64))
    src = FUSED_SRC.read_text()
    assert "return (k_boxes(k) + SB - 1) / SB;" in src and "return (k + 63) / 64;" in src
    assert "return ((k + 127) / 128 + 1) / 2;" in src
    assert "W2_WHOLE || 128 * (PW * (b / 2) + st - S1) + 64 * (b % 2) < K;" in src
    # every box of every stage at 768 alone
    assert "W1_WHOLE = SB * S1 == XB, W2_WHOLE = 2 * PW * 128 == K;" in src
    assert [all(len(b) == mf.STAGE_BOXES for b in _stage_boxes(w)) for w in (192, 384, 768)] \
        == [False, False, True]


@pytest.mark.parametrize("drop", [False, True])
def test_rows_6_7_shared_memory_is_the_768_layout_at_every_width(drop):
    """The layout is the 768-wide one at every width (x's tile at K = 768,
    three 32 KB stages, two h tiles, the bits slots with DROP), within a
    block; the kernel reports its own through `fused_mlp_sm90_smem`,
    held against this by `chip_smoke.py`."""
    src = FUSED_SRC.read_text()
    for const in ("K_MAX = 768;", "NS = 3;", "STAGE = 32768;", "BOX = 8192;"):
        assert f"constexpr int {const}" in src
    assert (mf.RING_STAGES, mf.STAGE_BOXES, mf.BOX_BYTES) == (3, 4, 8192)
    assert mf.sm90_smem(drop) == (230488 if drop else 214104) <= SMEM_LIMIT


@pytest.mark.parametrize("k", [96, 192, 384, 768])
def test_rows_6_7_shape_checks_pass_at_the_presets_widths(k):
    h = 4 * k
    assert mf._sm90_shapes("t", *_mlp_args(m=1000, k=k, h=h, n=k)) == (1000, h, k)
    x, w1, b1, w2, _, bits = _mlp_args(m=130, k=k, h=h // 2, n=k)
    assert mf._sm90_shapes("t", x, w1, b1, w2, None, bits) == (130, h // 2, k)  # a share


@pytest.mark.parametrize("k,n", [(112, 112), (1088, 1088), (1024, 1024), (384, 768),
                                 (200, 200)])
def test_rows_6_7_shape_checks_raise_at_widths_not_built(k, n):
    """112 (no preset's; vlmo_debug's 96 is built), 1,088, vlmo_large's
    1,024 (which `fits_vmem` never sends here), K != N, and N % 64 != 0
    raise ValueError."""
    with pytest.raises(ValueError):
        mf._sm90_shapes("fused_mlp_fwd", *_mlp_args(k=k, h=4 * k, n=n)[:5])


@pytest.mark.parametrize("m,n,grid_x,grid_y,per", [
    (2560, 3072, 20, 6, 4),     # vlmo_large's qkv, the request's text stream
    (15168, 3072, 119, 1, 24),  # its fused stream
    (15168, 1024, 119, 1, 8),   # its proj
    (7584, 1536, 60, 2, 6),     # qkv's share at T = 2, the step's fused rows
    (7584, 576, 60, 2, 3),      # vlmo_base's qkv share at T = 4: 4.5 tiles
    (1280, 576, 10, 5, 1),      # and 5 tiles at the step's text rows
    (2560, 192, 20, 2, 1),      # vlmo_tiny's proj: 1.5 tiles
])
def test_row8_grid_counts_a_64_column_tail_as_a_tile(m, n, grid_x, grid_y, per):
    assert qf.matmul_grid(m, n, H100_SMS) == (grid_x, grid_y, per)
    tiles = -(-n // 128)
    assert (grid_y - 1) * per < tiles <= grid_y * per


@pytest.mark.parametrize("k", range(192, 1025, 64))
def test_row8_takes_every_k_of_the_range(k):
    """Every K % 64 == 0 from 192 to 1,024 passes the check (with N of
    qkv, proj and a 64-column tail) and gets its layout: six ring stages
    up to 768 (room for 384 or 768), four past it, within a block; the
    source's encoder takes
    qw (N, K) in 128-byte boxes (a box past K at K % 128 == 64 is filled
    with zeros by TMA)."""
    for n in (3 * k, k, 576):
        x = torch.empty(97, k, dtype=torch.bfloat16, device="meta")
        qw = torch.empty(n, k, dtype=torch.int8, device="meta")
        assert qf._check_matmul("t", x, qw, torch.empty(n, device="meta")) == (97, n, k)
    widest, stages = qf.matmul_layout(k)
    assert (widest, stages) == ((384, 6) if k <= 384 else (768, 6) if k <= 768 else (1024, 4))
    assert qf.matmul_smem(k) <= SMEM_LIMIT
    dims, strides, box, _ = qf.matmul_map_extents(3 * k, k, "w")
    assert dims == (k, 3 * k) and strides[0] % 16 == 0 and box == (128, 64)


@pytest.mark.parametrize("k,n", [(96, 768), (128, 384), (1088, 1024), (768, 1000),
                                 (1024, 100)])
def test_row8_checks_raise_at_widths_not_built(k, n):
    """K below 192 (vlmo_debug's 96, 128) or past 1,024, and N % 64 != 0
    raise ValueError in both modes."""
    x = torch.empty(64, k, dtype=torch.bfloat16, device="meta")
    qw = torch.empty(n, k, dtype=torch.int8, device="meta")
    sw, amax = torch.empty(n, device="meta"), torch.empty(64, device="meta")
    with pytest.raises(ValueError):
        qf.w8a8_matmul(x, qw, sw)
    with pytest.raises(ValueError):
        qf.w8a8_matmul_partial(x, qw, sw, amax)


@pytest.mark.parametrize("k,layout,smem", [
    (192, {"xt": 2, "parts": 1, "pc": 2, "pw": 1, "sb": 2}, (68608, 84992)),
    (384, {"xt": 3, "parts": 1, "pc": 3, "pw": 2, "sb": 4}, (109568, 125952)),
    (768, {"xt": 6, "parts": 1, "pc": 6, "pw": 3, "sb": 6}, (166912, 183296)),
    (1024, {"xt": 8, "parts": 2, "pc": 4, "pw": 2, "sb": 8}, (216064, 232448)),
])
def test_rows_9_10_layout_at_the_presets_widths(k, layout, smem):
    """x's code tiles, the parts of the second product (two at 1,024: 512
    columns each, 128 registers a consumer thread), the 128-column pieces
    a part loads and a warpgroup takes, the stage's boxes, and the shared
    memory without and with the bits slots (all a block may use at 1,024
    with them), as the source's `layout` computes them (held against the
    kernel's own `w8a8_mlp_sm90_smem` by `chip_smoke.py`)."""
    assert qf.mlp_layout(k) == layout
    assert (qf.mlp_smem(False, k), qf.mlp_smem(True, k)) == smem
    assert max(smem) <= SMEM_LIMIT
    assert layout["pw"] <= 3  # a warpgroup's pieces fit its acc[3][64]
    assert layout["pc"] * 128 * layout["parts"] >= k > (layout["pc"] - 1) * 128
    src = MLP_SRC.read_text()
    assert "l.parts = k > K_PART ? 2 : 1;" in src and "constexpr int K_PART = 768;" in src
    assert "static_assert(layout(768, true).smem == 183296" in src


@pytest.mark.parametrize("k", [192, 384, 768, 1024])
def test_rows_9_10_checks_pass_at_the_presets_widths(k):
    h = 4 * k
    assert qf._check_mlp("t", *_w8a8_args(m=130, k=k, h=h, n=k)) == (130, k, h)
    bits = torch.zeros(130, h, dtype=torch.int16)
    assert qf._check_mlp("t", *_w8a8_args(m=130, k=k, h=h, n=k), bits) == (130, k, h)
    dims, _, box, swizzle = qf.mlp_map_extents(k, h, "w2")
    assert dims == (h, k) and box == (64, 128) and swizzle == 64


@pytest.mark.parametrize("k,n", [(96, 96), (1088, 1088), (512, 512), (1024, 768),
                                 (200, 200)])
def test_rows_9_10_checks_raise_at_widths_not_built(k, n):
    """vlmo_debug's 96, 1,088, a width no preset has (512), K != N and N %
    64 != 0 raise ValueError, whole and split."""
    args = _w8a8_args(k=k, n=n)
    with pytest.raises(ValueError):
        qf._launch_mlp_sm90(*args)
    with pytest.raises(ValueError):
        qf._launch_mlp_split(*args[:6], lambda a: a)


def _ring_run(rng, ctas, stages, uses, readers, release_count, order=None):
    """One random schedule of a ring of `stages` slots that `uses` loads
    pass through, as the sources run it; returns its faults. Each of the
    `ctas` CTAs of a cluster has a producer that loads its share of every
    use into all CTAs (multicast) after waiting, on its own CTA's empty
    barrier of the slot, by the parity ((u // stages) & 1) ^ 1; a CTA's
    full barrier completes once its own producer has armed it and every
    share has landed. The consumer warpgroups `readers(u)` of every CTA
    wait for use u on their CTA's full barrier by (u // stages) & 1, read
    it and release it on the empty barrier of every CTA, whose phase
    completes after `release_count` arrivals. With `order` (row 8's order
    barrier: uses of one tile, tiles taken by the warpgroups in turn) a
    warpgroup starts a tile only once the previous tile is released.
    Faults: a wait that passes before its use has landed in its CTA, a
    load into a slot a consumer still reads, a wedged schedule."""
    consumers = [(c, w) for c in range(ctas) for w in (0, 1)]
    full = [[0] * stages for _ in range(ctas)]
    empty = [[0] * stages for _ in range(ctas)]
    arrivals = [[0] * stages for _ in range(ctas)]
    issued = [0] * ctas  # uses each producer has issued (armed and sent)
    landed = set()  # (use, producer)
    nxt = {cw: 0 for cw in consumers}
    holding = dict.fromkeys(consumers, False)
    released = [0] * uses  # consumer releases of each use
    armed = [[-1] * stages for _ in range(ctas)]  # the use a CTA's full barrier waits for

    def mine(cw, u):
        return u < uses and cw[1] in readers(u)

    def skip(cw):
        while nxt[cw] < uses and not mine(cw, nxt[cw]):
            nxt[cw] += 1

    for cw in consumers:
        skip(cw)
    faults = 0
    while True:
        moves = []
        for p in range(ctas):
            u = issued[p]
            if u < uses and empty[p][u % stages] % 2 == (u // stages) & 1:
                moves.append(("issue", p))
        moves += [("land", key) for key in [(u, p) for p in range(ctas)
                                            for u in range(issued[p])] if key not in landed]
        for cw in consumers:
            u = nxt[cw]
            if holding[cw]:
                moves.append(("release", cw))
            elif u < uses and full[cw[0]][u % stages] % 2 != (u // stages) & 1:
                tile_ok = (order is None or u % order or u < order
                           or all(released[v] == release_count
                                  for v in range(u - order, u)))
                if tile_ok:
                    moves.append(("wait", cw))
        if not moves:
            done = all(nxt[cw] >= uses and not holding[cw] for cw in consumers)
            return faults + (not done)
        kind, arg = moves[rng.randrange(len(moves))]
        if kind == "issue":
            u = issued[arg]
            faults += u >= stages and released[u - stages] < release_count
            armed[arg][u % stages] = u
            issued[arg] += 1
        elif kind == "land":
            landed.add(arg)
        elif kind == "wait":
            c, _ = arg
            faults += any((nxt[arg], p) not in landed for p in range(ctas))
            holding[arg] = True
        else:
            u = nxt[arg]
            released[u] += 1
            for c in range(ctas):
                arrivals[c][u % stages] += 1
                if arrivals[c][u % stages] == release_count:
                    arrivals[c][u % stages] = 0
                    empty[c][u % stages] += 1
            holding[arg] = False
            nxt[arg] += 1
            skip(arg)
        # a CTA's full barrier completes its phase once armed and landed
        for c in range(ctas):
            for s in range(stages):
                u = armed[c][s]
                if u >= 0 and all((u, p) in landed for p in range(ctas)):
                    full[c][s] += 1
                    armed[c][s] = -1


def _ring_faults(trials, **kw) -> int:
    import random
    rng = random.Random(repr(sorted(kw.items(), key=lambda i: i[0])))
    return sum(_ring_run(rng, **kw) for _ in range(trials))


@pytest.mark.parametrize("row,stages,per_chunk", [
    ("6/7", 3, 2), ("6/7", 3, 4), ("6/7", 3, 6),   # K = 192, 384, 768
    ("9/10", 2, 2),                               # a W1 and a W2 stage a chunk
    ("bits", 2, 1),                               # rows 7 and 10's bits slots
])
def test_rings_of_rows_6_7_9_10_wait_only_for_landed_loads(row, stages, per_chunk):
    """The audit of rows 6, 7, 9 and 10's rings (ROADMAP C, parity
    aliasing): both consumer warpgroups of both CTAs of a cluster read
    every stage, and each stage's empty barrier counts every one of them
    (2 x CL, the sources' `mbar_init(empty0 + 8 * s, 2 * CL)` and `2 *
    CLM`), so no warpgroup runs a ring's length ahead of another and no
    parity wait meets the phase two before its own: no fault, at the
    stages a chunk takes at each width. The bits slots are read by both
    warpgroups of one CTA and freed once both have (a named barrier, or
    each warp's arrival). Counting one release a stage lets a producer
    overwrite a stage in use, which the model finds: it has teeth."""
    ctas = 1 if row == "bits" else 2
    uses = 6 * per_chunk
    kw = dict(ctas=ctas, stages=stages, uses=uses, readers=lambda u: (0, 1))
    assert _ring_faults(120, release_count=2 * ctas, **kw) == 0
    assert _ring_faults(120, release_count=1, **kw) > 0
    fused, mlp = FUSED_SRC.read_text(), MLP_SRC.read_text()
    assert "mbar_init(empty0 + 8 * s, 2 * CL);" in fused
    assert "mbar_init(empty0 + 8 * s, 2 * CLM);" in mlp
    assert "mbar_init(bempty0 + 8 * s, 8);" in mlp and "mbar_init(bempty0 + 8 * s, 1);" in fused
    assert "named_bar_sync(1, 256);  // the whole 64 x 64 h tile is written (and the bits read)" in fused


@pytest.mark.parametrize("k", [192, 384, 768, 1024])
def test_row8_ring_waits_pass_only_for_landed_stages(k):
    """Row 8's ring is read by one warpgroup a stage (the tile's owner;
    one release a stage), the warpgroups taking alternate tiles of
    ceil(K / 128) stages through NS = 6 (K <= 768) or 4 slots. The order
    barrier (GO) lets a warpgroup start a tile only once the other has
    released the previous one, so the stages are taken in load order and
    no wait passes before its load has landed, at every width. Without it
    a warpgroup that runs ahead takes a slot's earlier phase for its own
    at the widths whose tile fills the ring (K = 768: six stages in six
    slots): the model has teeth."""
    ks = -(-k // 128)
    stages = qf.matmul_layout(k)[1]
    kw = dict(ctas=1, stages=stages, uses=4 * ks, readers=lambda u: ((u // ks) % 2,),
              release_count=1)
    assert _ring_faults(150, order=ks, **kw) == 0
    if ks == stages:
        assert _ring_faults(150, **kw) > 0
    src = MATMUL_SRC.read_text()
    assert "if (w == 1 || j > 0) named_bar_sync(GO + w, 256);" in src
    assert "if (j + w < theirs) named_bar_arrive(GO + 1 - w, 256);" in src


# ------------------- vlmo_debug: rows 1-5 at head dim 32, rows 6 and 7 at width 96

FWD_SRC = fa._build.CSRC / "flash_attention_fwd_sm90.cu"
SM90_HEADER = fa._build.CSRC / "sm90.cuh"
DEBUG_N = [(192, 40), (192, 197), (192, 237), (96, 512), (24, 4097), (24, 4137), (288, 237)]


@pytest.mark.parametrize("kind", ["short", "long", "bwd"])
@pytest.mark.parametrize("bh,n", DEBUG_N)
def test_head32_map_extents(kind, bh, n):
    """Every attention map at head dim 32: (32, N, BH) with byte strides TMA
    accepts, a box of one 64-byte row a key (the 64-byte swizzle's width,
    which `emm_encode_head_map` picks by the box), 64 or 128 keys deep.
    Control: a head dim of 48 would make 96-byte rows, no swizzle's width,
    and `_check` refuses it before any map is made."""
    _, extents = fa._MAP_KINDS[kind]
    dims, strides, box = extents(bh, n, 32)
    assert dims == (32, n, bh) and strides == (64, 64 * n)
    assert all(s % 16 == 0 for s in strides) and box[0] * 2 == 64
    assert box[1:] == ((fa.LONG_TILE if kind == "long" else fa.SM90_FWD_BOX), 1)
    assert extents(bh, n, 48)[2][0] * 2 not in (64, 128)
    with pytest.raises(ValueError, match="head dims"):
        fa._check("t", *_attn_args(bh=bh, n=n, d=48, b=bh // 3))
    hdr = SM90_HEADER.read_text()
    assert ("box[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B" in hdr
            and "if (box[0] != 32 && box[0] != 64) return" in hdr)


def test_head32_maps_are_cached_apart_from_head64(monkeypatch):
    """A (BH, N, 32) tensor's map is encoded with its own extents, and the
    cache keys by shape, so a head-64 tensor at the same address is
    another map."""
    calls = []

    def fake_load(name, argtypes, symbol=None):
        def encode(buf, ptr, rank, dims, strides, box):
            calls.append((tuple(dims), tuple(box)))
            return 0
        return encode

    monkeypatch.setattr(fa._build, "load", fake_load)
    monkeypatch.setattr(fa, "_MAPS", {})
    q32 = torch.zeros(6, 196, 32, dtype=torch.bfloat16)
    first = fa._map("short", q32)
    assert fa._map("short", q32) is first
    q64 = q32.view(6, 98, 64)
    assert q64.data_ptr() == q32.data_ptr() and fa._map("short", q64) is not first
    assert calls == [((32, 196, 6), (32, 64, 1)), ((64, 98, 6), (64, 64, 1))]


def _swizzled_chunk(d: int, r: int, c: int) -> int:
    """The source's `swizzled_chunk<D>`: byte offset of 16-byte chunk c of
    row r of a tile of D-wide bf16 rows, as TMA swizzles it."""
    return r * 128 + ((c ^ (r & 7)) << 4) if d == 64 else r * 64 + ((c ^ ((r >> 1) & 3)) << 4)


def _cute_swizzle(addr: int, bits: int) -> int:
    """CuTe's Swizzle<bits, 4, 3> on a byte address (TMA's 2^bits x 16-byte
    pattern): address bits 4.. XOR bits 7.., `bits` of them."""
    mask = (1 << bits) - 1
    return addr ^ (((addr >> 7) & mask) << 4)


@pytest.mark.parametrize("d", [32, 64])
def test_swizzled_chunks_are_tmas_pattern(d):
    """The row backward's delta pass reads dO and O by `swizzled_chunk<D>`:
    at D = 32 (64-byte rows, the 64-byte swizzle) and 64 (the 128-byte
    one) every chunk of a row lands inside that row, the map is a
    permutation of each tile, and it is TMA's pattern (CuTe's Swizzle<2,
    4, 3> / <3, 4, 3> on the linear address). Control: the 128-byte rule
    on 64-byte rows sends chunks out of their row."""
    row, chunks, bits = 2 * d, 2 * d // 16, {32: 2, 64: 3}[d]
    seen = set()
    for r in range(64):
        for c in range(chunks):
            off = _swizzled_chunk(d, r, c)
            assert r * row <= off < (r + 1) * row
            assert off == _cute_swizzle(r * row + 16 * c, bits)
            seen.add(off)
    assert seen == {16 * i for i in range(64 * chunks)}
    wrong = [r * 64 + ((c ^ (r & 7)) << 4) for r in range(8) for c in range(4)]
    assert any(not r * 64 <= off < (r + 1) * 64 for r, off in zip(
        [r for r in range(8) for _ in range(4)], wrong))
    hdr = SM90_HEADER.read_text()
    assert "if constexpr (D == 64) return r * 128 + ((c ^ (r & 7)) << 4);" in hdr
    assert "else return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);" in hdr
    assert "const int off = swizzled_chunk<D>(lr, D / 32 * c.qd + k);" in BWD_SRC.read_text()


@pytest.mark.parametrize("nt", range(16, 257, 16))
def test_head32_forward_layout(nt):
    """The short forward at head dim 32: a slot of 64-byte rows is half a
    head-64 slot, so four heads are in flight at every key width (two at
    D = 64 from 208 keys, the control), within a block; the mirror is the
    source's `Cfg` (its smem, held on the card by `chip_smoke.py`)."""
    rows = -(-nt // 64) * 64
    assert fa._slot_bytes(nt, 32) == 3 * rows * 64 + 4 * rows
    assert fa.fwd_sm90_slots(nt, 32) == fa.SM90_FWD_MAX_SLOTS == 4
    assert fa.fwd_sm90_smem(nt, 32) == 4 * (fa._slot_bytes(nt, 32) + 16) + 1024 <= SMEM_LIMIT
    assert fa.fwd_sm90_slots(nt, 64) == (2 if nt >= 208 else fa.fwd_sm90_slots(nt, 64))
    assert (nt < 208) or fa.fwd_sm90_slots(nt, 64) < fa.fwd_sm90_slots(nt, 32)
    assert {fa.fwd_sm90_smem(48, 32), fa.fwd_sm90_smem(240, 32)} == {51264, 201792}
    src = FWD_SRC.read_text()
    assert "static constexpr int TILE = NTB * D * 2;" in src
    assert "const uint64_t dv = desc_rows<D>(sv + kk * 32 * D);" in src


@pytest.mark.parametrize("role", ["dq", "dkdv"])
@pytest.mark.parametrize("nt", range(16, 513, 16))
def test_head32_backward_layout(nt, role):
    """The backward at head dim 32: boxes and head slots of 64-byte rows,
    so four tile stages and two to four head slots at every key width up to
    512 (the next unit's pair loads while one computes at N = 512 too);
    at D = 64 (the control) one slot from 336 keys. Within a block; the
    mirror is the source's `layout` (held on the card by `chip_smoke.py`:
    185,472 / 173,184 bytes at 240, 480 and 512 keys)."""
    lay, lay64 = fa.bwd_sm90_layout(nt, role, 32), fa.bwd_sm90_layout(nt, role, 64)
    assert lay["tile_stages"] == 4 and 2 <= lay["head_slots"] <= 4
    assert lay["smem"] <= SMEM_LIMIT
    assert (lay64["head_slots"] == 1) == (nt > 320)
    rows = -(-nt // 64) * 64
    boxes = 3 if role == "dq" else 2
    assert lay["smem"] >= lay["head_slots"] * 2 * rows * 64 + 4 * boxes * 64 * 64
    if nt in (240, 480, 512):
        assert lay["smem"] == {"dq": 185472, "dkdv": 173184}[role]
    src = BWD_SRC.read_text()
    assert "L.tile = (role == DQ ? 3 : 2) * box_bytes(d);" in src


def test_head32_stream_layout():
    """The streamed kernel (rows 1, 3 past 256 keys, row 5) at head dim 32:
    the same two Q slots and three stages of 128-key K and V blocks, each
    8 KB: 68,176 bytes, half of D = 64's 133,712 but for the bias rows and
    barriers (as the card reports)."""
    assert fa.stream_smem(32) == 2 * 8192 + 6 * 8192 + 3 * 512 + 80 + 1024 == 68176
    assert fa.stream_smem(64) - fa.stream_smem(32) == 8 * 8192
    src = STREAM_SRC.read_text()
    assert "const uint64_t dv = desc_rows<D>(sv + kk * 32 * D);" in src
    assert "const uint32_t sq = base + C::Q_OFF + qr.slot * TILE + w * (TILE / 2);" in src


def test_head32_rings_wait_only_for_landed_loads():
    """The rings at head dim 32: the short forward's head slots (4 at every
    width) and the streamed kernel's stages and Q slots (3 and 2) are read
    in full by both warpgroups and released by both: the model finds no
    fault there, and finds the overwrite when one release is counted
    (control). The backward's tile ring takes 4 stages at every width:
    with the first wait (the stage's previous tile released) no wait
    passes before its tile lands; the same ring at 3 stages without it
    races (control), which the head-32 layouts never take."""
    slots = {fa.fwd_sm90_slots(nt, 32) for nt in range(16, 257, 16)}
    stages = {fa.bwd_sm90_layout(nt, r, 32)["tile_stages"] for nt in range(16, 513, 16)
              for r in ("dq", "dkdv")}
    assert slots == {4} and stages == {4}
    for n in sorted(slots | {fa.LONG_STAGES, fa.LONG_Q_SLOTS}):
        assert _shared_ring_faults(n, 10, release_count=2, trials=200) == 0
        assert _shared_ring_faults(n, 10, release_count=1, trials=200) > 0
    assert _ring_early_waits(4, 12, release_wait=True, trials=300) == 0
    assert _ring_early_waits(3, 12, release_wait=False, trials=300) > 0


@pytest.mark.parametrize("row", [1, 2, 3, 4, 5])
def test_head32_launches_pass_the_head_dim(monkeypatch, row):
    """Each entry of rows 1-5 gets the head dim, 32, just before its stream,
    and its maps are the head-32 maps of q, k, v (o, do)."""
    source = {1: "flash_attention_fwd_sm90", 3: "flash_attention_fwd_sm90",
              2: "flash_attention_bwd_sm90", 4: "flash_attention_bwd_sm90",
              5: "flash_attention_long_sm90"}[row]
    nargs = 26 if row in (2, 4) else 20
    launches = _fake_sm90_loader(monkeypatch, source, source, nargs, 256)
    n = 4097 if row == 5 else 197
    q, k, v = (torch.zeros(6, n, 32, dtype=torch.bfloat16) for _ in range(3))
    kb = torch.zeros(2, n)
    seed = torch.zeros(1, dtype=torch.int32)
    o, do, lse = torch.zeros_like(q), torch.zeros_like(q), torch.zeros(6, n)
    call = {1: lambda: fa._launch_fwd_sm90(q, k, v, kb, 0.125),
            3: lambda: fa._launch_fwd_sm90(q, k, v, kb, 0.125, seed, 0.1),
            2: lambda: fa._launch_bwd_sm90(q, k, v, kb, None, o, do, lse, 0.125),
            4: lambda: fa._launch_bwd_sm90(q, k, v, kb, seed, o, do, lse, 0.125, 0.1),
            5: lambda: fa._launch_long(q, k, v, kb, 0.125)}[row]
    call()
    args = launches[-1]
    assert len(args) == nargs and args[-2:] == (32, 0)
    maps = 5 if row in (2, 4) else 3
    assert all(key[-1] == (6, n, 32) for key in fa._MAPS) and len(fa._MAPS) == maps


def _k_steps(k: int) -> list[tuple[int, int, int]]:
    """The (stage, box, k16 step) products a chunk's W1 stages issue at K =
    N = k, as the source's guard `64 * (SB * st + b) + 16 * kk < K` leaves
    them."""
    s1, _ = _chunk_stages(k)
    sb = mf.STAGE_BOXES
    return [(st, b, kk) for st in range(s1) for b in _stage_boxes(k)[st] for kk in range(4)
            if 64 * (sb * st + b) + 16 * kk < k]


@pytest.mark.parametrize("k", [96, 192, 384, 768])
def test_rows_6_7_issue_only_the_k_steps_below_k(k):
    """x's tile is ceil(K / 64) boxes (two at 96: columns 64-127, 32 past
    K from the map's zero fill), but the W1 products cover K once in k16
    steps: K / 16 of them, none past K, so no product reads the filled
    columns. Control: without the guard 96 would issue 8 steps, two over
    the fill. A stage's expected bytes are its boxes', the filled columns
    included (TMA counts the whole box)."""
    steps = _k_steps(k)
    assert len(steps) == k // 16
    assert all(64 * (4 * st + b) + 16 * kk < k for st, b, kk in steps)
    unguarded = sum(4 for st, bs in enumerate(_stage_boxes(k)[:_chunk_stages(k)[0]]) for _ in bs)
    assert (unguarded > len(steps)) == (k == 96)
    src = FUSED_SRC.read_text()
    assert "if (64 * (SB * st + b) + 16 * kk < K)" in src
    assert "for (int b = 0; b < SB; ++b) boxes += inside(b);" in src
    assert "mbar_arrive_expect_tx(full, boxes * BOX);" in src
    assert "return k == 96 || k == 192 || k == 384 || k == 768;" in src
    assert "k == 96    ? mlp_sm90_kernel<DROP, 96>" in src


def test_rows_6_7_ring_at_96():
    """At K = N = 96 a chunk is one W1 stage (two boxes) and one W2 stage
    (warpgroup 0's two boxes, output rows 0-127, 32 past N from the fill;
    warpgroup 1's piece wholly past N is not loaded), two uses of the ring
    a chunk: both warpgroups of both CTAs read every stage and release it,
    so no wait passes before its load (the model), and counting one
    release lets a producer overwrite a stage in use (control). The
    epilogue stores no column past N."""
    assert _chunk_stages(96) == (1, 1) and _stage_boxes(96) == [(0, 1), (0, 1)]
    kw = dict(ctas=2, stages=mf.RING_STAGES, uses=6 * 2, readers=lambda u: (0, 1))
    assert _ring_faults(120, release_count=4, **kw) == 0
    assert _ring_faults(120, release_count=1, **kw) > 0
    assert "if (row < m && (W2_WHOLE || col < K)) {" in FUSED_SRC.read_text()
    assert mf.sm90_smem(False) == 214104 and mf.sm90_smem(True) == 230488
