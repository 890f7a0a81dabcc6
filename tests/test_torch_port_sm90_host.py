"""Host-side logic of the port's wgmma/TMA kernels, on the CPU.

The kernels themselves run only on the card (`chip_smoke.py` holds them
against their plain versions there); what their wrappers decide on the host
is tested here: the bf16 fused MLP's hidden-split rule (how many CTAs share
a row tile's hidden dimension, with partial sums added in a second pass) and
its cache of tensor maps, keyed by what a map encodes.
"""

import pytest
import torch

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
