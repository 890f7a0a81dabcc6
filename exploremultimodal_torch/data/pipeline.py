"""Batches: collation, the epoch order, and the copy to the device.

Counterpart of `exploremultimodal_tpu/data/pipeline.py` for one process: the
same per-epoch permutation from (seed, epoch), the same drop_last batches and
the same `collate`. Images stay uint8 up to the device; on a CUDA device
every batch crosses through pinned memory without blocking the host.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

Sample = dict[str, Any]


def collate(samples: list[Sample]) -> dict[str, Any]:
    """Stack sample dicts; non-array fields become lists."""
    out: dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray) or isinstance(
                first, (int, float, bool, np.integer, np.floating, np.bool_)):
            out[key] = np.stack([np.asarray(v) for v in vals])
        else:
            out[key] = vals
    return out


class Loader:
    """Epoch-ordered, drop_last batches of a map-style dataset."""

    def __init__(self, dataset, batch_size: int, *, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[dict[str, Any]]:
        order = np.random.default_rng((self.seed, epoch)).permutation(
            len(self.dataset))
        for b in range(len(self)):
            idx = order[b * self.batch_size: (b + 1) * self.batch_size]
            yield collate([self.dataset[int(i)] for i in idx])


def to_device(batch: dict[str, Any], device: torch.device) -> dict[str, torch.Tensor]:
    """The array fields of a host batch as tensors on `device` (lists and
    `index` dropped)."""
    out = {}
    for key, value in batch.items():
        if key == "index" or not isinstance(value, np.ndarray):
            continue
        t = torch.from_numpy(value)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out
