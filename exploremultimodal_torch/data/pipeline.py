"""Batches: collation, the threaded epoch loader, and the copy to the device.

Counterpart of `exploremultimodal_tpu/data/pipeline.py`. `ShardedLoader`
draws the epoch's order from (seed, epoch) (shuffled for training, index
order for evaluation), cuts it to whole batches across processes (dropping
the rest for training, filling the last batch with the order's first
samples otherwise), and takes this process's stride of it. A producer
thread builds the batches in order on a pool of `num_workers` threads and
keeps up to `prefetch` of them ready. Images stay uint8 up to the device;
on a CUDA device every batch crosses through pinned memory without
blocking the host.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
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


class ShardedLoader:
    """Epoch batches of a map-style dataset. `set_epoch` also sets the
    `epoch` of the dataset and of each dataset a `datasets` list holds, so
    their per-sample generators change with it. Iteration stops its
    producer when the consumer stops early."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 8, drop_last: bool = True, prefetch: int = 4,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(int(num_workers), 1)
        self.drop_last = drop_last
        self.prefetch = max(int(prefetch), 1)
        self.process_index = process_index
        self.process_count = process_count
        self.current_epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.current_epoch = epoch
        stack = [self.dataset]
        while stack:
            ds = stack.pop()
            if hasattr(ds, "datasets"):
                stack.extend(ds.datasets)
            elif hasattr(ds, "epoch"):
                ds.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = (np.random.default_rng((self.seed, self.current_epoch)).permutation(n)
                 if self.shuffle else np.arange(n))
        world_batch = self.batch_size * self.process_count
        if self.drop_last:
            order = order[: (n // world_batch) * world_batch]
        else:
            pad = (-len(order)) % world_batch
            if pad:
                order = np.concatenate([order, order[:pad]])
        return order[self.process_index:: self.process_count]

    def __len__(self) -> int:
        return len(self._indices()) // self.batch_size

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return self._batches(self._indices())

    def _batches(self, indices: np.ndarray) -> Iterator[dict[str, Any]]:
        n_batches = len(indices) // self.batch_size
        if n_batches == 0:
            return
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce() -> None:
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        idx = indices[b * self.batch_size: (b + 1) * self.batch_size]
                        out_q.put(collate(list(pool.map(self.dataset.__getitem__,
                                                        (int(i) for i in idx)))))
            except Exception as e:  # handed to the consumer, raised there
                out_q.put(e)
                return
            out_q.put(None)

        producer = threading.Thread(target=produce, daemon=True, name="ShardedLoader")
        producer.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            while producer.is_alive():  # drain so a blocked put returns
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    producer.join(timeout=0.05)

    def epoch(self, epoch: int) -> Iterator[dict[str, Any]]:
        """The batches of `epoch` (`set_epoch`, then iteration)."""
        self.set_epoch(epoch)
        return iter(self)


class Loader(ShardedLoader):
    """One process's loader in the train / eval convention: with `train`
    (the default) shuffled from (seed, epoch) and drop_last; otherwise in
    index order, the last batch filled up with the order's first samples."""

    def __init__(self, dataset, batch_size: int, *, seed: int = 0, train: bool = True,
                 num_workers: int = 1, prefetch: int = 4):
        super().__init__(dataset, batch_size, shuffle=train, seed=seed,
                         num_workers=num_workers, drop_last=train, prefetch=prefetch)


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
