"""Training metric meters (counterpart of `exploremultimodal_tpu/utils/metrics.py`).

`SmoothedValue` keeps a window for medians and averages and a global sum
and count; `MetricLogger` keeps one per metric and logs at a cadence while
it walks the loader. The values may be 0-d device tensors: a meter holds
them as they come and reads them (one host sync for all of them) only when
a statistic is asked for, at the logging cadence, so the loop adds no sync
to a step.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist


def read_floats(values: list) -> list[float]:
    """The values as Python floats: the tensors on each device read in one
    transfer, host values as they are."""
    out = [v if isinstance(v, torch.Tensor) else float(v) for v in values]
    by_device: dict = {}
    for i, v in enumerate(out):
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append(i)
    for idx in by_device.values():
        read = torch.stack([out[i].detach().float().reshape(()) for i in idx]).cpu()
        for i, x in zip(idx, read.tolist()):
            out[i] = x
    return out


class SmoothedValue:
    """A windowed median and average, and a global average."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self._pending: list[tuple[object, int]] = []
        self.fmt = fmt

    def update(self, value, n: int = 1) -> None:
        self.deque.append(value)
        self._pending.append((value, n))

    def _flush(self) -> None:
        if not self._pending:
            return
        values = read_floats([v for v, _ in self._pending])
        for value, (_, n) in zip(values, self._pending):
            self.count += n
            self.total += value * n
        self._pending.clear()

    def _window(self) -> list[float]:
        values = read_floats(list(self.deque))
        self.deque = deque(values, maxlen=self.deque.maxlen)
        return values

    def synchronize_between_processes(self) -> None:
        """The count and the total summed over the processes of the group
        (nothing to sum with at one process), as JAX's meter does."""
        self._flush()
        if dist.is_initialized() and dist.get_world_size() > 1:
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if dist.get_backend() == "nccl" else torch.device("cpu"))
            summed = torch.tensor([self.count, self.total], dtype=torch.float64, device=dev)
            dist.all_reduce(summed)
            self.count, self.total = int(summed[0].item()), float(summed[1].item())

    @property
    def median(self) -> float:
        return float(np.median(self._window())) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self._window())) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        self._flush()
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self._window()) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self._window()[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    def __init__(self, logger=None):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.logger = logger

    def update(self, n: int = 1, **kwargs) -> None:
        for k, v in kwargs.items():
            if v is not None:
                self.meters[k].update(v, n=n)

    def __str__(self) -> str:
        return "  ".join(f"{k}: {m}" for k, m in self.meters.items())

    def synchronize_between_processes(self) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "") -> Iterator:
        """Yield from `iterable`, logging the meters, the iteration and data
        times and an ETA every `print_freq` items and the total at the end.
        The times are the host's: a step's device work may still be queued
        when the next item is drawn."""
        i = 0
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        start = end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 and self.logger is not None:
                if total:
                    eta = datetime.timedelta(
                        seconds=int(iter_time.global_avg * (total - i)))
                    pos = f"[{i}/{total}] eta: {eta}"
                else:
                    pos = f"[{i}]"
                self.logger.info("  ".join(
                    [header, pos, str(self), f"time: {iter_time}",
                     f"data: {data_time}"]))
            i += 1
            end = time.time()
        elapsed = time.time() - start
        if self.logger is not None:
            self.logger.info(
                f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))} "
                f"({elapsed / max(i, 1):.4f} s / it)")
