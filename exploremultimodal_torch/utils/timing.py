"""One timing method for the step and the benchmarks (counterpart of
`exploremultimodal_tpu/utils/timing.py`).

The device runs behind the host: a clock read after a call that returns
measures the enqueue. The fence is a device-to-host read of one element of
the timed work's output, which waits for everything queued before it on
that stream; `Trainer.throughput` and the scripts time through this.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    values = out.values() if isinstance(out, dict) else out
    if isinstance(values, (list, tuple, type({}.values()))):
        for v in values:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(out) -> None:
    """Wait for `out`: a host read of one element of its first tensor (a
    tensor, or one in a dict, list or tuple). Nothing to wait for without
    one."""
    t = _first_tensor(out)
    if t is not None:
        t.detach().reshape(-1)[:1].cpu()


def timeit(step: Callable[[], object], n_warmup: int, n_iters: int) -> float:
    """Mean seconds an iteration: `n_warmup` calls, a fence, `n_iters`
    timed calls, a fence. `step` returns (something holding) a tensor that
    depends on the work timed."""
    out = None
    for _ in range(n_warmup):
        out = step()
    sync(out)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = step()
    sync(out)
    return (time.perf_counter() - t0) / max(n_iters, 1)
