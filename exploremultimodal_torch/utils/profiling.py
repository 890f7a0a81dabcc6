"""Profiling and failure detection (counterpart of
`exploremultimodal_tpu/utils/profiling.py`).

`trace` records a `torch.profiler` trace of the CPU and the card around a
window of steps (`profile_steps`) into a Chrome trace file;
`check_finite_and_dump` stops a run whose total loss is not finite, after
dumping the step's metrics.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A torch.profiler trace of everything inside the context, written to
    `<log_dir>/trace.json` (CUDA activity too where a card is present)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class NonFiniteLossError(RuntimeError):
    pass


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


def check_finite_and_dump(metrics: dict[str, Any], step: int, output_dir: str,
                          logger=None) -> None:
    """Raise `NonFiniteLossError` when `metrics['total_loss']` is not
    finite, after writing the metrics to `<output_dir>/nan_dump_step{step}.npz`.
    It reads a device value, so call it at the logging cadence only."""
    total = float(_to_numpy(metrics.get("total_loss", 0.0)))
    if np.isfinite(total):
        return
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"nan_dump_step{step}.npz")
    np.savez(path, **{k: _to_numpy(v) for k, v in metrics.items()
                      if isinstance(v, (torch.Tensor, np.ndarray)) or np.isscalar(v)})
    if logger:
        logger.error(f"non-finite total loss at step {step}; dumped {path}")
    raise NonFiniteLossError(f"total loss non-finite at step {step} ({total})")
