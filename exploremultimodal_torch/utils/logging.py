"""The run's logger (counterpart of `exploremultimodal_tpu/utils/logging.py`):
one file `log_p0.txt` in the run dir (JAX's name for process 0's log; the
port trains on one process) and stderr, so that a command's standard output
stays free for the JSON lines a caller reads."""

from __future__ import annotations

import functools
import logging
import os
import sys


@functools.lru_cache(maxsize=None)
def create_logger(output_dir: str | None = None, name: str = "emm_torch",
                  level: str = "info") -> logging.Logger:
    """The logger `name` at `level`, writing to `output_dir` where given and
    to stderr. Cached: a second call with the same arguments returns the
    same logger without adding handlers."""
    logger = logging.getLogger(name if output_dir is None else f"{name}.{output_dir}")
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s p0] (%(filename)s %(lineno)d): %(levelname)s %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(fmt)
    logger.addHandler(console)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "log_p0.txt"), mode="a")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
