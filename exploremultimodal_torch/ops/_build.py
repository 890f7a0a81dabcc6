"""Build the CUDA kernels of this package with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes plain C functions (one named `<name>`, maybe
more) and is compiled on first use into `build/lib<name>-<hash>.so` beside
this file, where the hash
covers the sources and the flags, so an edited source is rebuilt. Nothing
from PyTorch's headers is compiled, which keeps a build to seconds. There is
no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("flash_attention_fwd_sm90", "flash_attention_long_sm90", "flash_attention_bwd_sm90",
           "fused_mlp_sm90", "w8a8_matmul_sm90", "w8a8_mlp_sm90", "dvae_block")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found under {home}/bin or on PATH")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict[str, tuple[float, str]]:
    """Compile every kernel in `names` that is not built yet, all nvcc
    processes at once. Returns {name: (seconds, compiler log)}; raises on a
    failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    results, failed = {}, []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        results[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return results


def load(name: str, argtypes: list, symbol: str | None = None) -> ctypes._CFuncPtr:
    """The C entry point `symbol` (default `name`) of source `name`, built
    if needed. It returns a cudaError_t as int."""
    symbol = symbol or name
    if symbol not in _loaded:
        build([name])
        fn = getattr(ctypes.CDLL(str(_target(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[symbol] = fn
    return _loaded[symbol]


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {rc}")
