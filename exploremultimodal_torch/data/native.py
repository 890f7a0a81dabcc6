"""ctypes bindings of the native JPEG loader (counterpart of
`exploremultimodal_tpu/data/native.py`): the repository's
`native/emmloader.cc`, unedited, decodes a batch of JPEGs with libjpeg,
crops each and resizes it bilinearly to one or two sizes on a C++ thread
pool, outside the GIL.

The port compiles the source itself at first use, with the flags of
`native/Makefile` (`g++ -O3 -march=native -fPIC -std=c++17 -shared ... -ljpeg
-lpthread`), into `exploremultimodal_torch/data/build/`; it never
runs `make -C native` and never writes `native/libemmloader.so`, which
belong to the JAX package. Where the compiler, `jpeglib.h` or libjpeg is
missing, `is_available()` is false and `require()` raises with the
compiler's message: `data.native_loader=true` never falls back to PIL.

Crop boxes come from `transforms.random_resized_crop_params`, so the native
and PIL routes take the same crop decisions; they resample differently
(bilinear here, bicubic / Lanczos in PIL).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "emmloader.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
LIB_PATH = os.path.join(BUILD_DIR, "libemmloader.so")
BUILD_CMD = ("g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_state: dict = {}


def build(force: bool = False) -> str:
    """Compile `native/emmloader.cc` into LIB_PATH (once: an existing
    library is kept unless `force`). Returns its path; raises RuntimeError
    with the compiler's output where the build fails."""
    if os.path.exists(LIB_PATH) and not force:
        return LIB_PATH
    if not os.path.exists(SOURCE):
        raise RuntimeError(f"native loader: no source at {SOURCE}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*BUILD_CMD, SOURCE, "-o", tmp, "-ljpeg", "-lpthread"],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native loader: no C++ compiler ({e})") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("native loader: the build failed (needs g++, jpeglib.h and "
                           f"libjpeg):\n{proc.stderr.strip()}")
    os.replace(tmp, LIB_PATH)  # whole, for a concurrent reader
    return LIB_PATH


def _lib() -> ctypes.CDLL:
    """The loaded library, built at first use (and built again where a
    library left by another machine does not load); the first failure is
    kept and raised again."""
    with _lock:
        if "lib" not in _state and "error" not in _state:
            try:
                try:
                    lib = ctypes.CDLL(build())
                except OSError:
                    lib = ctypes.CDLL(build(force=True))
            except (RuntimeError, OSError) as e:
                _state["error"] = RuntimeError(str(e))
            else:
                lib.emm_decode_resize_batch.restype = ctypes.c_int
                lib.emm_decode_resize_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p),   # jpeg_data
                    ctypes.POINTER(ctypes.c_int64),    # jpeg_sizes
                    ctypes.c_int,                      # n
                    ctypes.POINTER(ctypes.c_int),      # crop_boxes
                    ctypes.POINTER(ctypes.c_uint8),    # out1
                    ctypes.c_int,                      # size1
                    ctypes.POINTER(ctypes.c_uint8),    # out2 (nullable)
                    ctypes.c_int,                      # size2
                    ctypes.POINTER(ctypes.c_int),      # status
                    ctypes.c_int,                      # num_threads
                ]
                _state["lib"] = lib
        if "error" in _state:
            raise _state["error"]
        return _state["lib"]


def require() -> None:
    """Raise RuntimeError (why) unless the library builds and loads."""
    _lib()


def is_available() -> bool:
    try:
        _lib()
    except RuntimeError:
        return False
    return True


def decode_resize_batch(
    jpeg_buffers: list[bytes],
    size1: int,
    size2: int | None = None,
    crop_boxes: np.ndarray | None = None,
    num_threads: int = 8,
) -> tuple[np.ndarray, np.ndarray | None, np.ndarray]:
    """Decode N JPEGs, crop, and resize to (size1, size1) [+ (size2, size2)].

    crop_boxes: (N, 4) int32 (left, top, w, h); w <= 0 means the full image.
    Returns (out1, out2 | None, status): status[i] != 0 marks a decode
    failure (its output zeros; the dataset resamples).
    """
    lib = _lib()
    n = len(jpeg_buffers)
    keepalive = [ctypes.create_string_buffer(b, len(b)) for b in jpeg_buffers]
    data_ptrs = (ctypes.c_void_p * n)(*[ctypes.cast(b, ctypes.c_void_p) for b in keepalive])
    sizes = (ctypes.c_int64 * n)(*[len(b) for b in jpeg_buffers])
    if crop_boxes is None:
        crop_boxes = np.full((n, 4), -1, np.int32)
    boxes = np.ascontiguousarray(crop_boxes, np.int32)
    out1 = np.empty((n, size1, size1, 3), np.uint8)
    out2 = np.empty((n, size2, size2, 3), np.uint8) if size2 else None
    status = np.zeros(n, np.int32)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.emm_decode_resize_batch(
        ctypes.cast(data_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.cast(sizes, ctypes.POINTER(ctypes.c_int64)),
        n,
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out1.ctypes.data_as(u8), size1,
        out2.ctypes.data_as(u8) if out2 is not None else ctypes.cast(None, u8),
        size2 or 0,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        num_threads,
    )
    return out1, out2, status
