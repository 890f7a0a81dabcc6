#!/usr/bin/env python3
"""Where the time of one tokenizer call goes in the PyTorch port, on one GPU.

    python3 scripts/torch_profile_dvae.py            # fused=True (row 11)
    python3 scripts/torch_profile_dvae.py unfused    # cuDNN convs only
    python3 scripts/torch_profile_dvae.py w8a8       # the int8 trunk

Builds `chip_smoke.py`'s tokenizer (`DalleVAE` at 256^2, bf16, its seeded
weights) in the chosen mode, tokenizes DVAE_BATCH seeded images (already on
the card) twice to warm up, times UNTRACED calls on the host clock with a
synchronise around each, then traces CALLS calls of
`get_codebook_indices(map_pixels(x))` with torch.profiler. Prints, as one
JSON line: the untraced and traced wall time per call, the device-busy time
(the union of kernel intervals) and the device's idle share of the traced
wall, the device time by kernel family, and the kernels' device time grouped
by name. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import (  # noqa: E402
    DVAE_BATCH,
    DVAE_MODES,
    DVAE_SIZE,
    card_line,
    dvae_encoder,
)
from torch_profile_vqa import busy_us  # noqa: E402

from exploremultimodal_torch.models.dvae import DalleVAE, map_pixels  # noqa: E402

CALLS = 2  # traced calls, after two warm-up ones
UNTRACED = 3  # host-clock calls before the trace
TOP = 15
# kernel families, by the first substring of the kernel's name that matches
FAMILIES = (
    ("row 11 (dvae_block)", ("dvae_block",)),
    ("int8 GEMM (torch._int_mm)", ("i16832gemm", "igemm", "imma")),
    ("cuBLAS/cuDNN GEMM and conv", ("nvjet", "gemm", "cutlass", "sm90_", "conv", "cudnn",
                                    "xmma")),
    ("reductions", ("reduce_kernel", "max_pool", "argmax")),
    ("elementwise and copies", ("elementwise", "copy", "Memcpy", "Memset", "fill", "cat",
                                "pad", "index")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "other"


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_profile_dvae: no CUDA device", file=sys.stderr)
        return 1
    modes = {(): "fused", ("unfused",): "unfused", ("w8a8",): "w8a8"}
    if tuple(argv) not in modes:
        print("usage: torch_profile_dvae.py [unfused | w8a8]", file=sys.stderr)
        return 2
    mode = modes[tuple(argv)]
    card = card_line()
    # as chip_smoke.py: the fp32 output conv in full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    vae = DalleVAE(DVAE_SIZE, dtype=torch.bfloat16, device=dev, **DVAE_MODES[mode])
    vae.encoder.load_state_dict(dvae_encoder(torch.bfloat16, "cpu").state_dict())
    vae.eval()
    rng = np.random.default_rng(21)
    img = torch.from_numpy(rng.random((DVAE_BATCH, DVAE_SIZE, DVAE_SIZE, 3),
                                      dtype=np.float32)).to(dev)

    def call():
        return vae.get_codebook_indices(map_pixels(img))

    for _ in range(2):
        call()
    untraced = []
    for _ in range(UNTRACED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        untraced.append((time.perf_counter() - t) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    by_family: dict[str, float] = defaultdict(float)
    intervals = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, dur = ev.time_range.start, ev.time_range.elapsed_us()
        intervals.append((start, start + dur))
        by_name[ev.name][0] += dur
        by_name[ev.name][1] += 1
        by_family[family(ev.name)] += dur
    busy = busy_us(intervals)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    print(json.dumps({
        "card": card, "mode": mode, "batch": DVAE_BATCH, "size": DVAE_SIZE,
        "calls": CALLS, "untraced_ms_per_call": untraced,
        "untraced_median_ms": statistics.median(untraced),
        "traced_wall_ms_per_call": wall_us / 1e3 / CALLS,
        "device_busy_ms_per_call": busy / 1e3 / CALLS if intervals else None,
        "device_idle_share": 1.0 - busy / wall_us if intervals else None,
        "families_ms_per_call": {k: v / 1e3 / CALLS for k, v in
                                 sorted(by_family.items(), key=lambda kv: -kv[1])},
        "kernels": [{"name": k[:90], "ms_per_call": v[0] / 1e3 / CALLS,
                     "calls_per_call": v[1] / CALLS} for k, v in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
