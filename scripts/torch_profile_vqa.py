#!/usr/bin/env python3
"""Where the time of one serving request goes in the PyTorch port, on one GPU.

    python3 scripts/torch_profile_vqa.py          # VQA, bf16
    python3 scripts/torch_profile_vqa.py w8a8     # model.quantize=w8a8_pallas_mlp
    python3 scripts/torch_profile_vqa.py w8a8_pallas  # model.quantize=w8a8_pallas
    python3 scripts/torch_profile_vqa.py hires    # model.img_size=1024, batch 8
    python3 scripts/torch_profile_vqa.py caption  # caption_ids, 16 tokens, 8 iterations
    python3 scripts/torch_profile_vqa.py inpaint  # inpaint_ids, one region a row

Builds a serving configuration of `chip_smoke.py` (vlmo_base, bf16,
attn_impl=pallas, mlp_impl=fused, seeded random weights, batch 64; with
`w8a8` the int8 MLP; with `w8a8_pallas` also qkv and proj on the int8
matmul, row 8; with `hires` 1024^2 images at batch 8, where row 5
carries the image and fused streams; with `caption` and `inpaint` the
finetune_caption and finetune_inpainting heads behind `caption_ids` and
`inpaint_ids` at `chip_smoke.py`'s settings), warms
up, then traces REQUESTS requests with torch.profiler. Prints the request
wall time, the device-busy time (the union of kernel intervals), the
device's idle share, and the kernels' device time grouped by name, as one
JSON line. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import (  # noqa: E402
    BATCH,
    CAPTION_ITERS,
    ENDPOINT_OVERRIDES,
    HIRES_BATCH,
    HIRES_OVERRIDES,
    INPAINT_REGION,
    MASK_ID,
    SERVE_OVERRIDES,
    W8A8_SERVE_OVERRIDES,
    caption_rows,
    card_line,
    make_requests,
)
from exploremultimodal_torch.data.masking import RegionMaskingGenerator  # noqa: E402
from exploremultimodal_torch.config import VlmoConfig, load_config  # noqa: E402
from exploremultimodal_torch.infer import Predictor  # noqa: E402
from exploremultimodal_torch.models import build_model  # noqa: E402

REQUESTS = 3  # traced requests, after two untraced warm-up ones


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_profile_vqa: no CUDA device", file=sys.stderr)
        return 1
    cells = {(): (SERVE_OVERRIDES, BATCH), ("w8a8",): (W8A8_SERVE_OVERRIDES, BATCH),
             ("w8a8_pallas",): (SERVE_OVERRIDES + ["model.quantize=w8a8_pallas"], BATCH),
             ("hires",): (HIRES_OVERRIDES, HIRES_BATCH),
             ("caption",): (ENDPOINT_OVERRIDES + ["train=finetune_caption"], BATCH),
             ("inpaint",): (ENDPOINT_OVERRIDES + ["train=finetune_inpainting"], BATCH)}
    if tuple(argv) not in cells:
        print("usage: torch_profile_vqa.py [w8a8 | w8a8_pallas | hires | caption | inpaint]",
              file=sys.stderr)
        return 2
    card = card_line()

    overrides, batch = cells[tuple(argv)]
    cfg = load_config(overrides)
    vcfg = VlmoConfig.from_config(cfg)
    state = build_model(cfg, device="cpu", seed=0).state_dict()
    pred = Predictor(cfg, state, max_batch=batch, device="cuda")
    rng = np.random.default_rng(0)
    (img, ids, mask), = make_requests(vcfg, rng, 1, batch)
    if argv == ["caption"]:
        ids, mask = caption_rows(batch, vcfg.max_text_len)

        def request():
            pred.caption_ids(img, ids, mask, CAPTION_ITERS, MASK_ID)
    elif argv == ["inpaint"]:
        region = RegionMaskingGenerator(vcfg.img_size // vcfg.patch_size, INPAINT_REGION)
        patches = np.stack([region(rng).reshape(-1) for _ in range(batch)])

        def request():
            pred.inpaint_ids(img, patches, ids, mask)
    else:
        def request():
            pred.vqa_logits(img, ids, mask)
    for _ in range(2):
        request()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            request()
        wall_us = (time.perf_counter() - t0) * 1e6

    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    intervals = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, dur = ev.time_range.start, ev.time_range.elapsed_us()
        intervals.append((start, start + dur))
        by_name[ev.name][0] += dur
        by_name[ev.name][1] += 1
    busy = busy_us(intervals)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "card": card, "overrides": overrides, "batch": batch, "requests": REQUESTS,
        "wall_ms_per_request": wall_us / 1e3 / REQUESTS,
        "device_busy_ms_per_request": busy / 1e3 / REQUESTS if intervals else None,
        "device_idle_share": 1.0 - busy / wall_us if intervals else None,
        "device_launches_per_request": len(intervals) / REQUESTS,
        "kernels": [{"name": k[:90], "ms_per_request": v[0] / 1e3 / REQUESTS,
                     "calls_per_request": v[1] / REQUESTS}
                    for k, v in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
