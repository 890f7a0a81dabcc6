#!/usr/bin/env python3
"""Where the time of one training step goes in the PyTorch port, on one GPU.

    python3 scripts/torch_profile_train.py             # pretrain_mum
    python3 scripts/torch_profile_train.py drop0       # pretrain_mum, attention dropout 0
    python3 scripts/torch_profile_train.py vqa         # finetune_vqa
    python3 scripts/torch_profile_train.py vqa_w8a8    # finetune_vqa, int8 MLP
    python3 scripts/torch_profile_train.py txt         # pretrain_txt, 512 tokens
    python3 scripts/torch_profile_train.py vis         # pretrain_vis (MIM), fused MLP
    python3 scripts/torch_profile_train.py vis_mae     # pretrain_vis with MAE
    python3 scripts/torch_profile_train.py nlvr2       # finetune_nlvr2
    python3 scripts/torch_profile_train.py retrieval   # finetune_retrieval (ITC + IRTR)
    python3 scripts/torch_profile_train.py momentum    # pretrain_mum's full recipe
    python3 scripts/torch_profile_train.py caption     # finetune_caption
    python3 scripts/torch_profile_train.py imgcls      # finetune_vis
    python3 scripts/torch_profile_train.py ref         # finetune_ref
    python3 scripts/torch_profile_train.py inpainting  # finetune_inpainting, region masks

Builds a training configuration of `chip_smoke.py`: with no argument its
pretrain_mum step (vlmo_base, bf16, attn_impl=auto with attention dropout
0.1, batch 32, synthetic data, random dVAE); with `drop0` that step at
attn_impl=pallas and attention dropout 0 (the flash forward and backward
without dropout, rows 1 and 2); with `vqa` its finetune_vqa
step (the same with mlp_impl=fused, no dVAE); with `vqa_w8a8` that step
under model.quantize=w8a8_pallas_mlp; with `txt` its pretrain_txt step
(text-only MLM at 512 tokens, batch 32, attention dropout 0.1: rows 3 and
4 at BH = 384, N = 512); with `vis`, `vis_mae`, `nlvr2` and `retrieval` its
downstream steps at batch 32 (pretrain_vis with mlp_impl=fused, MIM or
MAE: rows 3, 4 and 7 on 12 image blocks; finetune_nlvr2 and
finetune_retrieval at their defaults: rows 3 and 4 on 36 and 42 attention
calls); with `momentum` pretrain_mum's full recipe (the momentum encoder
with the 65,536-column queues and the local g2l losses, and the eval EMA:
chip_smoke's phase 23); with `caption`, `imgcls`, `ref` and `inpainting`
the last four phases at their defaults (phase 24: rows 3 and 4 on 18
attention calls). Takes two warm-up steps,
times UNTRACED steps on the host clock with a synchronise around each, then
traces STEPS steps with torch.profiler.
Prints, as one JSON line: the untraced and traced wall time per step; the
device-busy time (the union of kernel intervals, profiler ranges left out)
and the device's idle share of the traced wall; the host time of the step's
phases (the trainer's `step/*` ranges and ITC's `itc/sims`, under the
profiler) and the device busy time inside each (the union of the kernel
intervals within the range on the device's timeline); the device
time by kernel family, the port's attention kernels' share of the busy
time; and the kernels' device time grouped by name. Needs
a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import (  # noqa: E402
    MOMENTUM_OVERRIDES,
    NLVR2_OVERRIDES,
    REST_OVERRIDES,
    RETRIEVAL_OVERRIDES,
    TRAIN_OVERRIDES,
    TXT_OVERRIDES,
    VIS_OVERRIDES,
    VQA_OVERRIDES,
    W8A8_VQA_OVERRIDES,
    card_line,
)
from torch_profile_vqa import busy_us  # noqa: E402

from exploremultimodal_torch.config import load_config  # noqa: E402
from exploremultimodal_torch.train.trainer import Trainer  # noqa: E402

STEPS = 2  # traced steps, after two warm-up ones
UNTRACED = 3  # host-clock steps before the trace
TOP = 20
PHASES = ("step/batch", "step/momentum", "step/forward", "step/backward", "step/optimizer",
          "step/ema", "itc/sims")
# kernel families, by the first substring of the kernel's name that matches
FAMILIES = (
    ("port attention kernels", ("flash_", "attn_stream_sm90", "attn_fwd_sm90", "attn_bwd_sm90")),
    ("port int8 kernels", ("w8a8_",)),
    ("port fused MLP kernels", ("mlp_sm90", "mlp_sum_splits")),
    ("cuBLAS/cuDNN GEMM and conv", ("nvjet", "gemm", "cutlass", "sm90_", "conv", "cudnn")),
    ("reductions", ("reduce_kernel", "norm", "softmax")),
    ("elementwise and copies", ("elementwise", "copy", "Memcpy", "Memset", "fill",
                                "cat", "index", "gather", "scatter")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_profile_train: no CUDA device", file=sys.stderr)
        return 1
    cells = {(): TRAIN_OVERRIDES,
             ("drop0",): TRAIN_OVERRIDES + ["attn_impl=pallas", "model.attn_drop_rate=0.0"],
             ("vqa",): VQA_OVERRIDES,
             ("vqa_w8a8",): W8A8_VQA_OVERRIDES,
             ("txt",): TXT_OVERRIDES,
             ("vis",): VIS_OVERRIDES,
             ("vis_mae",): VIS_OVERRIDES + ["train.loss_names=[mae]"],
             ("nlvr2",): NLVR2_OVERRIDES,
             ("retrieval",): RETRIEVAL_OVERRIDES,
             ("momentum",): MOMENTUM_OVERRIDES,
             ("caption",): REST_OVERRIDES["caption"],
             ("imgcls",): REST_OVERRIDES["imgcls"],
             ("ref",): REST_OVERRIDES["ref"],
             ("inpainting",): REST_OVERRIDES["inpainting"]}
    if tuple(argv) not in cells:
        print("usage: torch_profile_train.py [drop0 | vqa | vqa_w8a8 | txt | vis | vis_mae | "
              "nlvr2 | retrieval | momentum | caption | imgcls | ref | inpainting]",
              file=sys.stderr)
        return 2
    card = card_line()
    overrides = cells[tuple(argv)]
    cfg = load_config(overrides)
    trainer = Trainer(cfg, device="cuda")
    for _ in range(2):
        trainer.step()
    untraced = []
    for _ in range(UNTRACED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step()
        torch.cuda.synchronize()
        untraced.append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            trainer.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    by_family: dict[str, float] = defaultdict(float)
    phases: dict[str, float] = defaultdict(float)
    ranges = []  # (name, start, end) of each range on the device's timeline
    intervals = []
    for ev in prof.events():
        dur = ev.time_range.elapsed_us()
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            if ev.name in PHASES:
                phases[ev.name] += dur
            continue
        if getattr(ev, "is_user_annotation", False):
            # a profiler range on the device timeline, not a kernel
            if ev.name in PHASES:
                ranges.append((ev.name, ev.time_range.start, ev.time_range.start + dur))
            continue
        start = ev.time_range.start
        intervals.append((start, start + dur))
        by_name[ev.name][0] += dur
        by_name[ev.name][1] += 1
        by_family[family(ev.name)] += dur
    busy = busy_us(intervals)
    range_busy: dict[str, float] = defaultdict(float)
    for name, lo, hi in ranges:
        range_busy[name] += busy_us([(max(a, lo), min(b, hi)) for a, b in intervals
                                     if a < hi and b > lo])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    print(json.dumps({
        "card": card, "overrides": overrides,
        "batch": cfg["data"]["batch_size"], "steps": STEPS,
        "untraced_ms_per_step": untraced,
        "wall_ms_per_step": wall_us / 1e3 / STEPS,
        "device_busy_ms_per_step": busy / 1e3 / STEPS if intervals else None,
        "device_idle_share": 1.0 - busy / wall_us if intervals else None,
        "kernel_launches_per_step": len(intervals) / STEPS,
        "phase_host_ms_per_step": {k: phases[k] / 1e3 / STEPS for k in PHASES},
        "phase_device_busy_ms_per_step": {k: range_busy[k] / 1e3 / STEPS
                                          for k in PHASES},
        "family_device_ms_per_step": {k: v / 1e3 / STEPS for k, v in
                                      sorted(by_family.items(), key=lambda kv: -kv[1])},
        "attention_share_of_busy": (by_family["port attention kernels"] / busy
                                    if intervals else None),
        "kernels": [{"name": k[:90], "ms_per_step": v[0] / 1e3 / STEPS,
                     "calls_per_step": v[1] / STEPS}
                    for k, v in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
