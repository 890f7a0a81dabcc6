#!/usr/bin/env python3
"""Drive the PyTorch port (exploremultimodal_torch) on one CUDA GPU.

    python3 chip_smoke.py        # from the repository root; needs one GPU and nvcc

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every CUDA kernel of the serving path from the checkout's sources
     (nvcc, sm_90a, all at once) into exploremultimodal_torch/ops/build/;
  3. at each shape the VQA serving path gives each kernel, hold the kernel
     against its plain PyTorch version on the card, then time the kernel, the
     plain version and a library call computing the same function (the MLP
     also at M = 64, one block's time);
  4. serve batch-64 VQA requests through `Predictor.vqa_logits` at vlmo_base
     full width and depth (bf16, attn_impl=pallas, mlp_impl=fused, seeded
     random weights), check that every request went through both kernels,
     compare two requests with the CPU's plain path, and time the requests;
  5. print the kernel table as one JSON line, the card line, and last
     {"ok": true, "device": {...}}.
It imports nothing of JAX. The bounds use the H100 SXM data-sheet peaks.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from exploremultimodal_torch.config import VlmoConfig, load_config
from exploremultimodal_torch.infer import Predictor
from exploremultimodal_torch.models import build_model
from exploremultimodal_torch.ops import _build
from exploremultimodal_torch.ops.attention import key_padding_bias
from exploremultimodal_torch.ops.flash_attention import (
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from exploremultimodal_torch.ops.mlp_fused import fused_mlp_fwd, fused_mlp_fwd_plain

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

SERVE_OVERRIDES = [
    "model=vlmo_base", "train=finetune_vqa", "compute_dtype=bfloat16",
    "attn_impl=pallas", "model.mlp_impl=fused",
]
BATCH = 64
N_REQUESTS = 6  # the first is the warm-up; latency is taken over the rest
CPU_CHECK_REQUESTS, CPU_CHECK_ROWS = 2, 4

# kernel vs plain version on the card, both bf16 out. The attention kernel
# keeps 16 mantissa bits of p for its second product and sums in another
# order in fp32; both round the output to bf16, so they may differ by one
# bf16 ulp (at most 2**-7 of |out|) plus the fp32 differences (1e-4 covers
# them at |out| near 0). lse is fp32 on both sides (|lse| < 20). The MLP sums
# in another order in fp32, which can flip the bf16 rounding of a hidden
# value, and both round y (|y| < 4) to bf16: one ulp is at most 2**-6.
ATTN_ATOL, ATTN_RTOL, ATTN_LSE_ATOL = 1e-4, 2 ** -7, 1e-4
MLP_ATOL, MLP_RTOL = 2 ** -6, 2 ** -7
# GPU kernels vs the CPU plain path, end to end in bf16 over 12 blocks and
# the 3129-way head: bf16 rounding (2**-8 relative) at every layer, in other
# places on the two devices.
E2E_ATOL = 0.05


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def text_mask(rng: np.random.Generator, batch: int, length: int) -> np.ndarray:
    """Questions of 6..20 tokens padded to `length`, as VQAv2's are."""
    lens = rng.integers(6, 21, batch)
    return (np.arange(length)[None, :] < lens[:, None]).astype(np.int32)


def check_attention(cfg: VlmoConfig, rng: np.random.Generator, dev) -> list[dict]:
    heads, d = cfg.num_heads, cfg.embed_dim // cfg.num_heads
    n_img = (cfg.img_size // cfg.patch_size) ** 2 + 1
    txt = text_mask(rng, BATCH, cfg.max_text_len)
    masks = {
        "text": txt,
        "image": np.ones((BATCH, n_img), np.int32),
        "fused": np.concatenate([txt, np.ones((BATCH, n_img), np.int32)], 1),
    }
    rows = []
    for stream, mask in masks.items():
        n, bh = mask.shape[1], BATCH * heads
        g = torch.Generator(device=dev).manual_seed(n)
        q, k, v = (torch.randn((bh, n, d), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        kb = key_padding_bias(torch.from_numpy(mask).to(dev)).reshape(BATCH, n)
        kb = kb.contiguous()
        scale = d ** -0.5
        out, lse = flash_attention_fwd(q, k, v, kb, scale)
        ref, ref_lse = flash_attention_fwd_plain(q, k, v, kb, scale)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        require(bool(torch.isfinite(out.float()).all()), f"attention {stream}: non-finite")
        require(bool((diff <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()).all())
                and lse_err <= ATTN_LSE_ATOL,
                f"attention {stream} N={n}: max|out err| {err} beyond atol "
                f"{ATTN_ATOL} + rtol {ATTN_RTOL}, or max|lse err| {lse_err} "
                f"beyond {ATTN_LSE_ATOL}")
        q4, k4, v4 = (t.view(BATCH, heads, n, d) for t in (q, k, v))
        mask4 = kb.to(torch.bfloat16).view(BATCH, 1, 1, n)
        nbytes = 4 * bh * n * d * 2 + BATCH * n * 4 + bh * n * 4
        bound_ms, bound_by = bound(nbytes, 4 * bh * n * n * d)
        rows.append({
            "stream": stream, "shape": f"BH={bh} N={n} D={d}",
            "max_abs_err": err, "lse_max_abs_err": lse_err,
            "ms": time_ms(lambda: flash_attention_fwd(q, k, v, kb, scale)),
            "plain_ms": time_ms(lambda: flash_attention_fwd_plain(q, k, v, kb, scale)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask4, scale=scale)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
    return rows


def check_mlp(cfg: VlmoConfig, dev) -> list[dict]:
    k = n_out = cfg.embed_dim
    h = int(cfg.embed_dim * cfg.mlp_ratio)
    n_img = (cfg.img_size // cfg.patch_size) ** 2 + 1
    g = torch.Generator(device=dev).manual_seed(1)
    w1 = (torch.randn((h, k), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    w2 = (torch.randn((n_out, h), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    b1 = torch.randn(h, generator=g, device=dev) * 0.02
    b2 = torch.randn(n_out, generator=g, device=dev) * 0.02
    b1h, b2h = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
    rows = []
    # "probe" is no path shape: M = 64 is two blocks on 132 SMs, so its time
    # is that of one block's chain of chunks, which the path shapes repeat
    # once per wave.
    for stream, tokens in (("probe", 1), ("text", cfg.max_text_len), ("image", n_img),
                           ("fused", cfg.max_text_len + n_img)):
        m = BATCH * tokens
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        y = fused_mlp_fwd(x, w1, b1, w2, b2)
        ref = fused_mlp_fwd_plain(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        diff = (y.float() - ref.float()).abs()
        err = diff.max().item()
        require(bool(torch.isfinite(y.float()).all()), f"mlp {stream}: non-finite")
        require(bool((diff <= MLP_ATOL + MLP_RTOL * ref.float().abs()).all()),
                f"mlp {stream} M={m}: max|err| {err} beyond atol {MLP_ATOL} "
                f"+ rtol {MLP_RTOL}")
        nbytes = 2 * (m * k + h * k + n_out * h + m * n_out) + 4 * (h + n_out)
        bound_ms, bound_by = bound(nbytes, 2 * m * (k * h + h * n_out))
        rows.append({
            "stream": stream, "shape": f"M={m} K={k} H={h} N={n_out}",
            "max_abs_err": err,
            "ms": time_ms(lambda: fused_mlp_fwd(x, w1, b1, w2, b2)),
            "plain_ms": time_ms(lambda: fused_mlp_fwd_plain(x, w1, b1, w2, b2)),
            "library_ms": time_ms(lambda: F.linear(
                F.gelu(F.linear(x, w1, b1h), approximate="tanh"), w2, b2h)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
    return rows


def make_requests(cfg: VlmoConfig, rng: np.random.Generator, count: int = N_REQUESTS):
    """`count` batches of (uint8 NHWC images, token ids, attention mask)."""
    reqs = []
    for _ in range(count):
        img = rng.integers(0, 256, (BATCH, cfg.img_size, cfg.img_size, 3),
                           dtype=np.uint8)
        mask = text_mask(rng, BATCH, cfg.max_text_len)
        ids = rng.integers(1000, cfg.vocab_size, mask.shape).astype(np.int32)
        ids[:, 0] = 101  # [CLS]
        ids[np.arange(BATCH), mask.sum(1) - 1] = 102  # [SEP]
        ids[mask == 0] = 0  # [PAD]
        reqs.append((img, ids, mask))
    return reqs


def serve(cfg_dict: dict, cfg: VlmoConfig, card: str) -> dict:
    t0 = time.perf_counter()
    state = build_model(cfg_dict, device="cpu", seed=0).state_dict()
    gpu = Predictor(cfg_dict, state, max_batch=BATCH, device="cuda")
    print(f"serve: vlmo_base weights (seed 0) ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reqs = make_requests(cfg, np.random.default_rng(0))

    flash_attention_fwd.launches = 0
    fused_mlp_fwd.launches = 0
    latencies, outputs = [], []
    for img, ids, mask in reqs:
        t = time.perf_counter()
        logits = gpu.vqa_logits(img, ids, mask)
        latencies.append(time.perf_counter() - t)
        outputs.append(logits)
    launches = {"flash_attention_fwd": flash_attention_fwd.launches,
                "fused_mlp_fwd": fused_mlp_fwd.launches}

    per_request = 2 * cfg.fusion_layer + (cfg.depth - cfg.fusion_layer)
    for name, count in launches.items():
        require(count == per_request * N_REQUESTS,
                f"{name}: {count} launches for {N_REQUESTS} requests, expected "
                f"{per_request} per request")
    for logits in outputs:
        require(logits.shape == (BATCH, cfg.vqa_label_size)
                and bool(np.isfinite(logits).all()),
                f"bad logits: shape {logits.shape}, finite {np.isfinite(logits).all()}")
    answers = gpu.answers(outputs[0])
    require(len(answers) == BATCH and all(isinstance(a, str) for a in answers),
            "answer mapping failed")

    cpu = Predictor(cfg_dict, state, max_batch=BATCH, device="cpu")
    errs, agree = [], []
    for r in range(CPU_CHECK_REQUESTS):
        img, ids, mask = (a[:CPU_CHECK_ROWS] for a in reqs[r])
        ref = cpu.vqa_logits(img, ids, mask)
        got = outputs[r][:CPU_CHECK_ROWS]
        errs.append(float(np.abs(got - ref).max()))
        agree.append(float((got.argmax(-1) == ref.argmax(-1)).mean()))
    max_logit = float(max(np.abs(o).max() for o in outputs))
    print(f"serve: GPU vs CPU plain path on {CPU_CHECK_ROWS} rows of "
          f"{CPU_CHECK_REQUESTS} requests: max|logit err| {errs} "
          f"(tol {E2E_ATOL}, max|logit| {max_logit:.3f}), argmax agreement {agree}",
          flush=True)
    require(max(errs) <= E2E_ATOL, f"GPU logits differ from the CPU path: {errs}")

    steady = latencies[1:]
    med = statistics.median(steady)
    result = {
        "card": card, "batch": BATCH, "requests": N_REQUESTS,
        "first_request_ms": latencies[0] * 1e3,
        "latency_ms": [x * 1e3 for x in steady],
        "median_latency_ms": med * 1e3,
        "images_per_s": BATCH / med,
        "launches": launches, "launches_per_request": per_request,
        "cpu_check_max_abs_err": errs, "cpu_check_argmax_agreement": agree,
        "sample_answers": answers[:4],
    }
    print("serve: " + json.dumps(result), flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall", flush=True)
    for name, (secs, log) in logs.items():
        print(f"build: {name} {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "bytes smem" in line:
                print(f"  {line.strip()}", flush=True)

    cfg_dict = load_config(SERVE_OVERRIDES)
    cfg = VlmoConfig.from_config(cfg_dict)
    attn_rows = check_attention(cfg, np.random.default_rng(0), dev)
    mlp_rows = check_mlp(cfg, dev)
    for row in attn_rows + mlp_rows:
        print("kernel: " + json.dumps(row), flush=True)

    launches = serve(cfg_dict, cfg, card)

    def entry(name, route, source, replaces, rows):
        fused = rows[-1]  # the fused stream: the largest shape on the path
        return {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": fused["ms"], "plain_ms": fused["plain_ms"],
            "bound_ms": fused["bound_ms"], "bound_by": fused["bound_by"],
            "library_ms": fused["library_ms"],
        }

    kernels = [
        entry("flash_attention_fwd", "cuda",
              "exploremultimodal_torch/ops/csrc/flash_attention_fwd.cu",
              "exploremultimodal_tpu/ops/flash_attention.py:152", attn_rows),
        entry("fused_mlp_fwd", "cuda",
              "exploremultimodal_torch/ops/csrc/fused_mlp_fwd.cu",
              "exploremultimodal_tpu/ops/mlp_pallas.py:56", mlp_rows),
    ]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
