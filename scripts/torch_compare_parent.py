#!/usr/bin/env python3
"""Time rows 1-4 and 6-10 of two checkouts of the port on one GPU, in turns.

    python3 scripts/torch_compare_parent.py PARENT_DIR [--mlp]

PARENT_DIR is another checkout of the repository (e.g. a `git archive` of
the parent commit unpacked into a gitignored directory). The script runs
one worker process per turn, in the order parent, this tree, this tree,
parent; each worker imports `exploremultimodal_torch` from its own tree
(building its kernels there, every source at once), times that tree's
`flash_attention_bwd`
(row 2, the backward without dropout), `flash_attention_fwd_drop` (row 3)
and `flash_attention_bwd_drop` (row 4) at the pretrain_mum step's four
shapes (text 40, image 197 and fused 237 tokens at batch 32, ITM's fused
pair rows at batch 96; 12 heads, head dim 64, attention dropout 0.1), rows
2 and 4 also at N = 256, 333 and 512 at batch 8 and N = 333 and 512 at
batch 32, row 3 also at those past 256 keys, `flash_attention_fwd` (row 1)
at the same four step shapes and at N = 333, 512 and 577 at batch 8 and N
= 512 at batch 32, `w8a8_matmul` (row 8) for proj (N = 768) and qkv (N = 2,304)
at the int8 finetune_vqa step's and batch-64 request's M, and
`w8a8_mlp_fwd_drop` (row 10) at the finetune_vqa step's three FFN shapes
(M = 1,280, 6,304, 7,584 at batch 32; threshold 6554), `fused_mlp_fwd`
(row 6) and `w8a8_mlp_fwd` (row 9) at the batch-64 request's three (M =
2,560, 12,608, 15,168) and `fused_mlp_fwd_drop` (row 7) at the step's, all
at vlmo_base's widths, and at the step's M the tensor-split modes of a
tensor axis of 2: `w8a8_matmul_partial` (row 8 on proj's row share, K 384)
and `w8a8_mlp_fwd_drop_split` (row 10 on hidden 1,536), on the same seeded
inputs, and prints one JSON line (with the kernels whose build spilled,
from the first worker of each tree).
With `--mlp` it times rows 6-10 alone. The
times are device times (CUDA events around 20 calls queued behind a
device-side sleep, as `chip_smoke.time_ms`). Prints the card's name and
power limit first and a summary line last. Needs a CUDA device and nvcc;
imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
HEADS, HEAD_DIM, RATE, TEXT_LEN, IMAGE_LEN = 12, 64, 0.1, 40, 197
ATTN_SHAPES = {"text": (32, TEXT_LEN), "image": (32, IMAGE_LEN),
               "fused": (32, TEXT_LEN + IMAGE_LEN), "itm": (96, TEXT_LEN + IMAGE_LEN)}
# the backward alone past the step's shapes (batch, N)
BWD_SHAPES = {f"b{b}_n{n}": (b, n) for b, n in ((8, 256), (8, 333), (8, 512), (32, 333),
                                                (32, 512))}
# the forward without dropout past 256 keys
FWD_SHAPES = {f"b{b}_n{n}": (b, n) for b, n in ((8, 333), (8, 512), (8, 577), (32, 512))}
MATMUL_ROWS = (1280, 6304, 7584, 2560, 12608, 15168)
MLP_ROWS, MLP_THRESHOLD, WIDTH, HIDDEN = (1280, 6304, 7584), 6554, 768, 3072
SERVE_ROWS = (2560, 12608, 15168)
QUEUE_CYCLES = 40_000_000
ATTENTION = ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_fwd_drop",
             "flash_attention_bwd_drop")
MLP = ("fused_mlp_fwd", "fused_mlp_fwd_drop", "w8a8_matmul", "w8a8_mlp_fwd",
       "w8a8_mlp_fwd_drop", "w8a8_matmul_partial", "w8a8_mlp_fwd_drop_split")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def spilled(logs: dict) -> list[str]:
    """The kernels (mangled symbols) whose ptxas report in a build's logs
    shows spill stores; none where the tree's kernels were built before."""
    found, func = [], ""
    for _, log in logs.values():
        for line in log.splitlines():
            if "Function properties for" in line:
                func = line.split("Function properties for", 1)[1].strip()
            elif "spill stores" in line and " 0 bytes spill stores" not in line:
                found.append(func)
    return found


def worker(tree: Path, kernels: tuple) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from exploremultimodal_torch.ops import _build
    from exploremultimodal_torch.ops import flash_attention as fa
    from exploremultimodal_torch.ops import mlp_fused as mf
    from exploremultimodal_torch.ops import quant_fused as qf

    assert Path(fa.__file__).resolve().is_relative_to(tree.resolve()), fa.__file__
    logs = _build.build()
    dev = torch.device("cuda")
    out = {"tree": str(tree), "spilled": spilled(logs), **{name: {} for name in kernels}}
    rng = np.random.default_rng(1)
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    attention = {**ATTN_SHAPES, **BWD_SHAPES, **FWD_SHAPES} if ATTENTION[0] in kernels else {}
    for name, (b, n) in attention.items():
        g = torch.Generator(device=dev).manual_seed(b * 1000 + n)
        q, k, v, do = (torch.randn((b * HEADS, n, HEAD_DIM), generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        real = rng.integers(n // 2, n + 1, b)
        kb = torch.from_numpy(np.where(np.arange(n)[None, :] < real[:, None], 0.0, -1e30)
                              .astype(np.float32)).to(dev)
        scale = HEAD_DIM ** -0.5
        o, lse = fa.flash_attention_fwd_plain(q, k, v, kb, scale)
        od, lsed = fa.flash_attention_fwd_drop_plain(q, k, v, kb, seed, scale, RATE)
        if name in ATTN_SHAPES or name in FWD_SHAPES:
            out["flash_attention_fwd"][name] = time_ms(
                torch, lambda: fa.flash_attention_fwd(q, k, v, kb, scale))
        if n > fa.LONG_SEQ_THRESHOLD:
            continue
        out["flash_attention_bwd"][name] = time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, kb, o, do, lse, scale))
        if name in ATTN_SHAPES or n > 256:
            out["flash_attention_fwd_drop"][name] = time_ms(
                torch, lambda: fa.flash_attention_fwd_drop(q, k, v, kb, seed, scale, RATE))
        out["flash_attention_bwd_drop"][name] = time_ms(torch, lambda: fa.flash_attention_bwd_drop(
            q, k, v, kb, seed, od, do, lsed, scale, RATE))
        del q, k, v, do, o, lse, od, lsed
    g = torch.Generator(device=dev).manual_seed(4)
    for n_out in (WIDTH, 3 * WIDTH):
        qw, sw = qf.quantize_weights(torch.randn((n_out, WIDTH), generator=g, device=dev) * 0.02)
        for m in MATMUL_ROWS:
            x = torch.randn((m, WIDTH), generator=g, device=dev).to(torch.bfloat16)
            out["w8a8_matmul"][f"M={m} N={n_out}"] = time_ms(
                torch, lambda: qf.w8a8_matmul(x, qw, sw))
    g = torch.Generator(device=dev).manual_seed(6)
    w1 = torch.randn((HIDDEN, WIDTH), generator=g, device=dev) * 0.02
    w2 = torch.randn((WIDTH, HIDDEN), generator=g, device=dev) * 0.02
    b1 = torch.randn(HIDDEN, generator=g, device=dev) * 0.02
    b2 = torch.randn(WIDTH, generator=g, device=dev) * 0.02
    args = (*qf.quantize_weights(w1), b1, *qf.quantize_weights(w2), b2)
    for m in MLP_ROWS:
        x = torch.randn((m, WIDTH), generator=g, device=dev).to(torch.bfloat16)
        bits = torch.randint(-32768, 32768, (m, HIDDEN), dtype=torch.int16, generator=g,
                             device=dev)
        out["w8a8_mlp_fwd_drop"][f"M={m}"] = time_ms(torch, lambda: qf.w8a8_mlp_fwd_drop(
            x, *args, bits, MLP_THRESHOLD))
    for m in SERVE_ROWS:
        x = torch.randn((m, WIDTH), generator=g, device=dev).to(torch.bfloat16)
        out["w8a8_mlp_fwd"][f"M={m}"] = time_ms(torch, lambda: qf.w8a8_mlp_fwd(x, *args))
    w1h, w2h = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    for m in SERVE_ROWS + MLP_ROWS:
        x = torch.randn((m, WIDTH), generator=g, device=dev).to(torch.bfloat16)
        if m in SERVE_ROWS:
            out["fused_mlp_fwd"][f"M={m}"] = time_ms(
                torch, lambda: mf.fused_mlp_fwd(x, w1h, b1, w2h, b2))
            continue
        bits = torch.randint(-32768, 32768, (m, HIDDEN), dtype=torch.int16, generator=g,
                             device=dev)
        out["fused_mlp_fwd_drop"][f"M={m}"] = time_ms(
            torch, lambda: mf.fused_mlp_fwd_drop(x, w1h, b1, w2h, b2, bits, MLP_THRESHOLD))
    half, hs = WIDTH // 2, HIDDEN // 2
    qw1, sw1, _, qw2, sw2, _ = args
    share = (qw1[:hs].contiguous(), sw1[:hs].contiguous(), b1[:hs].contiguous(),
             qw2[:, :hs].contiguous(), sw2)
    qp, sp = qf.quantize_weights(torch.randn((WIDTH, half), generator=g, device=dev) * 0.02)
    for m in MLP_ROWS:
        x = torch.randn((m, WIDTH), generator=g, device=dev).to(torch.bfloat16)
        xs = x[:, :half].contiguous()
        amax = x.float().abs().amax(1)
        out["w8a8_matmul_partial"][f"M={m}"] = time_ms(
            torch, lambda: qf.w8a8_matmul_partial(xs, qp, sp, amax))
        bits = torch.randint(-32768, 32768, (m, hs), dtype=torch.int16, generator=g,
                             device=dev)
        out["w8a8_mlp_fwd_drop_split"][f"M={m}"] = time_ms(
            torch, lambda: qf.w8a8_mlp_fwd_drop_split(x, *share, bits, MLP_THRESHOLD,
                                                      lambda a: a))
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--worker":
        kernels = MLP if argv[2] == "--mlp" else ATTENTION + MLP
        print(json.dumps(worker(Path(argv[1]), kernels)), flush=True)
        return 0
    if len(argv) not in (1, 2) or argv[1:] not in ([], ["--mlp"]):
        print(__doc__, file=sys.stderr)
        return 2
    scope = "--mlp" if argv[1:] else "--all"
    kernels = MLP if argv[1:] else ATTENTION + MLP
    import torch

    if not torch.cuda.is_available():
        print("torch_compare_parent: no CUDA device", file=sys.stderr)
        return 1
    parent = Path(argv[0]).resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    runs = []
    for label, tree in (("parent", parent), ("change", HERE), ("change", HERE),
                        ("parent", parent)):
        res = subprocess.run([sys.executable, __file__, "--worker", str(tree), scope],
                             cwd=tree, check=True, capture_output=True, text=True)
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": label, **line}), flush=True)
        runs.append((label, line))
    summary = {}
    for kernel in kernels:
        for shape in runs[0][1][kernel]:
            summary[f"{kernel} {shape}"] = {
                label: [r[kernel][shape] for lab, r in runs if lab == label]
                for label in ("parent", "change")}
    print(json.dumps({"ms_parent_change_change_parent": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
