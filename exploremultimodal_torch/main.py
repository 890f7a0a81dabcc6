"""Command line: train with the JAX CLI's override syntax.

    python -m exploremultimodal_torch.main train=pretrain_mum model=vlmo_base \\
        'train.datasets=[synthetic]' train.discrete_vae_type=random \\
        data.batch_size=32 steps=10
    python -m exploremultimodal_torch.main train=finetune_vqa model=vlmo_base \\
        compute_dtype=bfloat16 model.mlp_impl=fused 'train.datasets=[synthetic]' \\
        data.batch_size=32 steps=10
    python -m exploremultimodal_torch.main train=pretrain_txt model=vlmo_base \\
        model.max_text_len=512 'train.datasets=[synthetic]' data.batch_size=32 steps=10

Runs on the GPU; `device=cpu` runs the plain PyTorch path on the CPU. Without
`steps=N` it trains `train.epochs` epochs of the loader. Each step's metrics
are printed as one JSON line.
"""

from __future__ import annotations

import json
import sys
import time

TRAINED_PHASES = ("pretrain_mum", "finetune_vqa", "pretrain_txt")


def main(argv: list[str] | None = None) -> int:
    from exploremultimodal_torch.config import load_config
    from exploremultimodal_torch.train.trainer import Trainer

    args = list(sys.argv[1:] if argv is None else argv)
    opts = {"steps": None, "device": "cuda"}
    overrides = []
    for arg in args:
        key, _, value = arg.partition("=")
        if key in opts:
            opts[key] = value
        else:
            overrides.append(arg)
    cfg = load_config(overrides)
    if cfg["train"]["phase"] not in TRAINED_PHASES:
        raise NotImplementedError(
            f"train={cfg['train']['phase']}: the port trains {TRAINED_PHASES}")
    trainer = Trainer(cfg, device=opts["device"])
    steps = (int(opts["steps"]) if opts["steps"] is not None
             else int(cfg["train"]["epochs"]) * trainer.steps_per_epoch)
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in trainer.step().items()}
        metrics["step"] = trainer.state.step
        metrics["step_s"] = time.perf_counter() - t0
        print(json.dumps(metrics), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
