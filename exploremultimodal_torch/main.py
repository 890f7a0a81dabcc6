"""Command line: the JAX CLI's override syntax, one experiment per call.

    python -m exploremultimodal_torch.main train=finetune_vqa model=vlmo_base \\
        compute_dtype=bfloat16 model.mlp_impl=fused 'train.datasets=[synthetic]' \\
        data.batch_size=32 train.epochs=2
    python -m exploremultimodal_torch.main train=pretrain_mum model=vlmo_base \\
        'train.datasets=[synthetic]' data.batch_size=32 throughput_mode=true
    python -m exploremultimodal_torch.main train=pretrain_txt model=vlmo_base \\
        model.max_text_len=512 'train.datasets=[synthetic]' data.batch_size=32 \\
        eval_mode=true

`setup` makes the experiment dir `exp_dir = <output_dir>/<phase>/<model>/<tag>`
(stable across relaunches: auto-resume scans it, timestamped subruns
included) and this run's dir `run_dir = <exp_dir>/<timestamp>` (its
checkpoints, `log_stats.json`, `log_p0.txt`, `config.json` and a tarball of
the package), then the phase driver runs `train.epochs` epochs, or
evaluates the newest checkpoint (`eval_mode=true`), or times the step
(`throughput_mode=true`).

Runs on the GPU; `device=cpu` runs the plain PyTorch path on the CPU.
`steps=N` only takes N steps, prints each step's metrics as one JSON line and
writes nothing.
"""

from __future__ import annotations

import json
import os
import sys
import tarfile
import time


def setup(overrides: list[str]) -> tuple[dict, object]:
    """The config of `overrides` with `exp_dir` and `run_dir` resolved and
    made, the run's logger, and the config and code snapshots."""
    from exploremultimodal_torch.config import load_config
    from exploremultimodal_torch.utils import create_logger

    cfg = load_config(overrides)
    if not cfg.get("exp_dir"):
        cfg["exp_dir"] = os.path.join(cfg.get("output_dir") or "output",
                                      cfg["train"]["phase"], cfg["model"]["name"],
                                      str(cfg.get("tag", "default")))
    if not cfg.get("run_dir"):
        cfg["run_dir"] = os.path.join(cfg["exp_dir"], time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(cfg["run_dir"], exist_ok=True)
    logger = create_logger(cfg["run_dir"], level=cfg.get("log_level", "info"))
    _write_config(cfg)
    _snapshot_code(cfg["run_dir"])
    logger.info(f"exp_dir: {cfg['exp_dir']}  run_dir: {cfg['run_dir']}")
    return cfg, logger


def _write_config(cfg: dict) -> None:
    """The config snapshot, as JSON (the card's machine has no PyYAML)."""
    with open(os.path.join(cfg["run_dir"], "config.json"), "w") as f:
        json.dump(cfg, f, indent=2, default=str)


def _snapshot_code(run_dir: str) -> None:
    """A tarball of the package, for the record of what ran."""
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    try:
        with tarfile.open(os.path.join(run_dir, "code_snapshot.tar.gz"), "w:gz") as tar:
            tar.add(pkg_dir, arcname="exploremultimodal_torch",
                    filter=lambda ti: None if "__pycache__" in ti.name
                    or ti.name.endswith("/build") else ti)
    except OSError:
        pass


def _steps(cfg: dict, steps: int, device: str) -> None:
    from exploremultimodal_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in trainer.step().items()}
        metrics["step"] = trainer.state.step
        metrics["step_s"] = time.perf_counter() - t0
        print(json.dumps(metrics), flush=True)


def main(argv: list[str] | None = None) -> int:
    from exploremultimodal_torch.config import load_config
    from exploremultimodal_torch.train.phases import dispatch, refuse_untrained

    args = list(sys.argv[1:] if argv is None else argv)
    opts = {"steps": None, "device": "cuda"}
    overrides = []
    for arg in args:
        key, _, value = arg.partition("=")
        if key in opts:
            opts[key] = value
        else:
            overrides.append(arg)
    # refused before `setup` makes any directory
    refuse_untrained(load_config(overrides)["train"]["phase"])
    if opts["steps"] is not None:
        _steps(load_config(overrides), int(opts["steps"]), opts["device"])
        return 0
    cfg, logger = setup(overrides)
    result = dispatch(cfg, logger, device=opts["device"])
    _write_config(cfg)
    if isinstance(result, dict) and "best_metric" in result:
        logger.info(f"best metric: {result['best_metric']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
