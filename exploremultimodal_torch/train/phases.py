"""Phase driver (counterpart of `exploremultimodal_tpu/train/phases.py`)
for the phases the port trains: pretrain_mum, pretrain_txt and
finetune_vqa. They share one `Trainer`; `eval_mode` restores the newest
checkpoint through `checkpoints.auto_load` and evaluates, and
`throughput_mode` times the step.

finetune_vqa's test-split submission (`write_vqa_submission`) is not
ported yet; the driver warns after training, as JAX warns when the
submission cannot be written.
"""

from __future__ import annotations

from typing import Any

from exploremultimodal_torch.train import checkpoints as ckpt_lib
from exploremultimodal_torch.train.trainer import Trainer

TRAINED_PHASES = ("pretrain_mum", "pretrain_txt", "finetune_vqa")


def refuse_untrained(phase: str) -> None:
    if phase not in TRAINED_PHASES:
        raise NotImplementedError(f"train={phase}: the port trains {TRAINED_PHASES}")


def dispatch(cfg: dict, logger, device: str = "cuda") -> Any:
    phase = cfg["train"]["phase"]
    refuse_untrained(phase)
    trainer = Trainer(cfg, device=device, logger=logger)
    if cfg.get("throughput_mode"):
        return {"throughput": trainer.throughput()}
    if cfg.get("eval_mode"):
        ckpt_lib.auto_load(trainer.exp_dir, trainer.state, cfg, logger=logger)
        stats = trainer.evaluate()
        logger.info(f"eval: {stats}")
        return stats
    result = trainer.train()
    if phase == "finetune_vqa":
        logger.warning("VQA submission skipped: the test-split submission is not "
                       "ported yet")
    return result
