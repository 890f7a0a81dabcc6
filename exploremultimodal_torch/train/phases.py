"""Phase driver (counterpart of `exploremultimodal_tpu/train/phases.py`)
for the phases the port trains: pretrain_mum, pretrain_txt, pretrain_vis
(MIM, or MAE with `train.loss_names=[mae]`), finetune_vqa, finetune_nlvr2
and finetune_retrieval. They share one `Trainer`; `eval_mode` restores the
newest checkpoint through `checkpoints.auto_load` and evaluates, and
`throughput_mode` times the step. After training, finetune_retrieval
reports recall@{1,5,10} on the val split (`retrieval.evaluate_retrieval`),
as `result['recalls']`; JAX's phase skips it with a warning where it
fails, this one only where the losses have no ITC heads.

finetune_vqa's test-split submission (`write_vqa_submission`) is not
ported yet; the driver warns after training, as JAX warns when the
submission cannot be written.
"""

from __future__ import annotations

from typing import Any

from exploremultimodal_torch.train import checkpoints as ckpt_lib
from exploremultimodal_torch.train.retrieval import evaluate_retrieval
from exploremultimodal_torch.train.trainer import Trainer

TRAINED_PHASES = ("pretrain_mum", "pretrain_txt", "pretrain_vis", "finetune_vqa",
                  "finetune_nlvr2", "finetune_retrieval")


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
    if phase == "finetune_retrieval" and len(trainer.val_loader) > 0:
        if "itc" in trainer.config.loss_names:
            result["recalls"] = evaluate_retrieval(trainer)
            logger.info(f"retrieval recall: {result['recalls']}")
        else:
            logger.warning("retrieval recall skipped: it needs the ITC projection heads")
    return result
