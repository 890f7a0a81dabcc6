"""Phase driver (counterpart of `exploremultimodal_tpu/train/phases.py`)
for every phase the JAX package registers: pretrain_mum, pretrain_txt,
pretrain_vis (MIM, or MAE with `train.loss_names=[mae]`), finetune_vqa,
finetune_nlvr2, finetune_retrieval, finetune_caption (MLM over image-text
pairs), finetune_vis (image classification), finetune_ref (referring
boxes) and finetune_inpainting (MIM on the fused stream, region masks with
`data.mask_style=region`). They share one `Trainer`; `eval_mode` restores
the newest checkpoint through `checkpoints.auto_load` and evaluates, and
`throughput_mode` times the step. After training, finetune_vqa writes its
test-split submission (`write_vqa_submission`) and finetune_retrieval
reports recall@{1,5,10} on the val split (`retrieval.evaluate_retrieval`),
as `result['recalls']`; JAX's phases skip each with a warning where it
fails, these only where the recall's losses have no ITC heads.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from exploremultimodal_torch.data.vqa_vocab import load_or_build_vqa_vocab
from exploremultimodal_torch.parallel.partitioning import barrier, is_main
from exploremultimodal_torch.train import checkpoints as ckpt_lib
from exploremultimodal_torch.train.retrieval import evaluate_retrieval
from exploremultimodal_torch.train.trainer import Trainer

TRAINED_PHASES = ("pretrain_mum", "pretrain_txt", "pretrain_vis", "finetune_vqa",
                  "finetune_nlvr2", "finetune_retrieval", "finetune_caption",
                  "finetune_vis", "finetune_ref", "finetune_inpainting")


def refuse_untrained(phase: str) -> None:
    if phase not in TRAINED_PHASES:
        raise NotImplementedError(
            f"train={phase}: unknown phase; the port trains {TRAINED_PHASES}")


def write_vqa_submission(trainer: Trainer) -> str | None:
    """finetune_vqa's test-split answers, as JAX's `write_vqa_submission`:
    the argmax answer of each test question under the task's own
    parameters (a deterministic forward), through the `vqa_dict.json`
    vocabulary, each process's stride of the split to
    `<output_dir>/submit/vqa_submit_<rank>.json`; after a barrier rank 0
    merges the parts in rank order into `vqa_submit.json`, whose path it
    returns (the other ranks their part's; None where the test split is
    empty). The question id is the batch's `qid`, which the VQA arrow
    tables give; the synthetic samples carry none, and their index stands
    in for it (JAX's raises there, and its phase skips the submission with
    a warning)."""
    loader = trainer.data.test_loader()
    if len(loader) == 0:
        trainer.logger.info("no VQA test split available; skipping submission")
        return None
    id2answer = load_or_build_vqa_vocab()["id2answer"]
    preds, qids = [], []
    with torch.no_grad():
        for batch in loader.epoch(0):
            logits = trainer.task(trainer.model_batch(batch))["vqa_logits"]
            preds.append(logits.argmax(-1))
            qids += batch["qid" if "qid" in batch else "index"].tolist()
    preds = torch.cat(preds).tolist()
    results = [{"question_id": int(q), "answer": id2answer.get(int(p), "")}
               for q, p in zip(qids, preds)]
    out_dir = os.path.join(trainer.output_dir, "submit")
    os.makedirs(out_dir, exist_ok=True)
    # one part per data coordinate (tensor peers answer the same rows)
    mesh = trainer.mesh
    part = os.path.join(out_dir, f"vqa_submit_{mesh.data_rank}.json")
    if mesh.tensor_rank == 0:
        with open(part, "w") as f:
            json.dump(results, f)
    barrier()
    if not is_main():
        return part
    merged = []
    for r in range(mesh.data_size):
        with open(os.path.join(out_dir, f"vqa_submit_{r}.json")) as f:
            merged += json.load(f)
    final = os.path.join(out_dir, "vqa_submit.json")
    with open(final, "w") as f:
        json.dump(merged, f)
    trainer.logger.info(f"wrote VQA submission ({len(merged)} answers) → {final}")
    return final


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
        result["submission"] = write_vqa_submission(trainer)
    if phase == "finetune_retrieval" and len(trainer.val_loader) > 0:
        if "itc" in trainer.config.loss_names:
            result["recalls"] = evaluate_retrieval(trainer)
            logger.info(f"retrieval recall: {result['recalls']}")
        else:
            logger.warning("retrieval recall skipped: it needs the ITC projection heads")
    return result
