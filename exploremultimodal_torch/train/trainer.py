"""The trainer of the pretrain_mum, pretrain_txt, pretrain_vis (MIM or
MAE), finetune_vqa, finetune_nlvr2 and finetune_retrieval phases on one
GPU: the step, the epochs around it with evaluation, checkpoints and
auto-resume, and throughput mode.

Counterpart of `exploremultimodal_tpu/train/trainer.py` at one process
(`train.global_reduce` is the identity there, as in JAX at a 1-device data
axis). A step:

  uint8 batch -> device (pinned memory) -> preprocessing -> frozen dVAE
  tokens under no_grad (MIM labels, where MIM is trained; the dVAE's trunk
  on int8 codes under `train.discrete_vae_quantize`) -> with `vlmo_ema`,
  the momentum encoder's ITC features under no_grad, with dropout off ->
  the phase's losses (ITC against the momentum features and the negative
  queues where they are on; VQA with the ISDA statistics carried from
  step to step) -> backward -> AdamW step with the scheduled learning
  rate -> the momentum and eval EMA updates, each at its own decay -> the
  queues take the full batch's momentum features

With `train.accumulation_steps` = A > 1 the losses and the backward run on
A contiguous microbatches of the batch, each against the full batch's
momentum features (its positives at its row offset) and its own dropout
draws; the gradients, the loss and the scalar metrics are the means over
the microbatches, and ISDA's statistics pass from one to the next.

The phases of a step are `torch.profiler` ranges (`step/batch`,
`step/momentum`, `step/forward`, `step/backward`, `step/optimizer`,
`step/ema`; and `itc/sims` inside ITC), which cost nothing without a
profiler; `scripts/torch_profile_train.py` reads them.

`train` runs the epochs from `train.start_epoch` (or the epoch after the
checkpoint `checkpoints.auto_load` restores), evaluates after each on the
val split (`evaluate`: count-weighted means of a deterministic forward
under no_grad), keeps the best `minimize_metric`, saves every
`train.save_freq` epochs and appends the epoch's means to
`log_stats.json`. Device values are read on the host only at the logging
cadence (`train.print_freq`, every 50 steps for the metric sink) and once
per epoch, so the loop adds no sync to a step.

Parameters and optimizer state are fp32; activations run in
`compute_dtype`, as in the JAX trainer. The entry point runs on CUDA unless
the caller passes device="cpu".
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Iterator

import numpy as np
import torch
from torch.profiler import record_function

from exploremultimodal_torch.config import VlmoConfig
from exploremultimodal_torch.data.datasets import build_dataset
from exploremultimodal_torch.data.pipeline import Loader, to_device
from exploremultimodal_torch.models.dvae import create_d_vae
from exploremultimodal_torch.models.task import (
    TRAINED_OBJECTIVES,
    VlmoTask,
    resolve_device,
    total_loss,
)
from exploremultimodal_torch.ops.preprocess import preprocess_batch
from exploremultimodal_torch.train.optim import (
    create_optimizer,
    flax_path,
    global_norm,
    phase_frozen_predicate,
)
from exploremultimodal_torch.train import checkpoints as ckpt_lib
from exploremultimodal_torch.train.state import (
    TrainState,
    create_train_state,
    ema_update,
    queue_update,
)
from exploremultimodal_torch.utils import MetricLogger, create_logger
from exploremultimodal_torch.utils.experiment_log import ExperimentLogger
from exploremultimodal_torch.utils.metrics import read_floats
from exploremultimodal_torch.utils.profiling import check_finite_and_dump, trace

METRIC_KEYS = ("_task_loss", "_Loss", "_mean_acc", "_mean_score", "itc_temp",
               "_dropped_positions")


def _metrics_from_outputs(outputs: dict) -> dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in outputs.items()
            if k.endswith(METRIC_KEYS)
            and isinstance(v, torch.Tensor) and v.ndim == 0}


def _rows(v) -> int | None:
    """A batch entry's rows: a tensor's first dimension or a list's length;
    None for a 0-d tensor or anything else."""
    if isinstance(v, torch.Tensor):
        return v.shape[0] if v.ndim else None
    return len(v) if isinstance(v, list) else None


def _refuse_unported(cfg: dict) -> None:
    """Losses without a ported head raise NotImplementedError (and every
    dataset but the synthetic one, in `build_dataset`)."""
    bad = sorted(set(cfg["train"]["loss_names"]) - set(TRAINED_OBJECTIVES))
    if bad:
        raise NotImplementedError(
            f"not ported yet: loss_names {bad} (the port trains "
            f"{'/'.join(TRAINED_OBJECTIVES)})")


log = logging.getLogger(__name__)


def dvae_type(train_cfg: dict) -> str:
    """`train.discrete_vae_type` as the JAX trainer resolves it
    (`Trainer._dvae_type`): 'dall-e' without an `encoder.pkl` under
    `train.discrete_vae_weight_path` falls back, with a warning, to the
    seeded random tokenizer; every other case passes through."""
    kind = train_cfg.get("discrete_vae_type", "dall-e")
    path = train_cfg.get("discrete_vae_weight_path", "")
    if kind == "dall-e" and not os.path.exists(os.path.join(path, "encoder.pkl")):
        log.warning("dVAE weights not found at %r — using a randomly initialized "
                    "tokenizer (MIM targets will be untrained codes)", path)
        return "random"
    return kind


class Trainer:
    """Builds the task, the frozen tokenizer, the data and the optimizer
    from `cfg` (a `config.load_config` dict); takes training steps and runs
    epochs. The run dir (`output_dir`: checkpoints, `log_stats.json`, the
    metric sink) and the experiment dir that auto-resume scans (`exp_dir`)
    resolve as in JAX's trainer. Without a `logger` it logs to stderr only;
    `main.setup` gives it one that also writes to the run dir."""

    def __init__(self, cfg: dict, device: str | torch.device = "cuda", logger=None):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output_dir = (cfg.get("run_dir") or cfg.get("exp_dir")
                           or cfg.get("output_dir", "output"))
        self.exp_dir = cfg.get("exp_dir") or self.output_dir
        self.logger = logger or create_logger(level=cfg.get("log_level", "info"))
        self.exp_logger: ExperimentLogger | None = None
        self.config = c = VlmoConfig.from_config(cfg)
        task = VlmoTask(c)
        task.init_weights(torch.Generator().manual_seed(int(cfg["seed"])))
        # fp32 master weights; the Linears cast to the compute dtype at use
        self.task = task.to(device=self.device, dtype=torch.float32).train()

        t = cfg["train"]
        self.dvae = None
        if "mim" in c.loss_names:
            self.dvae = create_d_vae(
                dvae_type(t), c.img_size // 2, c.dtype,
                quantize=t.get("discrete_vae_quantize") or "none", device=self.device,
                weight_path=t.get("discrete_vae_weight_path", ""))

        d = cfg["data"]
        self.loader = Loader(build_dataset(cfg), d["batch_size"], seed=int(cfg["seed"]))
        self.val_loader = Loader(build_dataset(cfg, "val"),
                                 d.get("eval_batch_size") or d["batch_size"],
                                 seed=int(cfg["seed"]), train=False)
        self.steps_per_epoch = max(len(self.loader), 1)
        frozen = phase_frozen_predicate(tuple(t["loss_names"]), t.get("phase"),
                                        t.get("mim_head_pos", "img"))
        trainable = {}
        for name, p in self.task.named_parameters():
            if frozen is not None and frozen(flax_path(name)):
                p.requires_grad_(False)
            else:
                trainable[name] = p
        optimizer, self.schedule = create_optimizer(cfg, trainable,
                                                    self.steps_per_epoch)
        self.accum = int(t.get("accumulation_steps", 1))
        if self.accum < 1:
            raise ValueError(f"train.accumulation_steps={self.accum}")
        # two independent EMA trees, as in JAX: the ITC momentum encoder
        # (vlmo_ema) and the checkpointed eval EMA (model_ema); the queues
        # are built under neg_queue whether or not the momentum branch runs
        self.state: TrainState = create_train_state(
            self.task, optimizer, int(cfg["seed"]) + 7,
            isda_classes=c.vqa_label_size if c.isda_lambda > 0 else 0,
            isda_dim=2 * c.embed_dim,
            ema_decay=cfg.get("vlmo_ema_decay", 0.995) if cfg.get("vlmo_ema") else None,
            model_ema_decay=(cfg.get("model_ema_decay", 0.9999) if cfg.get("model_ema")
                             else None),
            queue_size=int(t.get("queue_size", 0)) if t.get("neg_queue") else 0,
            itc_dim=c.itc_dim)
        self._batches: Iterator[dict] | None = None

    # ------------------------------------------------------------------ data

    def next_batch(self) -> dict[str, Any]:
        """The next host batch of the epoch order (epochs repeat)."""
        while True:
            if self._batches is None:
                self._batches = self.loader.epoch(
                    self.state.step // self.steps_per_epoch)
            batch = next(self._batches, None)
            if batch is not None:
                return batch
            self._batches = None

    def model_batch(self, batch: dict[str, Any],
                    mim_labels: torch.Tensor | None = None) -> dict:
        """Device copy, preprocessing, and the frozen dVAE's MIM labels
        (`mim_labels`, where given, replaces them)."""
        mb = preprocess_batch(to_device(batch, self.device), self.config.dtype)
        if mim_labels is not None:
            mb["mim_labels"] = mim_labels.to(self.device)
        elif self.dvae is not None and "image4dalle" in mb:
            with torch.no_grad():
                mb["mim_labels"] = self.dvae.get_codebook_indices(mb["image4dalle"])
        return mb

    # ------------------------------------------------------------------ step

    def momentum_branch(self, mb: dict) -> tuple[dict | None, dict | None]:
        """The momentum encoder's features of the full batch under no_grad,
        with dropout off, and the queues where they are used; (None, None)
        without `vlmo_ema`. The same features feed every microbatch's loss
        and the step's queue update."""
        st = self.state
        if st.ema_task is None:
            return None, None
        with torch.no_grad():
            feats = st.ema_task.itc_momentum_feats(mb)
        queue = None if st.img_queue is None else {"img": st.img_queue,
                                                   "txt": st.txt_queue}
        return feats, queue

    def step(self, batch: dict[str, Any] | None = None, *, negatives=None,
             mim_labels: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """One training step on `batch` (default: the next of the loader).
        Returns the step's metrics as 0-d device tensors; nothing here waits
        for the device. The gradients stay on the parameters until the next
        step. `negatives` and `mim_labels` replace the sampled ITM negatives
        and the dVAE labels (for comparisons across devices); under
        accumulation the one pair of `negatives` serves every microbatch."""
        st = self.state
        # ISDA's strength ramps with the epoch, as in the JAX trainer
        epoch = st.step // self.steps_per_epoch
        isda_ratio = (self.config.isda_lambda * epoch
                      / max(int(self.cfg["train"]["epochs"]), 1))
        flat = bool(self.cfg["train"].get("flat_loss"))
        with record_function("step/batch"):
            mb = self.model_batch(self.next_batch() if batch is None else batch,
                                  mim_labels)
        with record_function("step/momentum"):
            momentum_feats, queue = self.momentum_branch(mb)
        st.optimizer.zero_grad()
        accum = self.accum
        rows = next(v.shape[0] for v in mb.values()
                    if isinstance(v, torch.Tensor) and v.ndim > 0)
        if rows % accum:
            raise ValueError(f"batch of {rows} rows in {accum} microbatches")
        size = rows // accum
        sums: dict[str, torch.Tensor] = {}
        isda = st.isda
        for i in range(accum):
            with record_function("step/forward"):
                micro = {k: v[i * size:(i + 1) * size] if _rows(v) == rows else v
                         for k, v in mb.items()}
                outputs = self.task(micro, rng=st.step_rng(), negatives=negatives,
                                    isda_state=isda, isda_ratio=isda_ratio,
                                    momentum_feats=momentum_feats, queue=queue,
                                    pos_offset=i * size)
                loss = total_loss(outputs, flat=flat)
            with record_function("step/backward"):
                (loss / accum).backward()
            isda = outputs.get("isda_state", isda)
            for k, v in {**_metrics_from_outputs(outputs),
                         "total_loss": loss.detach()}.items():
                sums[k] = v if k not in sums else sums[k] + v
        with record_function("step/optimizer"):
            metrics = {k: v / accum for k, v in sums.items()}
            metrics["grad_norm"] = global_norm(st.optimizer.params)
            metrics["lr"] = torch.tensor(self.schedule(st.step))
            st.optimizer.step(st.step)
        with record_function("step/ema"):
            if st.ema_task is not None:
                ema_update(st.ema_task, self.task, st.ema_decay)
            if st.model_ema_task is not None:
                ema_update(st.model_ema_task, self.task, st.model_ema_decay)
            if st.img_queue is not None and momentum_feats is not None:
                st.queue_ptr = queue_update(st.img_queue, st.txt_queue, st.queue_ptr,
                                            momentum_feats["i_feat_m"],
                                            momentum_feats["t_feat_m"])
        st.isda = isda
        st.step += 1
        return metrics

    def train_steps(self, steps: int) -> list[dict[str, float]]:
        """`steps` training steps; per-step metrics as floats."""
        out = [self.step() for _ in range(steps)]
        return [{k: float(v) for k, v in m.items()} for m in out]

    # ------------------------------------------------------------ the epochs

    def train(self) -> dict:
        """The epochs from `train.start_epoch` or the auto-resumed epoch to
        `train.epochs`, each evaluated, saved and logged. Returns
        {"best_metric", "history" (one dict per epoch: its means and the
        `val_`-prefixed evaluation), "state", "times" (seconds of each
        epoch's steps, evaluation and save, of the resume's load, and the
        last checkpoint's bytes)}."""
        cfg, t = self.cfg, self.cfg["train"]
        n_params = sum(p.numel() for p in self.task.parameters())
        self.logger.info(
            f"phase={t['phase']} model={cfg['model']['name']} "
            f"params={n_params / 1e6:.1f}M device={self.device} "
            f"steps/epoch={self.steps_per_epoch}")
        times: dict[str, Any] = {"epoch_s": [], "eval_s": [], "save_s": [],
                                 "load_s": None, "checkpoint_bytes": None}
        start_epoch = int(t.get("start_epoch", 0))
        if t.get("auto_resume", True):
            t0 = time.perf_counter()
            restored = ckpt_lib.auto_load(self.exp_dir, self.state, cfg,
                                          logger=self.logger)
            if restored is not None:
                _, start_epoch = restored
                times["load_s"] = time.perf_counter() - t0
        self.exp_logger = ExperimentLogger(cfg, self.output_dir)

        best_metric = None
        minimize = cfg.get("minimize_metric") or "total_loss"
        history = []
        for epoch in range(start_epoch, int(t["epochs"])):
            t0 = time.perf_counter()
            epoch_stats = self.train_one_epoch(epoch)
            t1 = time.perf_counter()
            val_stats = self.evaluate() if len(self.val_loader) > 0 else {}
            t2 = time.perf_counter()
            times["epoch_s"].append(t1 - t0)
            times["eval_s"].append(t2 - t1)
            metric = val_stats.get(minimize, epoch_stats.get(minimize))
            is_best = best_metric is None or (metric is not None and metric < best_metric)
            if is_best and metric is not None:
                best_metric = metric
            if (epoch + 1) % int(t.get("save_freq", 1)) == 0:
                path = ckpt_lib.save(self.output_dir, self.state, cfg, epoch,
                                     is_best=is_best, scan_root=self.exp_dir,
                                     logger=self.logger)
                times["save_s"].append(time.perf_counter() - t2)
                times["checkpoint_bytes"] = os.path.getsize(
                    os.path.join(path, ckpt_lib.STATE_FILE))
            stats = {"epoch": epoch, **epoch_stats,
                     **{f"val_{k}": v for k, v in val_stats.items()}}
            history.append(stats)
            with open(os.path.join(self.output_dir, "log_stats.json"), "a") as f:
                f.write(json.dumps({k: float(v) if isinstance(v, (int, float)) else v
                                    for k, v in stats.items()}) + "\n")
        if cfg.get("wandb", {}).get("alert", False):
            self.exp_logger.alert(
                f"{t['phase']} end", f"best {minimize} {best_metric} after "
                f"{int(t['epochs'])} epochs (tag {cfg.get('tag', '')})")
        self.exp_logger.finish()
        return {"best_metric": best_metric, "history": history, "state": self.state,
                "times": times}

    def train_one_epoch(self, epoch: int) -> dict[str, float]:
        """One epoch of steps in the loader's order for `epoch`; returns the
        means of each metric over its steps. The total loss is checked
        finite every `train.print_freq` steps; `profile_steps` steps of the
        first epoch, from its fourth, are traced with torch.profiler into
        `<output_dir>/profile`."""
        cfg = self.cfg
        meter = MetricLogger(logger=self.logger)
        print_freq = int(cfg["train"].get("print_freq", 300))
        profile_steps = int(cfg.get("profile_steps", 0)) if epoch == 0 else 0
        profile_at, profiler = 3, None
        batches = meter.log_every(self.loader.epoch(epoch), print_freq,
                                  header=f"Epoch [{epoch}]")
        for i, batch in enumerate(batches):
            if profile_steps and i == profile_at:
                profiler = trace(os.path.join(self.output_dir, "profile"))
                profiler.__enter__()
            metrics = self.step(batch)
            if profiler is not None and i == profile_at + profile_steps - 1:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                profiler.__exit__(None, None, None)
                profiler = None
                self.logger.info(f"profiler trace written to {self.output_dir}/profile")
            meter.update(**metrics)
            if i % print_freq == 0:
                check_finite_and_dump(metrics, self.state.step, self.output_dir,
                                      self.logger)
            if self.exp_logger is not None and i % 50 == 0:
                names = list(metrics)
                self.exp_logger.log(head="train", step=self.state.step,
                                    **dict(zip(names, read_floats(list(metrics.values())))))
        if profiler is not None:
            profiler.__exit__(None, None, None)
        meter.synchronize_between_processes()
        return {k: m.global_avg for k, m in meter.meters.items()}

    # ------------------------------------------------------------ evaluation

    def eval_task(self):
        """The tree evaluation runs: the eval EMA's under `model_ema`, never
        the momentum encoder's; else the task's own parameters."""
        ema = self.state.model_ema_task
        return self.task if ema is None else ema

    @torch.no_grad()
    def eval_step(self, batch: dict[str, Any], generator: torch.Generator):
        """A deterministic forward of `batch` (no dropout, no ISDA, in-batch
        ITC) on `eval_task()`, as JAX's eval step: (metrics, counts, extra),
        0-d device tensors, the counts those of the `*_count` outputs,
        `extra` the VQA and NLVR2 logits where the losses give them. ITM
        draws its negatives on `generator`."""
        outputs = self.eval_task()(self.model_batch(batch), generator=generator)
        metrics = _metrics_from_outputs(outputs)
        metrics["total_loss"] = total_loss(outputs)
        counts = {k: v for k, v in outputs.items() if k.endswith("_count")
                  and isinstance(v, torch.Tensor) and v.ndim == 0}
        extra = {k: outputs[k] for k in ("vqa_logits", "nlvr2_logits") if k in outputs}
        return metrics, counts, extra

    def evaluate(self, loader: Loader | None = None) -> dict[str, float]:
        """Count-weighted means of the eval step's metrics over `loader`
        (the val split by default), on `eval_task()`: a `*_mean_acc` or
        `*_mean_score` weighs each batch by its `*_count` (and raises
        KeyError without one), every
        other metric by 1. Where a batch carries NLVR2's `table_name`s, the
        accuracy of the rows whose table is a `dev` or a `test` one, as
        `nlvr2_dev_acc` / `nlvr2_test_acc`, weighed by those rows. The
        device values are read once, at the end (the NLVR2 logits of such a
        batch when it is evaluated)."""
        loader = self.val_loader if loader is None else loader
        generator = torch.Generator(device=self.device).manual_seed(0)
        terms: list[tuple[str, torch.Tensor | float, Any]] = []
        for batch in loader.epoch(0):
            metrics, counts, extra = self.eval_step(batch, generator)
            for k, v in metrics.items():
                count_key = k.replace("_mean_acc", "_count").replace("_mean_score", "_count")
                if count_key != k and count_key not in counts:
                    raise KeyError(
                        f"eval metric '{k}' has no matching '{count_key}' in counts "
                        f"{sorted(counts)}; emit it from the objective")
                terms.append((k, v, counts.get(count_key, 1.0)))
            tables = batch.get("table_name")
            if "nlvr2_logits" in extra and isinstance(tables, list):
                preds = extra["nlvr2_logits"].argmax(-1).cpu().numpy()
                answers = np.asarray(batch["answers"])
                for bucket in ("dev", "test"):
                    sel = np.array([bucket in t for t in tables], bool)
                    if sel.any():
                        terms.append((f"nlvr2_{bucket}_acc",
                                      float((preds[sel] == answers[sel]).mean()),
                                      float(sel.sum())))
        values = read_floats([v for _, v, _ in terms] + [w for _, _, w in terms])
        sums: dict[str, float] = {}
        weights: dict[str, float] = {}
        for (k, _, _), value, weight in zip(terms, values, values[len(terms):]):
            sums[k] = sums.get(k, 0.0) + value * weight
            weights[k] = weights.get(k, 0.0) + weight
        return {k: sums[k] / max(weights[k], 1e-9) for k in sums}

    # ------------------------------------------------------- throughput mode

    def throughput(self) -> float:
        """Samples per second of the whole training step on one batch: after
        `throughput_warmup` steps, `throughput_iters` steps timed in 4
        chunks (JAX's 20 and 200 where the config leaves them out), with the
        device synchronised before each clock read; logs the mean and spread
        of the chunks and returns the mean."""
        n_warmup = int(self.cfg.get("throughput_warmup", 20))
        n_iters = int(self.cfg.get("throughput_iters", 200))
        batch = next(self.loader.epoch(0))

        def sync() -> None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        for _ in range(n_warmup):
            self.step(batch)
        sync()
        bs = self.cfg["data"]["batch_size"]
        n_chunks = 4
        per_chunk = max(n_iters // n_chunks, 1)
        chunk_sps = []
        for _ in range(n_chunks):
            t0 = time.perf_counter()
            for _ in range(per_chunk):
                self.step(batch)
            sync()
            chunk_sps.append(per_chunk * bs / (time.perf_counter() - t0))
        sps, std = float(np.mean(chunk_sps)), float(np.std(chunk_sps))
        self.logger.info(
            f"throughput: {sps:.1f} ± {std:.1f} samples/s ({bs / sps * 1000:.1f} "
            f"ms/step, batch {bs}, {n_chunks}x{per_chunk} iters)")
        return sps
