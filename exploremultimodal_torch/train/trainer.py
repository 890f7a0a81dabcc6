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
  step to step) -> backward -> the optimizer's step (`train.opt.name`,
  AdamW by default) with the scheduled learning
  rate -> the momentum and eval EMA updates, each at its own decay -> the
  queues take the full batch's momentum features

With `train.accumulation_steps` = A > 1 the losses and the backward run on
A microbatches of the batch, each against the full batch's momentum
features (its positives at its row offset) and its own dropout draws; the
gradients, the loss and the scalar metrics are the means over the
microbatches, and ISDA's statistics pass from one to the next. Microbatch
i is JAX's: rows [i B_g/A, (i+1) B_g/A) of the global batch of B_g rows
(its scan slices the global batch), of which process p of a data axis of
P takes rows i B_g/A + p B_g/(A P) + j; so on more than one process the
step's batch is first gathered over the data group (one all-gather, only
under accumulation).

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

On more than one process (`parallel/mesh.py`: `runtime.coordinator_address`
or torchrun) each process of the data group (the data x fsdp processes of
one tensor coordinate) takes `data.batch_size` rows of every batch (its
stride of the loader's order, by its data coordinate; tensor peers take
the same rows), the task and optimizer are wrapped by the `parallel`
preset (`parallel/partitioning.py`: DDP, ZeRO-1, FSDP2, FSDP2 with the
moments offloaded, and under tp or a tensor axis > 1 the blocks split over
the tensor group first), and the losses follow JAX's step
(`objectives/losses.py`): with `train.global_reduce` false, or where the
data axis has one process, the whole batch's losses on every process
(their backward scaled by the process count, since the presets average
the gradients); with it true on a data axis of more than one, each
process's own losses, averaged over the processes with the gradients
(JAX's `shard_map` path: refused under fsdp and with ISDA, as JAX refuses
them). The gradient norm is the global gradient's (sharded gradients add
their squares over the processes, tensor-split ones over the tensor
group), the momentum features and the queues cover every process's rows
in rank order, and the epoch's meters sum over the processes. Rank 0 alone
writes the logs, `log_stats.json` and the checkpoints.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from exploremultimodal_torch.config import VlmoConfig
from exploremultimodal_torch.data.datamodule import MultiTaskData
from exploremultimodal_torch.data.pipeline import ShardedLoader, to_device
from exploremultimodal_torch.models.dvae import create_d_vae
from exploremultimodal_torch.models.task import (
    TRAINED_OBJECTIVES,
    VlmoTask,
    resolve_device,
    total_loss,
)
from exploremultimodal_torch.ops.preprocess import preprocess_batch
from exploremultimodal_torch.parallel import DataAxis, create_mesh, initialize_runtime
from exploremultimodal_torch.parallel.collectives import concat_all_gather
from exploremultimodal_torch.parallel.partitioning import (
    is_main,
    offloads,
    preset_name,
    set_gradient_sync,
    sync_whole_grads,
    wrap_task,
    zero_group,
)
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
from exploremultimodal_torch.utils import timing
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


def _gather_rows(mb: dict, rows: int, axis: DataAxis) -> dict:
    """The batch's entries of `rows` rows gathered over the data group in
    rank order (JAX's global batch); the rest as they are."""
    out = {}
    for k, v in mb.items():
        if isinstance(v, torch.Tensor) and _rows(v) == rows:
            flag = v.dtype == torch.bool
            v = concat_all_gather(v.to(torch.uint8) if flag else v, axis.group)
            v = v.bool() if flag else v
        elif isinstance(v, list) and len(v) == rows:
            parts = [None] * axis.size
            dist.all_gather_object(parts, v, group=axis.group)
            v = [x for part in parts for x in part]
        out[k] = v
    return out


def _refuse_unported(cfg: dict) -> None:
    """Losses without a ported head raise NotImplementedError."""
    bad = sorted(set(cfg["train"]["loss_names"]) - set(TRAINED_OBJECTIVES))
    if bad:
        raise NotImplementedError(
            f"not ported yet: loss_names {bad} (the port trains "
            f"{'/'.join(TRAINED_OBJECTIVES)})")


log = logging.getLogger(__name__)


def _process_means(metrics: dict[str, torch.Tensor], axis: DataAxis) -> dict:
    """JAX's `shard_map` path: each process's metrics averaged over the
    processes, its `*_dropped_positions` counts summed (one all-reduce)."""
    names = list(metrics)
    out = torch.stack([metrics[k].float().reshape(()) for k in names])
    dist.all_reduce(out, group=axis.group)
    return {k: v if k.endswith("_dropped_positions") else v / axis.size
            for k, v in zip(names, out.unbind())}


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
    """Builds the task, the frozen tokenizer, the data (`MultiTaskData`:
    the keys of `train.datasets` found under `data.data_root`, or the
    synthetic samples, on threaded loaders; none at all raises
    FileNotFoundError) and the optimizer from `cfg` (a
    `config.load_config` dict); takes training steps and runs epochs. The run dir (`output_dir`: checkpoints, `log_stats.json`, the
    metric sink) and the experiment dir that auto-resume scans (`exp_dir`)
    resolve as in JAX's trainer. Without a `logger` it logs to stderr only;
    `main.setup` gives it one that also writes to the run dir."""

    def __init__(self, cfg: dict, device: str | torch.device = "cuda", logger=None):
        _refuse_unported(cfg)
        self.cfg = cfg
        resolve_device(device)
        # the process group (where one is configured) and this process's
        # device: cuda:<local rank> on CUDA
        self.runtime = rt = initialize_runtime(cfg, device)
        self.device = rt.device
        self.mesh = create_mesh(cfg, rt)
        self.preset = preset_name(cfg)
        self.output_dir = (cfg.get("run_dir") or cfg.get("exp_dir")
                           or cfg.get("output_dir", "output"))
        self.exp_dir = cfg.get("exp_dir") or self.output_dir
        self.logger = logger or create_logger(level=cfg.get("log_level", "info"),
                                              rank=rt.rank)
        self.exp_logger: ExperimentLogger | None = None
        self.config = c = VlmoConfig.from_config(cfg)
        # JAX's shard_map path (each process's own losses): global_reduce
        # on a data axis of more than one process
        use_gather = c.global_reduce and self.mesh.shape["data"] > 1
        if self.mesh.tensor_size > 1 and self.preset == "zero1":
            raise ValueError("a tensor axis > 1 takes parallel=tp, fsdp or dp: zero1 "
                             "hands whole moments to the fsdp group")
        if use_gather and self.preset in ("fsdp", "tp"):
            raise ValueError(
                "train.global_reduce=true needs params replicated over the data axis "
                f"(dp/zero1 presets); with parallel={self.preset} leave it false — the "
                "whole batch's losses already give global-batch ITC")
        if use_gather and c.isda_lambda:
            raise ValueError("global_reduce + ISDA are unsupported together (the "
                             "reference uses them in disjoint phases)")
        m = self.mesh
        if c.quantize == "w8a8" and m.data_size > 1 and not use_gather:
            raise NotImplementedError(
                "model.quantize=w8a8 on a data axis of more than one process: JAX's "
                "GSPMD step takes quant_dot's one activation scale over the whole global "
                "batch, which the port does not gather yet (ROADMAP A10); use "
                "w8a8_pallas (a scale per row) or train.global_reduce=true")
        self.axis = (DataAxis(m.data_group, m.data_rank, m.data_size, not use_gather)
                     if m.data_size > 1 else None)
        # FSDP2 holds the parameters: the fsdp preset, or tp over an fsdp axis
        self.fsdp = rt.distributed and (self.preset == "fsdp" or (
            self.preset == "tp" and m.shape["fsdp"] > 1))
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

        self.data = MultiTaskData(cfg, process_index=m.data_rank, process_count=m.data_size)
        if len(self.data.datasets["train"]) == 0:
            d = cfg["data"]
            raise FileNotFoundError(
                f"no training data: no key of train.datasets={list(t['datasets'])} has "
                f"its files under data.data_root={d.get('data_root')!r} (arrow tables, or "
                "a save_to_disk corpus for book / wiki); 'train.datasets=[synthetic]' "
                "trains on synthetic samples")
        self.loader = self.data.train_loader()
        self.val_loader = self.data.val_loader()
        self.steps_per_epoch = max(len(self.loader), 1)
        frozen = phase_frozen_predicate(tuple(t["loss_names"]), t.get("phase"),
                                        t.get("mim_head_pos", "img"))
        for name, p in self.task.named_parameters():
            if frozen is not None and frozen(flax_path(name)):
                p.requires_grad_(False)
        self.accum = int(t.get("accumulation_steps", 1))
        if self.accum < 1:
            raise ValueError(f"train.accumulation_steps={self.accum}")
        # two independent EMA trees, as in JAX: the ITC momentum encoder
        # (vlmo_ema) and the checkpointed eval EMA (model_ema); the queues
        # are built under neg_queue whether or not the momentum branch runs
        self.state: TrainState = create_train_state(
            self.task, None, int(cfg["seed"]) + 7,
            isda_classes=c.vqa_label_size if c.isda_lambda > 0 else 0,
            isda_dim=2 * c.embed_dim,
            ema_decay=cfg.get("vlmo_ema_decay", 0.995) if cfg.get("vlmo_ema") else None,
            model_ema_decay=(cfg.get("model_ema_decay", 0.9999) if cfg.get("model_ema")
                             else None),
            queue_size=int(t.get("queue_size", 0)) if t.get("neg_queue") else 0,
            itc_dim=c.itc_dim, rank=m.data_rank, world=m.data_size)
        # the preset: `model` is what the training forward calls (DDP's
        # wrapper, or the task sharded with its EMA trees); the optimizer
        # takes the parameters as the preset left them
        st = self.state
        self.model = wrap_task(self.task, [tree for tree in (st.ema_task, st.model_ema_task)
                                           if tree is not None], cfg, self.mesh, rt)
        trainable = {n: p for n, p in self.task.named_parameters() if p.requires_grad}
        st.optimizer, self.schedule = create_optimizer(
            cfg, trainable, self.steps_per_epoch,
            zero_group=(zero_group(self.mesh) if rt.distributed and self.preset == "zero1"
                        else None),
            offload=offloads(cfg, self.device))
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
            feats = st.ema_task(mb, method="itc_momentum_feats")
            if self.axis is not None:
                # every process's rows, in rank order (JAX's global batch)
                feats = {k: concat_all_gather(v, self.axis.group) for k, v in feats.items()}
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
        axis = self.axis
        # the whole batch's loss is each process's: the presets average the
        # processes' gradients, so its backward is scaled by their count
        scale = axis.size if axis is not None and axis.global_batch else 1
        # the momentum features cover every process's rows in rank order
        first = (axis.rank * rows if axis is not None and axis.global_batch
                 and momentum_feats is not None else 0)
        # JAX's microbatches: global rows [i B_g/A, (i+1) B_g/A), this
        # process's share of each at rank * size in it
        gathered = accum > 1 and axis is not None
        if gathered:
            mb = _gather_rows(mb, rows, axis)
        for i in range(accum):
            lo = (i * axis.size + axis.rank) * size if gathered else i * size
            with set_gradient_sync(self.model, i == accum - 1):
                with record_function("step/forward"):
                    micro = {k: v[lo:lo + size] if _rows(v) == rows * (
                        axis.size if gathered else 1) else v for k, v in mb.items()}
                    outputs = self.model(micro, rng=st.step_rng(), negatives=negatives,
                                         isda_state=isda, isda_ratio=isda_ratio,
                                         momentum_feats=momentum_feats, queue=queue,
                                         pos_offset=lo if gathered else first + i * size,
                                         axis=axis)
                    loss = total_loss(outputs, flat=flat)
                with record_function("step/backward"):
                    (loss * scale / accum).backward()
            isda = outputs.get("isda_state", isda)
            for k, v in {**_metrics_from_outputs(outputs),
                         "total_loss": loss.detach()}.items():
                sums[k] = v if k not in sums else sums[k] + v
        with record_function("step/optimizer"):
            if self.fsdp:
                sync_whole_grads(st.optimizer.params,
                                 None if axis is None else axis.group)
            metrics = {k: v / accum for k, v in sums.items()}
            if axis is not None and not axis.global_batch:
                metrics = _process_means(metrics, axis)
            metrics["grad_norm"] = global_norm(st.optimizer.params)
            metrics["lr"] = torch.tensor(self.schedule(st.step))
            st.optimizer.step(st.step)
        with record_function("step/ema"):
            if st.ema_task is not None:
                ema_update(st.ema_task, self.task, st.ema_decay)
            if st.model_ema_task is not None:
                ema_update(st.model_ema_task, self.task, st.model_ema_decay)
            if st.img_queue is not None and momentum_feats is not None:
                # already every process's rows (`momentum_branch`)
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
        self.exp_logger = ExperimentLogger(cfg, self.output_dir, enable=is_main())

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
                if is_main():
                    times["checkpoint_bytes"] = os.path.getsize(
                        os.path.join(path, ckpt_lib.STATE_FILE))
            stats = {"epoch": epoch, **epoch_stats,
                     **{f"val_{k}": v for k, v in val_stats.items()}}
            history.append(stats)
            if is_main():
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
        draws its negatives on `generator`. On more than one process, the
        whole batch's metrics (the step's `DataAxis`)."""
        outputs = self.eval_task()(self.model_batch(batch), generator=generator,
                                   axis=self.axis)
        metrics = _metrics_from_outputs(outputs)
        metrics["total_loss"] = total_loss(outputs)
        counts = {k: v for k, v in outputs.items() if k.endswith("_count")
                  and isinstance(v, torch.Tensor) and v.ndim == 0}
        extra = {k: outputs[k] for k in ("vqa_logits", "nlvr2_logits") if k in outputs}
        return metrics, counts, extra

    def evaluate(self, loader: ShardedLoader | None = None) -> dict[str, float]:
        """Count-weighted means of the eval step's metrics over `loader`
        (the val split by default), on `eval_task()`: a `*_mean_acc` or
        `*_mean_score` weighs each batch by its `*_count` (and raises
        KeyError without one), every
        other metric by 1. Where a batch carries NLVR2's `table_name`s, the
        accuracy of the rows whose table is a `dev` or a `test` one, as
        `nlvr2_dev_acc` / `nlvr2_test_acc`, weighed by those rows (every
        process's, summed over the processes). The device values are read
        once, at the end (the NLVR2 logits of such a batch when it is
        evaluated). On more than one process each evaluates its stride of
        the split."""
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
        if self.axis is not None:
            # the NLVR2 buckets hold this process's rows alone
            buckets = ("nlvr2_dev_acc", "nlvr2_test_acc")
            both = torch.tensor([sums.get(k, 0.0) for k in buckets]
                                + [weights.get(k, 0.0) for k in buckets],
                                dtype=torch.float64, device=self.device)
            dist.all_reduce(both, group=self.axis.group)
            for j, k in enumerate(buckets):
                sums.pop(k, None), weights.pop(k, None)
                if both[2 + j] > 0:
                    sums[k], weights[k] = float(both[j]), float(both[2 + j])
        return {k: sums[k] / max(weights[k], 1e-9) for k in sums}

    # ------------------------------------------------------- throughput mode

    def throughput(self) -> float:
        """Samples per second of the whole training step on one batch (every
        process's rows): after `throughput_warmup` steps, `throughput_iters`
        steps timed in 4 chunks (JAX's 20 and 200 where the config leaves
        them out), each fenced by `utils.timing` (a host read of the step's
        loss); logs the mean and spread of the chunks and returns the
        mean."""
        n_warmup = int(self.cfg.get("throughput_warmup", 20))
        n_iters = int(self.cfg.get("throughput_iters", 200))
        batch = next(self.loader.epoch(0))

        def step():
            return self.step(batch)

        timing.timeit(step, n_warmup, 0)
        bs = self.cfg["data"]["batch_size"] * self.mesh.data_size
        n_chunks = 4
        per_chunk = max(n_iters // n_chunks, 1)
        chunk_sps = [bs / timing.timeit(step, 0, per_chunk) for _ in range(n_chunks)]
        sps, std = float(np.mean(chunk_sps)), float(np.std(chunk_sps))
        self.logger.info(
            f"throughput: {sps:.1f} ± {std:.1f} samples/s ({bs / sps * 1000:.1f} "
            f"ms/step, batch {bs}, {n_chunks}x{per_chunk} iters)")
        return sps
