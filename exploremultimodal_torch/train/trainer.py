"""The pretrain_mum and finetune_vqa training steps on one GPU.

Counterpart of `exploremultimodal_tpu/train/trainer.py` for
`accumulation_steps=1` without the momentum encoder, the negative queue or
the gathered ITC (none of them is a default of either phase):

  uint8 batch -> device (pinned memory) -> preprocessing -> frozen dVAE
  tokens under no_grad (MIM labels, where MIM is trained; the dVAE's trunk
  on int8 codes under `train.discrete_vae_quantize`) -> the phase's
  losses (VQA with the ISDA statistics carried from step to step) ->
  backward -> AdamW step with the scheduled learning rate

The four phases of a step are `torch.profiler` ranges (`step/batch`,
`step/forward`, `step/backward`, `step/optimizer`), which cost nothing
without a profiler; `scripts/torch_profile_train.py` reads them.

Parameters and optimizer state are fp32; activations run in
`compute_dtype`, as in the JAX trainer. The entry point runs on CUDA unless
the caller passes device="cpu".
"""

from __future__ import annotations

import logging
import os
from typing import Any, Iterator

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
from exploremultimodal_torch.train.state import TrainState, create_train_state

METRIC_KEYS = ("_task_loss", "_Loss", "_mean_acc", "_mean_score", "itc_temp",
               "_dropped_positions")


def _metrics_from_outputs(outputs: dict) -> dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in outputs.items()
            if k.endswith(METRIC_KEYS)
            and isinstance(v, torch.Tensor) and v.ndim == 0}


def _refuse_unported(cfg: dict) -> None:
    t = cfg["train"]
    names = set(t["loss_names"])
    unported = {
        "loss_names beyond mlm/itc/itm/mim/vqa": not names <= set(TRAINED_OBJECTIVES),
        "vlmo_ema (momentum ITC)": bool(cfg.get("vlmo_ema")),
        "model_ema": bool(cfg.get("model_ema")),
        "neg_queue": bool(t.get("neg_queue")),
        "global_reduce": bool(t.get("global_reduce")),
        "accumulation_steps > 1": int(t.get("accumulation_steps", 1)) != 1,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


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
    from `cfg` (a `config.load_config` dict) and takes training steps."""

    def __init__(self, cfg: dict, device: str | torch.device = "cuda"):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
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
                quantize=t.get("discrete_vae_quantize") or "none", device=self.device)

        self.loader = Loader(build_dataset(cfg), cfg["data"]["batch_size"],
                             seed=int(cfg["seed"]))
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
        self.state: TrainState = create_train_state(
            self.task, optimizer, int(cfg["seed"]) + 7,
            isda_classes=c.vqa_label_size if c.isda_lambda > 0 else 0,
            isda_dim=2 * c.embed_dim)
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

    def step(self, batch: dict[str, Any] | None = None, *, negatives=None,
             mim_labels: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """One training step on `batch` (default: the next of the loader).
        Returns the step's metrics as 0-d device tensors; nothing here waits
        for the device. The gradients stay on the parameters until the next
        step. `negatives` and `mim_labels` replace the sampled ITM negatives
        and the dVAE labels (for comparisons across devices)."""
        st = self.state
        # ISDA's strength ramps with the epoch, as in the JAX trainer
        epoch = st.step // self.steps_per_epoch
        isda_ratio = (self.config.isda_lambda * epoch
                      / max(int(self.cfg["train"]["epochs"]), 1))
        with record_function("step/batch"):
            mb = self.model_batch(self.next_batch() if batch is None else batch,
                                  mim_labels)
        with record_function("step/forward"):
            st.optimizer.zero_grad()
            outputs = self.task(mb, rng=st.step_rng(), negatives=negatives,
                                isda_state=st.isda, isda_ratio=isda_ratio)
            loss = total_loss(outputs, flat=bool(self.cfg["train"].get("flat_loss")))
        with record_function("step/backward"):
            loss.backward()
        with record_function("step/optimizer"):
            metrics = _metrics_from_outputs(outputs)
            metrics["total_loss"] = loss.detach()
            metrics["grad_norm"] = global_norm(st.optimizer.params)
            metrics["lr"] = torch.tensor(self.schedule(st.step))
            st.optimizer.step(st.step)
        st.isda = outputs.get("isda_state", st.isda)
        st.step += 1
        return metrics

    def train(self, steps: int) -> list[dict[str, float]]:
        """`steps` training steps; per-step metrics as floats."""
        out = [self.step() for _ in range(steps)]
        return [{k: float(v) for k, v in m.items()} for m in out]
