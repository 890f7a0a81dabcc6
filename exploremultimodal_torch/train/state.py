"""The train state of one single-GPU step (counterpart of
`exploremultimodal_tpu/train/state.py`, without the EMA trees and queues):
the step count, the task's parameters, the optimizer and its moments, the
random generators, and the ISDA statistics where the phase uses them.

JAX folds one key with the step; the port keeps two generators instead: one
on the compute device for hidden dropout, DropPath and the ITM negatives,
and one on the host that draws each step's attention-dropout seeds.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from exploremultimodal_torch.models.heads import ISDAState
from exploremultimodal_torch.ops.stochastic import StepRng
from exploremultimodal_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    task: nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    seed_generator: torch.Generator
    isda: ISDAState | None = None

    def step_rng(self) -> StepRng:
        """The random streams of the next step."""
        dev = next(self.task.parameters()).device
        return StepRng(self.generator, self.seed_generator, dev)


def create_train_state(task: nn.Module, optimizer: Optimizer, seed: int,
                       isda_classes: int = 0, isda_dim: int = 0) -> TrainState:
    """Step 0, with both generators seeded from `seed` (the JAX state's
    rng is key(cfg.seed + 7); the trainer passes the same number), and zero
    ISDA statistics of `isda_classes` x `isda_dim` on the device where
    `isda_classes` is set."""
    dev = next(task.parameters()).device
    return TrainState(
        step=0, task=task, optimizer=optimizer,
        generator=torch.Generator(device=dev).manual_seed(seed),
        seed_generator=torch.Generator().manual_seed(seed),
        isda=ISDAState.create(isda_classes, isda_dim, dev) if isda_classes else None)
