"""The train state of one single-GPU step (counterpart of
`exploremultimodal_tpu/train/state.py`): the step count, the task's
parameters, the optimizer and its moments, the random generators, the ISDA
statistics where the phase uses them, and the recipe's extra trees and
queues where the config asks for them:

  ema_task        the ITC momentum encoder (`vlmo_ema`, decay
                  `vlmo_ema_decay`)
  model_ema_task  the checkpointed eval EMA (`model_ema`, decay
                  `model_ema_decay`); `Trainer.evaluate` runs it
  img_queue / txt_queue / queue_ptr
                  the MoCo negative queues (`train.neg_queue`), (itc_dim, Q)
                  each, and the column the next write starts at

Each EMA tree is a second `VlmoTask`, a copy of the task at init with every
parameter's `requires_grad` off: the momentum forward then runs the task's
own code and kernels on the tree, and an EMA update writes the tree's
tensors in place, so their addresses (which the kernels' tensor-map caches
key on) stay put.

JAX folds one key with the step; the port keeps two generators instead: one
on the compute device for hidden dropout, DropPath, the ITM negatives and
the queues' initial draw, and one on the host that draws each step's
attention-dropout seeds.
"""

from __future__ import annotations

import copy
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
    ema_task: nn.Module | None = None
    ema_decay: float = 0.0
    model_ema_task: nn.Module | None = None
    model_ema_decay: float = 0.0
    img_queue: torch.Tensor | None = None
    txt_queue: torch.Tensor | None = None
    queue_ptr: int = 0

    def step_rng(self) -> StepRng:
        """The random streams of the next step (or microbatch)."""
        dev = next(self.task.parameters()).device
        return StepRng(self.generator, self.seed_generator, dev)


def ema_copy(task: nn.Module) -> nn.Module:
    """A frozen copy of `task`: the initial value of an EMA tree."""
    return copy.deepcopy(task).requires_grad_(False)


def create_train_state(task: nn.Module, optimizer: Optimizer, seed: int,
                       isda_classes: int = 0, isda_dim: int = 0, *,
                       ema_decay: float | None = None,
                       model_ema_decay: float | None = None,
                       queue_size: int = 0, itc_dim: int = 256) -> TrainState:
    """Step 0, with both generators seeded from `seed` (the JAX state's
    rng is key(cfg.seed + 7); the trainer passes the same number), and zero
    ISDA statistics of `isda_classes` x `isda_dim` on the device where
    `isda_classes` is set. A decay given builds its EMA tree as a copy of
    the task's current parameters; `queue_size` > 0 builds the two queues
    from standard normals on the state's generator (the image queue
    first), each column L2-normalised, and the pointer at 0."""
    dev = next(task.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(seed)
    img_q = txt_q = None
    if queue_size:
        img_q, txt_q = (torch.randn((itc_dim, queue_size), generator=generator, device=dev)
                        for _ in range(2))
        img_q, txt_q = (q / torch.linalg.vector_norm(q, dim=0, keepdim=True)
                        for q in (img_q, txt_q))
    return TrainState(
        step=0, task=task, optimizer=optimizer, generator=generator,
        seed_generator=torch.Generator().manual_seed(seed),
        isda=ISDAState.create(isda_classes, isda_dim, dev) if isda_classes else None,
        ema_task=None if ema_decay is None else ema_copy(task),
        ema_decay=0.0 if ema_decay is None else float(ema_decay),
        model_ema_task=None if model_ema_decay is None else ema_copy(task),
        model_ema_decay=0.0 if model_ema_decay is None else float(model_ema_decay),
        img_queue=img_q, txt_queue=txt_q)


@torch.no_grad()
def ema_update(ema: nn.Module, task: nn.Module, decay: float) -> None:
    """timm's ModelEmaV2 update in place, `e * decay + p * (1 - decay)` over
    every parameter of `task` (the trainable and the frozen, as JAX's over
    its whole `params` tree); buffers are copied."""
    e = list(ema.parameters())
    p = [x.detach() for x in task.parameters()]
    if len(e) != len(p):
        raise ValueError(f"EMA tree of {len(e)} tensors for a task of {len(p)}")
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, p, alpha=1.0 - decay)
    for be, bp in zip(ema.buffers(), task.buffers()):
        be.copy_(bp)


@torch.no_grad()
def queue_update(img_queue: torch.Tensor, txt_queue: torch.Tensor, ptr: int,
                 i_feat: torch.Tensor, t_feat: torch.Tensor) -> int:
    """dequeue_and_enqueue at one process: the rows of `i_feat` / `t_feat`
    (B, itc_dim) written in place as the queues' columns from `ptr` on,
    wrapping around; returns the pointer advanced by B."""
    q_size, n = img_queue.shape[1], i_feat.shape[0]
    idx = (ptr + torch.arange(n, device=img_queue.device)) % q_size
    img_queue[:, idx] = i_feat.T.to(img_queue.dtype)
    txt_queue[:, idx] = t_feat.T.to(txt_queue.dtype)
    return (ptr + n) % q_size
