"""The parallel presets as wrappers of the task and the optimizer
(counterpart of `exploremultimodal_tpu/parallel/partitioning.py` and of the
sharding half of JAX's `Trainer.shard_state`).

  dp            `DistributedDataParallel`: parameters and AdamW state
                replicated, gradients all-reduced (averaged) in buckets
  zero1         DDP's gradients, AdamW's moments sharded over the `fsdp`
                axis (`ZeroRedundancyOptimizer` over the port's parameter
                groups: each process updates its share and broadcasts it)
  fsdp          `fully_shard` (FSDP2) on every block and on the task:
                parameters, gradients and AdamW's moments sharded over the
                `fsdp` axis (and replicated over `data`, where both are >
                1), gathered per block for its forward and backward
  fsdp_offload  fsdp, with AdamW's moments parked in pinned host memory
                and copied to the device around each update
                (`train.optim.Optimizer`, `offload`); on a CPU device the
                state stays where it is, as JAX skips the staging there
  tp            not ported (`mesh.TP_SLICE`)

The shards differ from GSPMD's, not the arithmetic: JAX shards a tensor of
at least `MIN_SHARD_SIZE` (16,384) elements along its largest axis the
fsdp size divides and keeps smaller ones whole; FSDP2 shards every
parameter along dim 0, padding a ragged last shard, and ZeRO-1 gives each
process whole tensors. So the biases, norms, gammas, `itc_temp` and the
class and mask tokens, which JAX replicates, are split here, and the
(out, in) torch weights are split along the output where JAX splits the
larger of its (in, out) axes. Each process's rows of the batch, its losses
(`parallel.collectives`) and the update are JAX's.

The `DataAxis` of the losses spans every process (`data` x `fsdp`), as
JAX's batch shards over both axes.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from exploremultimodal_torch.parallel.mesh import DATA_AXIS, FSDP_AXIS, Mesh, Runtime


def preset_name(cfg: dict) -> str:
    """The canonical preset of the `parallel` group's flags, as JAX's
    trainer derives it (fsdp_offload shards as fsdp)."""
    par = cfg.get("parallel") or {}
    if par.get("tensor_parallel"):
        return "tp"
    if par.get("shard_params"):
        return "fsdp"
    if par.get("shard_opt_state"):
        return "zero1"
    return "dp"


def offloads(cfg: dict, device: torch.device) -> bool:
    """Whether AdamW's state parks in host memory: fsdp_offload on CUDA."""
    return bool((cfg.get("parallel") or {}).get("offload_opt_state")) \
        and device.type == "cuda"


def _fsdp_mesh(mesh: Mesh):
    """The sub-mesh FSDP2 shards over: `fsdp`, or (`data`, `fsdp`) for
    replication over `data` as well (HSDP)."""
    dm = mesh.device_mesh
    if mesh.shape[DATA_AXIS] > 1 and mesh.shape[FSDP_AXIS] > 1:
        return dm[(DATA_AXIS, FSDP_AXIS)]
    return dm[FSDP_AXIS]


def shard_fsdp(task: nn.Module, mesh: Mesh) -> nn.Module:
    """`fully_shard` every block of `task.transformer`, then the task (its
    embeddings, norms and heads as one group). Forwards must enter through
    the task's `__call__`, which gathers that group. FSDP2 takes no 0-d
    parameter: `itc_temp` stays whole on every process, outside the
    shards (`sync_whole_grads` averages its gradient)."""
    from torch.distributed.fsdp import fully_shard

    sub = _fsdp_mesh(mesh)
    for blk in task.transformer.blocks:
        fully_shard(blk, mesh=sub)
    fully_shard(task, mesh=sub, ignored_params={p for p in task.parameters() if p.ndim == 0})
    return task


def sync_whole_grads(params) -> None:
    """Under fsdp, the gradients of the parameters left whole (not DTensor)
    averaged over the processes, as FSDP2 averages the shards' (one
    all-reduce)."""
    grads = [p.grad for p in params if p.grad is not None and not hasattr(p, "device_mesh")]
    if not grads or not dist.is_initialized():
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.reshape(g.shape))


def zero_group(mesh: Mesh):
    """The processes that share AdamW's state under zero1: the `fsdp`
    axis."""
    return mesh.device_mesh[FSDP_AXIS].get_group()


def wrap_task(task: nn.Module, trees: list[nn.Module], cfg: dict, mesh: Mesh,
              runtime: Runtime) -> nn.Module:
    """Apply the preset to `task` and to its EMA `trees` (sharded as the
    task is, under fsdp); returns the module the training forward calls
    (the DDP wrapper under dp and zero1, the sharded task under fsdp, the
    task itself at one process without a group)."""
    if not runtime.distributed:
        return task
    name = preset_name(cfg)
    if name == "fsdp":
        for tree in trees:
            shard_fsdp(tree, mesh)
        return shard_fsdp(task, mesh)
    from torch.nn.parallel import DistributedDataParallel

    # the phases' frozen sets and loss subsets leave parameters without a
    # gradient (finetune_vqa's unused experts above the fusion layer)
    return DistributedDataParallel(task, find_unused_parameters=True)


def set_gradient_sync(model: nn.Module, sync: bool):
    """A context in which the backward does (or, under accumulation before
    the last microbatch, does not) reduce the gradients over the
    processes."""
    if sync:
        return contextlib.nullcontext()
    if hasattr(model, "no_sync"):  # DDP
        return model.no_sync()
    if hasattr(model, "set_requires_gradient_sync"):  # FSDP2

        @contextlib.contextmanager
        def unsynced():
            model.set_requires_gradient_sync(False)
            try:
                yield
            finally:
                model.set_requires_gradient_sync(True)
        return unsynced()
    return contextlib.nullcontext()


def local(t: torch.Tensor) -> torch.Tensor:
    """A tensor's local shard: the tensor itself unless it is a DTensor."""
    to_local = getattr(t, "to_local", None)
    return t if to_local is None else to_local()


def full(t: torch.Tensor) -> torch.Tensor:
    """A tensor whole: a DTensor gathered (every process must call)."""
    full_tensor = getattr(t, "full_tensor", None)
    return t if full_tensor is None else full_tensor()


def like(param: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """`value` (whole) on `param`'s device, sharded as `param` is where it is
    a DTensor."""
    mesh = getattr(param, "device_mesh", None)
    if mesh is None:
        return value.to(param.device)
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(value.to(local(param).device), mesh, param.placements)


def is_main() -> bool:
    """Rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def model_state_dict(module: nn.Module) -> dict[str, Any]:
    """The whole state dict of `module` on the host: gathered from its
    shards under fsdp (every process must call; only rank 0 gets the
    tensors, the others an empty dict)."""
    if any(hasattr(p, "device_mesh") for p in module.parameters()):
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            get_model_state_dict,
        )
        return get_model_state_dict(module, options=StateDictOptions(
            full_state_dict=True, cpu_offload=True))
    return module.state_dict()


def load_model_state_dict(module: nn.Module, sd: dict[str, Any], strict: bool = True):
    """Load a whole state dict into `module`, sharding it where the module
    is sharded."""
    if any(hasattr(p, "device_mesh") for p in module.parameters()):
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            set_model_state_dict,
        )
        return set_model_state_dict(module, sd, options=StateDictOptions(
            full_state_dict=True, strict=strict))
    return module.load_state_dict(sd, strict=strict)
