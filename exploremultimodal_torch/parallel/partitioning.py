"""The parallel presets as wrappers of the task and the optimizer
(counterpart of `exploremultimodal_tpu/parallel/partitioning.py` and of the
sharding half of JAX's `Trainer.shard_state`).

  dp            `DistributedDataParallel`: parameters and optimizer state
                replicated, gradients all-reduced (averaged) in buckets
  zero1         DDP's gradients, the optimizer's state sharded over the `fsdp`
                axis (`ZeroRedundancyOptimizer` over the port's parameter
                groups: each process updates its share and broadcasts it)
  fsdp          `fully_shard` (FSDP2) on every block and on the task:
                parameters, gradients and the optimizer's state sharded over the
                `fsdp` axis (and replicated over `data`, where both are >
                1), gathered per block for its forward and backward
  fsdp_offload  fsdp, with the optimizer's state parked in pinned host memory
                and copied to the device around each update
                (`train.optim.Optimizer`, `offload`); on a CPU device the
                state stays where it is, as JAX skips the staging there
  tp            Megatron's split of every block over the `tensor` axis
                (`shard_tensor_parallel`): each rank holds H/T heads of
                qkv (and of q_bias, v_bias) with their input columns of
                proj, and hidden/T rows of every expert's fc1 (and b1) with
                their columns of fc2; everything else whole on the tensor
                axis. Then, as the preset's `shard_params` asks, FSDP2 over
                the `fsdp` sub-mesh where that axis is > 1 (the moments
                sharded with the parameters), else DDP over the data group

The shards differ from GSPMD's, not the arithmetic: JAX shards a tensor of
at least `MIN_SHARD_SIZE` (16,384) elements along its largest axis the
fsdp size divides and keeps smaller ones whole; FSDP2 shards every
parameter along dim 0, padding a ragged last shard, and ZeRO-1 gives each
process whole tensors. So the biases, norms, gammas, `itc_temp` and the
class and mask tokens, which JAX replicates, are split here, and the
(out, in) torch weights are split along the output where JAX splits the
larger of its (in, out) axes. Each process's rows of the batch, its losses
(`parallel.collectives`) and the update are JAX's.

The `DataAxis` of the losses spans every process of the data group
(`data` x `fsdp`), as JAX's batch shards over both axes.

The tensor split differs from GSPMD's, not the arithmetic: JAX gives the
(768, 2304) qkv kernel a contiguous column split (at T = 2, rank 0 all of q
and half of k) and GSPMD reshards it before the attention; the port splits
q, k and v each by head, so a rank's rows of the torch (2304, 768) weight
are [q_t | k_t | v_t] and its heads need no resharding. Any tensor axis > 1
splits the blocks this way (under dp and fsdp too, where JAX would
replicate over that axis: the same step, its work shared).
"""

from __future__ import annotations

import contextlib
import re
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from exploremultimodal_torch.parallel.collectives import TensorAxis
from exploremultimodal_torch.parallel.mesh import DATA_AXIS, FSDP_AXIS, Mesh, Runtime

# the tensor-sharded parameters, by torch name, and how each splits: "qkv"
# (q, k and v each by rows), "rows" (dim 0), "cols" (dim 1)
_TENSOR_SPLITS = (
    (re.compile(r"transformer\.blocks\.\d+\.attn\.qkv\.weight"), "qkv"),
    (re.compile(r"transformer\.blocks\.\d+\.attn\.[qv]_bias"), "rows"),
    (re.compile(r"transformer\.blocks\.\d+\.attn\.proj\.weight"), "cols"),
    (re.compile(r"transformer\.blocks\.\d+\.mlp_(v|l|vl)\.fc1\.(weight|bias)"), "rows"),
    (re.compile(r"transformer\.blocks\.\d+\.mlp_(v|l|vl)\.fc2\.weight"), "cols"),
)


def tensor_split(name: str) -> str | None:
    """How the parameter `name` (a task's torch name) splits over the
    tensor axis: "qkv", "rows", "cols", or None (whole on every rank)."""
    for pattern, how in _TENSOR_SPLITS:
        if pattern.fullmatch(name):
            return how
    return None


def shard_tensor(value: torch.Tensor, how: str, t: int, size: int) -> torch.Tensor:
    """Rank t's share of the whole `value` split `how` over `size` ranks."""
    if how == "qkv":
        return torch.cat([part.chunk(size, 0)[t] for part in value.chunk(3, 0)])
    return value.chunk(size, 0 if how == "rows" else 1)[t]


def gather_tensor(parts: list[torch.Tensor], how: str) -> torch.Tensor:
    """The whole tensor of the ranks' shares `parts` (in rank order)."""
    if how == "qkv":
        return torch.cat([torch.cat([p.chunk(3, 0)[j] for p in parts]) for j in range(3)])
    return torch.cat(parts, 0 if how == "rows" else 1)


def tensor_shard(state_dict: dict[str, Any], t: int, size: int) -> dict[str, Any]:
    """Rank t's state dict of a whole one, the tensor axis of `size`."""
    return {k: v if tensor_split(k) is None else shard_tensor(v, tensor_split(k), t, size)
            for k, v in state_dict.items()}


def tensor_gather(shards: list[dict[str, Any]]) -> dict[str, Any]:
    """The whole state dict of the ranks' (`tensor_shard`'s inverse)."""
    return {k: v if tensor_split(k) is None else gather_tensor([s[k] for s in shards],
                                                               tensor_split(k))
            for k, v in shards[0].items()}


def shard_tensor_parallel(task: nn.Module, axis: TensorAxis) -> nn.Module:
    """Split `task`'s blocks over the tensor axis in place: each split
    parameter replaced by this rank's share (its `requires_grad` kept), and
    each block's attention and FFN experts given `axis`. The task keeps
    `axis` as `tensor_axis`, which the whole state dicts read."""
    for name, p in list(task.named_parameters()):
        how = tensor_split(name)
        if how is None:
            continue
        owner, attr = task.get_submodule(name.rpartition(".")[0]), name.rpartition(".")[2]
        setattr(owner, attr, nn.Parameter(shard_tensor(p.detach(), how, axis.rank, axis.size)
                                          .clone(), requires_grad=p.requires_grad))
    for blk in task.transformer.blocks:
        blk.attn.tensor = axis
        for route in blk.experts:
            getattr(blk, f"mlp_{route}").tensor = axis
    task.tensor_axis = axis
    return task


def mark_tensor_sharded(task: nn.Module) -> None:
    """Tag each tensor-sharded parameter of `task` (after any wrapper has
    replaced them) with its `tensor_split` and the task's `tensor_axis`,
    which the gradient norm and the optimizer's whole state read."""
    axis = getattr(task, "tensor_axis", None)
    for name, p in task.named_parameters():
        how = tensor_split(name)
        if axis is not None and how is not None:
            p.tensor_split, p.tensor_axis = how, axis


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
    """Whether the optimizer's state parks in host memory: fsdp_offload on
    CUDA."""
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


def sync_whole_grads(params, group: Any = None) -> None:
    """Under fsdp, the gradients of the parameters left whole (not DTensor)
    averaged over the data group (every process by default), as FSDP2
    averages the shards' (one all-reduce)."""
    grads = [p.grad for p in params if p.grad is not None and not hasattr(p, "device_mesh")]
    if not grads or not dist.is_initialized():
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.reshape(g.shape))


def zero_group(mesh: Mesh):
    """The processes that share the optimizer's state under zero1: the `fsdp`
    axis."""
    return mesh.device_mesh[FSDP_AXIS].get_group()


def wrap_task(task: nn.Module, trees: list[nn.Module], cfg: dict, mesh: Mesh,
              runtime: Runtime) -> nn.Module:
    """Apply the preset to `task` and to its EMA `trees` (split over the
    tensor axis where it is > 1, and sharded as the task is under fsdp);
    returns the module the training forward calls (the DDP wrapper under
    dp and zero1, and under tp where the fsdp axis is 1 and the data group
    more than one process; the sharded task under fsdp, and under tp where
    the fsdp axis is > 1; else the task itself)."""
    if not runtime.distributed:
        return task
    if mesh.tensor_size > 1:
        axis = TensorAxis(mesh.tensor_group, mesh.tensor_rank, mesh.tensor_size)
        for module in (task, *trees):
            shard_tensor_parallel(module, axis)
    name = preset_name(cfg)
    if name == "fsdp" or (name == "tp" and mesh.shape[FSDP_AXIS] > 1):
        for tree in trees:
            shard_fsdp(tree, mesh)
        model = shard_fsdp(task, mesh)
    elif mesh.data_size == 1:
        model = task
    else:
        from torch.nn.parallel import DistributedDataParallel

        # the phases' frozen sets and loss subsets leave parameters without
        # a gradient (finetune_vqa's unused experts above the fusion layer)
        group = {} if mesh.tensor_size == 1 else {"process_group": mesh.data_group}
        model = DistributedDataParallel(task, find_unused_parameters=True, **group)
    mark_tensor_sharded(task)
    return model


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


def _tensor_gather_local(sd: dict[str, Any], axis: TensorAxis) -> dict[str, Any]:
    """The whole state dict of this rank's `sd` over the tensor group (one
    all-gather a split tensor), on the host."""
    out = {}
    for k, v in sd.items():
        how = tensor_split(k)
        if how is not None:
            v = v.contiguous()
            parts = [torch.empty_like(v) for _ in range(axis.size)]
            dist.all_gather(parts, v, group=axis.group)
            v = gather_tensor(parts, how)
        out[k] = v.cpu() if isinstance(v, torch.Tensor) else v
    return out


def model_state_dict(module: nn.Module) -> dict[str, Any]:
    """The whole state dict of `module` on the host: gathered from its
    shards under fsdp (only rank 0 gets the tensors, the others an empty
    dict), and over the tensor axis, after the fsdp gather, where the
    blocks are split (every rank then gets them). Every process must
    call."""
    axis = getattr(module, "tensor_axis", None)
    if any(hasattr(p, "device_mesh") for p in module.parameters()):
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            get_model_state_dict,
        )
        # with a tensor axis every rank takes its whole fsdp gather, on the
        # device, for the tensor gather after it
        sd = get_model_state_dict(module, options=StateDictOptions(
            full_state_dict=True, cpu_offload=axis is None))
    else:
        sd = module.state_dict()
    return sd if axis is None else _tensor_gather_local(sd, axis)


def load_model_state_dict(module: nn.Module, sd: dict[str, Any], strict: bool = True):
    """Load a whole state dict into `module`, sharding it where the module
    is sharded (this rank's share over the tensor axis, then its fsdp
    shards)."""
    axis = getattr(module, "tensor_axis", None)
    if axis is not None:
        sd = tensor_shard(sd, axis.rank, axis.size)
    if any(hasattr(p, "device_mesh") for p in module.parameters()):
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            set_model_state_dict,
        )
        return set_model_state_dict(module, sd, options=StateDictOptions(
            full_state_dict=True, strict=strict))
    return module.load_state_dict(sd, strict=strict)
