"""The process group and the device mesh (counterpart of
`exploremultimodal_tpu/parallel/mesh.py`).

JAX runs one controller per host over a mesh of named axes; the port runs
one process per GPU, as the reference's torchrun does, and names the same
axes over the processes:

  data    batch parallelism (each process its own rows of the batch)
  fsdp    parameter and optimizer-state sharding, also over the batch
  tensor  tensor parallelism (the Megatron split of each block's qkv, proj,
          fc1 and fc2: `partitioning.shard_tensor_parallel`)

The tensor axis is innermost, as in JAX's axis order, so a tensor group is
consecutive ranks: rank r has data coordinate r // T (its place among the
data x fsdp processes that split the batch) and tensor coordinate r % T.

`initialize_runtime` starts the group: from `runtime.coordinator_address`
/ `num_processes` / `process_id` (JAX's keys), or from torchrun's `RANK` /
`WORLD_SIZE` / `LOCAL_RANK` / `MASTER_ADDR`; with neither it starts none,
as JAX starts no distributed runtime. NCCL on CUDA, gloo on the CPU.

JAX seeds each process's host generators with seed + process index, and a
JAX tensor group on one host is one process; the port seeds them with seed
+ data coordinate, so that tensor peers draw the same host masks (the MLM
collator) and take the same rows.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import random
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
MESH_AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """This process's place: its rank of `world` processes, its device, and
    whether a process group runs (False at one process without one)."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    distributed: bool = False


def _group_spec(cfg: dict) -> tuple[str, int, int, int] | None:
    """(init_method, world, rank, local rank) of the group the config or
    torchrun's environment names, or None."""
    rt = cfg.get("runtime") or {}
    if rt.get("coordinator_address"):
        addr = str(rt["coordinator_address"])
        if "://" not in addr:
            addr = f"tcp://{addr}"
        world, rank = int(rt.get("num_processes") or 1), int(rt.get("process_id") or 0)
        local = int(os.environ.get("LOCAL_RANK", rank))
        return addr, world, rank, local
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        return ("env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                int(os.environ.get("LOCAL_RANK", 0)))
    return None


def initialize_runtime(cfg: dict, device: str | torch.device = "cuda") -> Runtime:
    """Start (once) the process group `cfg` or torchrun names, and seed
    Python's and numpy's generators with `seed + data coordinate` (every
    call, as JAX's does with its process index: the host data path draws on
    them). On CUDA the process takes `cuda:<local rank>` and NCCL; on the
    CPU gloo. Returns the process's `Runtime`."""
    dev = torch.device(device)
    spec = _group_spec(cfg)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        local = spec[3] if spec is not None else rank
    elif spec is not None:
        init_method, world, rank, local = spec
        if dev.type == "cuda":
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method, world_size=world, rank=rank)
    else:
        rank, world, local = 0, 1, 0
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", local % torch.cuda.device_count())
    seed = int(cfg.get("seed", 0)) + rank // mesh_shape(cfg, world=world)[TENSOR_AXIS]
    random.seed(seed)
    np.random.seed(seed % 2**32)
    return Runtime(rank, world, local, dev, dist.is_initialized())


def _reconcile_with_preset(cfg: dict, data: int, fsdp: int, tensor: int):
    """A sharding preset takes the whole mesh: where it shards parameters
    or optimizer state (or wants tensor parallelism) and the matching axis
    was left at 1 while `data` absorbs the rest, that axis takes every
    process instead; an axis pinned at 1 by hand draws a warning (JAX's
    rule)."""
    par = cfg.get("parallel") or {}
    wants_fsdp = bool(par.get("shard_params") or par.get("shard_opt_state"))
    if par.get("tensor_parallel") and tensor == 1:
        if data == -1 and fsdp == 1:
            tensor, data = -1, 1
        else:
            log.warning("parallel preset requests tensor parallelism but "
                        "runtime.mesh.tensor=1 — nothing will be tensor-sharded")
    elif wants_fsdp and fsdp == 1:
        if data == -1:
            fsdp, data = -1, 1
        else:
            log.warning("parallel preset requests param/opt-state sharding but "
                        "runtime.mesh.fsdp=1 — nothing will be sharded")
    return data, fsdp, tensor


def mesh_shape(cfg: dict | None = None, *, world: int, data: int = -1, fsdp: int = 1,
               tensor: int = 1) -> dict[str, int]:
    """The axis sizes over `world` processes: from `runtime.mesh` and the
    preset where a config is given, one axis of -1 absorbing what the
    others leave. ValueError where they cannot cover the world."""
    if cfg is not None:
        m = (cfg.get("runtime") or {}).get("mesh") or {}
        data, fsdp, tensor = _reconcile_with_preset(
            cfg, m.get(DATA_AXIS, data), m.get(FSDP_AXIS, fsdp), m.get(TENSOR_AXIS, tensor))
    sizes = {DATA_AXIS: data, FSDP_AXIS: fsdp, TENSOR_AXIS: tensor}
    fixed = math.prod(s for s in sizes.values() if s != -1)
    free = [a for a, s in sizes.items() if s == -1]
    if len(free) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {sizes}")
    if free:
        if world % fixed:
            raise ValueError(f"{world} processes not divisible by fixed axes {sizes}")
        sizes[free[0]] = world // fixed
    if math.prod(sizes.values()) != world:
        raise ValueError(f"mesh {sizes} does not cover {world} processes")
    return sizes


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, fsdp, tensor) axis sizes and, where a process group runs,
    the `DeviceMesh` over it (None at one process without a group), with
    this process's two groups: `data_group`, the data x fsdp processes of
    its tensor coordinate that split the batch (the whole group at a tensor
    axis of 1), and `tensor_group`, the processes of its data coordinate
    that split each block (None at a tensor axis of 1); `data_rank` and
    `tensor_rank` are its coordinates in them."""

    shape: dict
    device_mesh: Any = None
    data_group: Any = None
    tensor_group: Any = None
    data_rank: int = 0
    tensor_rank: int = 0

    @property
    def data_size(self) -> int:
        """The processes that split the batch: data x fsdp."""
        return self.shape[DATA_AXIS] * self.shape[FSDP_AXIS]

    @property
    def tensor_size(self) -> int:
        return self.shape[TENSOR_AXIS]


def _data_groups(world: int, tensor: int, rank: int):
    """The data group of `rank`: the processes of its tensor coordinate.
    Every process makes every group, in the same order, as `new_group`
    asks."""
    mine = None
    for t in range(tensor):
        group = dist.new_group(list(range(t, world, tensor)))
        if rank % tensor == t:
            mine = group
    return mine


def create_mesh(cfg: dict, runtime: Runtime) -> Mesh:
    """The mesh of `cfg`'s `runtime.mesh` and preset over the runtime's
    processes, the tensor axis innermost, and this process's data and
    tensor groups."""
    shape = mesh_shape(cfg, world=runtime.world)
    if not runtime.distributed:
        return Mesh(shape)
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(runtime.device.type, tuple(shape[a] for a in MESH_AXES),
                                   mesh_dim_names=MESH_AXES)
    tensor = shape[TENSOR_AXIS]
    if tensor == 1:
        return Mesh(shape, device_mesh, dist.group.WORLD, None, runtime.rank, 0)
    return Mesh(shape, device_mesh, _data_groups(runtime.world, tensor, runtime.rank),
                device_mesh.get_group(TENSOR_AXIS), runtime.rank // tensor,
                runtime.rank % tensor)
