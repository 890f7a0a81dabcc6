"""Cross-process collectives for the objectives (counterpart of
`exploremultimodal_tpu/parallel/collectives.py`, the reference's
`GatherLayer`, `torch.roll` and `concat_all_gather`).

  all_gather_with_grad  forward: every process's rows in rank order
                        (`all_gather_into_tensor`); backward: the gathered
                        gradient summed over the processes, this process's
                        rows taken; then, optionally, the roll that puts
                        this process's rows first
  concat_all_gather     the same gather without a gradient (the queues)
  global_sum            a sum over the processes whose backward hands each
                        process the gradient of its own term

and the two ends of a tensor-parallel region (Megatron's f and g), over
the tensor group:

  copy_to_tensor_region     identity forward, all-reduce backward: before
                            the column-parallel qkv and fc1, whose input
                            gradient is each rank's share
  reduce_from_tensor_region all-reduce forward, identity backward: after
                            the row-parallel proj and fc2, whose output is
                            each rank's partial sum

Both add in fp32 and round once to the input's dtype.

With no group (one process) each is the identity, as JAX's are with
`axis_name=None`.

`DataAxis` is what the objectives get from the trainer: the data group
(the processes that split the batch, `mesh.Mesh.data_group`), the rank,
the size, and which of JAX's two steps the losses follow. With
`global_batch` (`train.global_reduce: false`) they are JAX's GSPMD step
over the global batch: ITC against the gathered features, ITM's
negatives from the whole batch, every loss and metric a mean over the
whole batch (count-weighted ones from summed numerators and counts), the
same value on every process. Without it (`train.global_reduce: true`) they
are JAX's `shard_map` step: each process's own losses, ITC against the
gathered features with its rows first; the trainer then averages losses
and gradients over the processes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        start = dist.get_rank(ctx.group) * ctx.rows
        return g[start:start + ctx.rows], None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_reduce_fp32(x: torch.Tensor, group) -> torch.Tensor:
    out = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.dtype)


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_fp32(g, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor_region(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """`x` itself; its gradient summed over the tensor group (the ranks'
    shares of the input gradient). The identity with no group."""
    return x if group is None else _CopyToRegion.apply(x, group)


def reduce_from_tensor_region(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """The sum of `x` over the tensor group (the ranks' partial outputs);
    its gradient passes through. The identity with no group."""
    return x if group is None else _ReduceFromRegion.apply(x, group)


def all_gather_with_grad(x: torch.Tensor, group: Any = None,
                         roll_local_first: bool = True) -> torch.Tensor:
    """Every process's `x` stacked along dim 0 in rank order, with the
    gradient of the gathered rows summed back to their process; with
    `roll_local_first` rolled so this process's rows come first."""
    if group is None:
        return x
    out = _Gather.apply(x, group)
    if roll_local_first:
        out = torch.roll(out, -x.shape[0] * dist.get_rank(group), dims=0)
    return out


@torch.no_grad()
def concat_all_gather(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Every process's `x` stacked along dim 0 in rank order, no gradient."""
    if group is None:
        return x.detach()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.detach().contiguous(), group=group)
    return out


def global_sum(x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """The sum of `x` over the processes (the same value on each); its
    gradient reaches each process's own `x` alone, so the processes'
    gradients add up to the gradient of the sum."""
    return x if group is None else _Sum.apply(x, group)


@dataclasses.dataclass(frozen=True)
class TensorAxis:
    """The processes a block's heads and hidden are split over: `group`,
    this process's `rank` (its tensor coordinate t) of `size` (T)."""

    group: Any
    rank: int
    size: int

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_tensor_region(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from_tensor_region(x, self.group)

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        """`x` replaced in place by its elementwise max over the tensor
        group (the int8 sites' scales over a split K or hidden)."""
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """The processes a step's batch is split over: `group`, this process's
    `rank` of `size`, and `global_batch` (the losses of JAX's step over the
    whole batch, or each process's own: see the module's docstring)."""

    group: Any
    rank: int
    size: int
    global_batch: bool = True

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return global_sum(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's rows in rank order, with the gradient."""
        return all_gather_with_grad(x, self.group, roll_local_first=False)

    def gather_const(self, x: torch.Tensor) -> torch.Tensor:
        return concat_all_gather(x, self.group)

    def mean(self, *values: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The global means of per-process means over equally many rows:
        their sum over the processes over the size (one all-reduce)."""
        out = self.sum(torch.stack([v.to(torch.float32) for v in values])) / self.size
        return tuple(out.unbind())
