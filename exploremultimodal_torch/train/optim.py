"""AdamW with the JAX package's parameter groups and per-step schedules.

Counterpart of `exploremultimodal_tpu/train/optim.py` for the adamw family:
`build_schedule`, `build_wd_schedule`, `lr_multipliers`, `no_decay_mask`,
`phase_frozen_predicate` and `create_optimizer`, with the optional global
norm clip. The update is `torch.optim.AdamW` over one parameter group per
(LR multiplier, decayed or not); before each step the trainer sets every
group's learning rate and weight decay from the schedules at that step.
That is the optax chain clip -> scale_by_adam -> add_decayed_weights ->
scale_by_learning_rate -> multipliers: torch's decoupled decay
p *= 1 - lr * mult * wd equals optax's -lr * mult * wd * p.

Parameters are matched by their flax path (`transformer/blocks_6/...`), the
names the JAX rules are written against; `flax_path` maps a torch name to it.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Iterable

import torch

from exploremultimodal_torch.parallel.partitioning import (
    full,
    gather_tensor,
    like,
    local,
    shard_tensor,
)

Schedule = Callable[[int], float]

HEAD_NAMES = (
    "mlm_head", "itc_head", "itm_head", "mim_head", "mpp_head",
    "vqa_classifier", "nlvr2_classifier", "rank_output",
    "img_classifier", "mae_head", "ref_head",
)


def flax_path(name: str) -> str:
    """torch parameter name -> the flax path the JAX rules match."""
    return re.sub(r"blocks\.(\d+)", r"blocks_\1", name).replace(".", "/")


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule."""
    return lambda t: init + (end - init) * min(max(t / steps, 0.0), 1.0)


def build_schedule(train_cfg: dict, steps_per_epoch: int) -> Schedule:
    """Per-step learning rate: linear warmup from warmup_lr, then linear
    (to 1% of base), cosine (to min_lr) or step decay."""
    total_steps = int(train_cfg["epochs"] * steps_per_epoch)
    warmup = int(train_cfg["warmup_epochs"] * steps_per_epoch)
    if train_cfg.get("warmup_steps"):
        warmup = int(train_cfg["warmup_steps"])
    warmup = min(warmup, max(total_steps - 1, 1))
    base = float(train_cfg["base_lr"])
    warmup_lr = float(train_cfg.get("warmup_lr") or 0.0)
    min_lr = float(train_cfg.get("min_lr") or 0.0)
    sched = train_cfg["lr_scheduler"]
    decay_steps = max(total_steps - warmup, 1)
    if sched["name"] == "linear":
        decay = _linear(base, base * 0.01, decay_steps)
    elif sched["name"] == "cosine":
        alpha = min_lr / base

        def decay(t):
            c = 0.5 * (1 + math.cos(math.pi * min(t, decay_steps) / decay_steps))
            return base * ((1 - alpha) * c + alpha)
    elif sched["name"] == "step":
        every = max(int(sched["decay_epochs"] * steps_per_epoch), 1)
        rate = float(sched["decay_rate"])

        def decay(t):
            return base * rate ** (t // every)
    else:
        raise ValueError(f"unknown lr scheduler {sched['name']!r}")
    warm = _linear(warmup_lr, base, max(warmup, 1))
    return lambda t: warm(t) if t < warmup else decay(t - warmup)


def build_wd_schedule(train_cfg: dict, steps_per_epoch: int) -> Schedule | None:
    """Cosine weight decay weight_decay -> weight_decay_end over the run
    (no warmup); None when the two are equal or the end is unset."""
    wd = float(train_cfg["weight_decay"])
    wd_end = train_cfg.get("weight_decay_end")
    if wd_end is None or float(wd_end) == wd:
        return None
    wd_end = float(wd_end)
    total = max(int(train_cfg["epochs"] * steps_per_epoch), 1)

    def schedule(t):
        frac = min(max(t / total, 0.0), 1.0)
        return wd_end + 0.5 * (wd - wd_end) * (1.0 + math.cos(math.pi * frac))

    return schedule


def lr_multipliers(names: Iterable[str], fusion_layer: int, depth: int,
                   lr_mult_head: float = 1.0, lr_mult_fusion: float = 1.0,
                   freeze_predicate: Callable[[str], bool] | None = None
                   ) -> dict[str, float]:
    """{flax path: LR multiplier}: heads x lr_mult_head, fusion blocks and
    the pooler x lr_mult_fusion, frozen 0, the rest 1."""
    fusion_blocks = {f"blocks_{i}" for i in range(fusion_layer, depth)}

    def mult(name: str) -> float:
        if freeze_predicate is not None and freeze_predicate(name):
            return 0.0
        if any(h in name for h in HEAD_NAMES):
            return float(lr_mult_head)
        if any(b in name for b in fusion_blocks) or "pooler" in name:
            return float(lr_mult_fusion)
        return 1.0

    return {name: mult(name) for name in names}


def no_decay_mask(params: dict[str, torch.Tensor]) -> dict[str, bool]:
    """{flax path: True where weight decay applies}: >= 2-D, not a bias, not
    in the skip set."""
    skip = ("itc_temp", "pos_embed", "img_cls_token", "img_mask_token")

    def decayed(name: str, p: torch.Tensor) -> bool:
        if any(s in name for s in skip):
            return False
        return not (p.ndim <= 1 or name.endswith("bias"))

    return {name: decayed(name, p) for name, p in params.items()}


def phase_frozen_predicate(loss_names, phase: str | None = None,
                           mim_head_pos: str = "img"):
    """The parameters a phase's losses never reach (a path predicate), or
    None when every parameter can get a gradient. They stay out of the
    optimizer, as torch skips parameters whose grad is None."""
    losses = set(loss_names)
    if not losses:
        return None
    mim_fused = "mim" in losses and mim_head_pos == "mum"
    text_used = bool(losses & {
        "mlm", "itc", "itm", "irtr", "vqa", "nlvr2", "mpp", "caption",
        "refcoco", "inpainting", "imgcls",
    }) or mim_fused
    image_used = bool(losses & {
        "mim", "mpp", "mae", "imgcls", "itc", "itm", "irtr", "vqa", "nlvr2",
        "caption", "refcoco", "inpainting",
    })
    masked_image_used = bool(losses & {"mim", "mpp", "mae"})
    fused_used = bool(losses & {
        "itm", "vqa", "nlvr2", "mpp", "irtr", "caption", "refcoco",
        "inpainting", "imgcls",
    }) or ("mlm" in losses and image_used) or mim_fused
    pooled_used = bool(losses & {"itm", "vqa", "nlvr2", "irtr", "imgcls",
                                 "refcoco"})
    frozen: set[str] = set()
    if not text_used:
        frozen |= {"txt_embeddings", "mlp_l"}
    if not image_used:
        frozen |= {"patch_embed", "pos_embed", "img_cls_token", "mlp_v"}
    if not masked_image_used:
        frozen.add("img_mask_token")
    if not fused_used:
        frozen.add("mlp_vl")
    if not pooled_used:
        frozen.add("pooler")
    if not frozen:
        return None
    return lambda name: any(seg in frozen for seg in name.split("/"))


def fixed_attn_predicate(name: str) -> bool:
    """pretrain_txt's fixed_attn freeze set: shared attention, block norms,
    gammas and the final norm."""
    if "blocks_" in name and any(part in name for part in (
            "attn", "norm1", "norm2", "gamma_1", "gamma_2")):
        return True
    return name.startswith("transformer/norm/")


class Optimizer:
    """torch AdamW driven by the schedules: `step(t)` clips, sets each
    group's lr and weight decay for step t, and updates.

    The presets (`parallel/partitioning.py`): with a `zero_group` the
    update is `ZeroRedundancyOptimizer` over the same groups, each process
    of the group holding the moments of its share of the parameters
    (zero1); sharded (DTensor) parameters hold sharded moments (fsdp), and
    the gradient norm sums their shards over the processes; a parameter
    split over the tensor axis (`partitioning.mark_tensor_sharded`) holds
    its share's moments, which the whole state gathers; with `offload`
    the moments live in pinned host memory between steps and are copied to
    the device around each update (fsdp_offload on CUDA)."""

    def __init__(self, groups: list[dict], schedule: Schedule,
                 wd_schedule: Schedule | None, weight_decay: float,
                 clip_grad: float | None, betas, eps: float, *,
                 zero_group=None, offload: bool = False):
        self.schedule = schedule
        self.wd_schedule = wd_schedule
        self.weight_decay = weight_decay
        self.clip_grad = clip_grad
        self.params = [p for g in groups for p in g["params"]]
        self.offload = offload
        # (state, key, the sharded layout or None, device) of each parked
        # moment, and the host buffers, kept from step to step
        self._parked: list = []
        self._host: dict = {}
        if zero_group is not None:
            from torch.distributed.optim import ZeroRedundancyOptimizer

            self.torch = ZeroRedundancyOptimizer(
                groups, optimizer_class=torch.optim.AdamW, process_group=zero_group,
                lr=0.0, betas=tuple(betas), eps=eps, weight_decay=0.0)
        else:
            self.torch = torch.optim.AdamW(groups, lr=0.0, betas=tuple(betas),
                                           eps=eps, weight_decay=0.0)

    @property
    def zero(self) -> bool:
        return not isinstance(self.torch, torch.optim.AdamW)

    def stage_in(self) -> None:
        """The parked moments back on their parameters' devices."""
        for st, k, layout, dev in self._parked:
            st[k] = _with_local(layout, st[k].to(dev, non_blocking=True))
        self._parked = []

    def park(self) -> None:
        """Every moment's local shard copied to pinned host memory, where it
        stays in the state until `stage_in` (`offload`); the device copy is
        freed."""
        for st in self.torch.state.values():
            for k, v in st.items():
                if k == "step" or not isinstance(v, torch.Tensor):
                    continue
                loc = local(v)
                host = self._host.get((id(st), k))
                if host is None:
                    host = self._host[(id(st), k)] = torch.empty(
                        loc.shape, dtype=loc.dtype, pin_memory=loc.is_cuda)
                host.copy_(loc, non_blocking=True)
                # a sharded moment's layout, not the moment: nothing keeps
                # its device shard alive
                layout = (None if loc is v else
                          (v.device_mesh, v.placements, v.shape, v.stride()))
                self._parked.append((st, k, layout, loc.device))
                st[k] = host

    def zero_grad(self) -> None:
        self.torch.zero_grad(set_to_none=True)

    def step(self, t: int) -> None:
        # a parameter the step's losses did not reach (finetune_vqa's image
        # and text experts above the fusion layer) takes a zero gradient:
        # the JAX optimizer updates every parameter of its tree, so weight
        # decay still applies to it, where torch would skip it
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_grad:
            # optax.clip_by_global_norm: g * max / norm where norm >= max
            norm = global_norm(self.params)
            coef = torch.where(norm < self.clip_grad, torch.ones_like(norm),
                               self.clip_grad / norm)
            for p in self.params:
                if p.grad is not None:
                    local(p.grad).mul_(coef)
        lr = self.schedule(t)
        wd = self.wd_schedule(t) if self.wd_schedule else self.weight_decay
        for g in self.torch.param_groups:
            g["lr"] = lr * g["lr_mult"]
            g["weight_decay"] = wd if g["decay"] else 0.0
        self.stage_in()
        self.torch.step()
        if self.offload:
            self.park()

    def full_state_dict(self) -> dict | None:
        """The update's state whole, in `torch.optim.AdamW`'s format (moments
        by parameter index, on the host): the zero1 shards consolidated on
        rank 0, the fsdp shards gathered. Every process must call; ranks
        other than 0 of a zero1 group get None."""
        self.stage_in()
        try:
            if self.zero:
                self.torch.consolidate_state_dict(to=0)
                if self.torch.global_rank != 0:
                    return None
            sd = self.torch.state_dict()
            sd["state"] = {i: {k: self._whole(i, k, v) for k, v in st.items()}
                           for i, st in sd["state"].items()}
            return sd
        finally:
            if self.offload:
                self.park()

    def _whole(self, i: int, key: str, v):
        """Moment `key` of parameter i whole on the host: gathered from
        its fsdp shards, then from the tensor axis where the parameter is
        split there (every process must call)."""
        if not isinstance(v, torch.Tensor):
            return v
        v = full(v)
        axis = getattr(self.params[i], "tensor_axis", None)
        if axis is not None and key != "step":
            import torch.distributed as dist

            parts = [torch.empty_like(v) for _ in range(axis.size)]
            dist.all_gather(parts, v.contiguous(), group=axis.group)
            v = gather_tensor(parts, self.params[i].tensor_split)
        return v.cpu()

    def _share(self, i: int, key: str, v):
        """Moment `key` (whole) of parameter i as the parameter is held:
        this rank's share over the tensor axis, then its fsdp shard."""
        if not isinstance(v, torch.Tensor) or key == "step":
            return v
        p = self.params[i]
        axis = getattr(p, "tensor_axis", None)
        if axis is not None:
            v = shard_tensor(v, p.tensor_split, axis.rank, axis.size)
        return like(p, v)

    def load_full_state_dict(self, sd: dict) -> None:
        """Load `full_state_dict`'s format: each moment sharded as its
        parameter is."""
        self.stage_in()
        if not self.zero:
            sd = {**sd, "state": {i: {k: self._share(i, k, v) for k, v in st.items()}
                                  for i, st in sd["state"].items()}}
        self.torch.load_state_dict(sd)
        if self.offload:
            self.park()


def create_optimizer(cfg: dict, named_params: dict[str, torch.Tensor],
                     steps_per_epoch: int, *, zero_group=None,
                     offload: bool = False) -> tuple[Optimizer, Schedule]:
    """AdamW over the trainable `named_params` (torch names), grouped by
    LR multiplier and weight decay as the JAX `create_optimizer` groups
    them; `zero_group` and `offload` as `Optimizer` takes them."""
    t = cfg["train"]
    opt = t["opt"]
    name = opt["name"].lower().replace("fused", "")
    if name != "adamw":
        raise NotImplementedError(f"optimizer {opt['name']!r}: only adamw is ported")
    schedule = build_schedule(t, steps_per_epoch)
    paths = {flax_path(n): p for n, p in named_params.items()}
    mults = lr_multipliers(
        paths, cfg["model"]["fusion_layer"], cfg["model"]["depth"],
        lr_mult_head=t.get("lr_mult_head", 1.0),
        lr_mult_fusion=t.get("lr_mult_fusion", 1.0),
        freeze_predicate=fixed_attn_predicate if t.get("fixed_attn") else None)
    decayed = no_decay_mask(paths)
    groups: dict[tuple[float, bool], list] = {}
    for path, p in paths.items():
        groups.setdefault((mults[path], decayed[path]), []).append(p)
    param_groups = [{"params": ps, "lr_mult": m, "decay": d}
                    for (m, d), ps in groups.items()]
    return Optimizer(param_groups, schedule, build_wd_schedule(t, steps_per_epoch),
                     float(t["weight_decay"]), t.get("clip_grad"),
                     opt.get("betas", [0.9, 0.999]), float(opt.get("eps", 1e-8)),
                     zero_group=zero_group, offload=offload), schedule


def _with_local(layout: tuple | None, loc: torch.Tensor) -> torch.Tensor:
    """`loc` as the local shard of a DTensor of `layout` (mesh, placements,
    shape, stride); `loc` itself where the layout is None."""
    if layout is None:
        return loc
    from torch.distributed.tensor import DTensor

    mesh, placements, shape, stride = layout
    return DTensor.from_local(loc, mesh, placements, run_check=False, shape=shape,
                              stride=stride)


def global_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """The fp32 L2 norm of every gradient together. Sharded (DTensor)
    gradients add their shards' squares over the processes; gradients of
    parameters split over the tensor axis add theirs over the tensor group,
    and those whole on it count once."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    if any(hasattr(p, "tensor_axis") for p in params):
        return _tensor_norm(params)
    if not any(hasattr(g, "device_mesh") for g in grads):
        norms = [torch.linalg.vector_norm(g.float()) for g in grads]
        return torch.linalg.vector_norm(torch.stack(norms))
    import torch.distributed as dist

    sharded = [g for g in grads if hasattr(g, "device_mesh")]
    sq = torch.stack([torch.linalg.vector_norm(local(g).float()) ** 2 for g in sharded]).sum()
    dist.all_reduce(sq, group=sharded[0].device_mesh.get_group())
    # a gradient kept whole on every process counts once
    whole = [torch.linalg.vector_norm(g.float()) ** 2 for g in grads
             if not hasattr(g, "device_mesh")]
    return torch.sqrt(sq + torch.stack(whole).sum() if whole else sq)


def _tensor_norm(params: list[torch.Tensor]) -> torch.Tensor:
    """`global_norm` where some parameters are split over the tensor axis:
    the squares of four kinds of gradient, whole, fsdp-sharded,
    tensor-split, both; the fsdp-sharded sums added over the fsdp group,
    then the tensor-split ones over the tensor group."""
    import torch.distributed as dist

    dev = local(params[0].grad).device
    # squares by kind: 2 * (tensor-split) + (fsdp-sharded)
    sums = [torch.zeros((), dtype=torch.float32, device=dev) for _ in range(4)]
    fsdp_group = tensor_group = None
    for p in params:
        g = p.grad
        dtensor, split = hasattr(g, "device_mesh"), hasattr(p, "tensor_axis")
        if dtensor:
            fsdp_group = g.device_mesh.get_group()
        if split:
            tensor_group = p.tensor_axis.group
        sums[2 * split + dtensor] = (sums[2 * split + dtensor]
                                     + torch.linalg.vector_norm(local(g).float()) ** 2)
    whole, fsdp, split, both = sums
    if fsdp_group is not None:
        v = torch.stack([fsdp, both])
        dist.all_reduce(v, group=fsdp_group)
        fsdp, both = v.unbind()
    v = torch.stack([split, both])
    dist.all_reduce(v, group=tensor_group)
    return torch.sqrt(whole + fsdp + v.sum())
