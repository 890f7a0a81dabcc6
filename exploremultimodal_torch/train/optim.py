"""The optimizer menu with the JAX package's parameter groups and per-step
schedules.

Counterpart of `exploremultimodal_tpu/train/optim.py`: `build_schedule`,
`build_wd_schedule`, `lr_multipliers`, `no_decay_mask`,
`phase_frozen_predicate` and `create_optimizer`, with the optional global
norm clip and every update rule of JAX's `_update_rule` table (`RULES`),
each optionally under `lookahead_` (`slow_ema_lookahead`). The update
runs over one parameter group per (LR multiplier, decayed or not); before
each step the trainer sets every group's learning rate and weight decay
from the schedules at that step. That is the optax chain clip -> rule ->
add_decayed_weights (only for `DECAYS_WEIGHTS`) -> scale_by_learning_rate
-> multipliers. adamw is `torch.optim.AdamW`, whose decoupled decay p *= 1
- lr * mult * wd equals optax's -lr * mult * wd * p; every other rule, and
adamw under lookahead, is `RuleOptimizer`, optax's arithmetic in plain
PyTorch.

Parameters are matched by their flax path (`transformer/blocks_6/...`), the
names the JAX rules are written against; `flax_path` maps a torch name to it.
"""

from __future__ import annotations

import functools
import math
import re
from typing import Callable, Iterable

import numpy as np
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


# JAX's `_update_rule` table; the rules whose chain adds decayed weights
# (`sgdw` is among JAX's, though not in its table, so it raises there too)
RULES = ("adam", "adamw", "nadam", "radam", "lamb", "lars", "sgd", "momentum", "nesterov",
         "rmsprop", "rmsproptf", "adadelta", "adafactor", "novograd", "lion")
DECAYS_WEIGHTS = ("adamw", "lamb", "lars", "sgdw", "novograd")
# `slow_ema_lookahead(sync_period=6, slow_step=0.5)`
LOOKAHEAD_PERIOD, LOOKAHEAD_STEP = 6, 0.5
# optax's fixed settings: scale_by_rms(decay=0.9), scale_by_adadelta(rho=0.9),
# scale_by_radam(threshold=5.0), scale_by_factored_rms()'s defaults
RMS_DECAY, ADADELTA_RHO, RADAM_THRESHOLD = 0.9, 0.9, 5.0
FACTORED_DECAY, FACTORED_MIN_DIM, FACTORED_EPS = 0.8, 128, 1e-30
# state entries held whole on every process (a count, adafactor's factored
# row and column statistics, novograd's per-leaf second moment); every
# other entry has its parameter's shape and is split and sharded as it is
WHOLE_STATE = ("step", "v_row", "v_col", "nu_leaf")


def parse_name(name: str) -> tuple[str, bool]:
    """`train.opt.name` as JAX reads it: lower-cased, `fused` dropped, an
    optional `lookahead_` prefix. Returns (rule, lookahead); a rule not in
    `RULES` raises NotImplementedError, listing them."""
    rule = name.lower().replace("fused", "")
    lookahead = rule.startswith("lookahead_")
    if lookahead:
        rule = rule[len("lookahead_"):]
    if rule not in RULES:
        raise NotImplementedError(
            f"optimizer {rule!r}; available: {sorted(RULES)} (+ lookahead_ prefix)")
    return rule, lookahead


def factored_dims(shape) -> tuple[int, int] | None:
    """optax's `_factored_dims` with its defaults: the (second largest,
    largest) axes of a leaf of `shape` where the second reaches 128, else
    None (a per-element second moment)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < FACTORED_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def _shard_group(p: torch.Tensor):
    """The group over which a DTensor's shards lie (its Shard mesh dim), or
    None for a tensor held whole."""
    for dim, placement in enumerate(getattr(p, "placements", ())):
        if placement.is_shard():
            return p.device_mesh.get_group(dim)
    return None


def _leaf_sums(params: list[torch.Tensor], parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """parts[i], sums over this process's piece of parameter i's leaf,
    added over the processes holding the other pieces: a DTensor's shard
    group, then the tensor group where the parameter is split there (as
    `_tensor_norm` adds the gradient's squares). A parameter held whole
    counts once. One all-reduce a group."""
    import torch.distributed as dist

    out = list(parts)
    for kind in ("fsdp", "tensor"):
        groups: dict[int, tuple] = {}
        for i, p in enumerate(params):
            grp = (_shard_group(p) if kind == "fsdp"
                   else getattr(getattr(p, "tensor_axis", None), "group", None))
            if grp is not None:
                groups.setdefault(id(grp), (grp, []))[1].append(i)
        for grp, ids in groups.values():
            flat = torch.cat([out[i].reshape(-1) for i in ids])
            dist.all_reduce(flat, group=grp)
            for i, part in zip(ids, flat.split([out[i].numel() for i in ids])):
                out[i] = part.view_as(out[i])
    return out


def _leaf_layout(p: torch.Tensor) -> tuple[tuple, list]:
    """(the whole leaf's shape, where this process's piece lies in it) of
    parameter p, the piece given per axis as the whole leaf's indices of
    its entries (None where the piece spans the axis): dim 0 or 1 split
    over the tensor axis (`partitioning.shard_tensor`), then dim 0 sharded
    by FSDP2 (torch.chunk's rows)."""
    shape = list(p.shape)  # a DTensor's: the whole of its shards
    idx: list = [None] * max(p.ndim, 2)
    axis = getattr(p, "tensor_axis", None)
    dev = local(p).device
    if axis is not None:
        t, size = axis.rank, axis.size
        dim = 1 if p.tensor_split == "cols" else 0
        n = shape[dim]
        if p.tensor_split == "qkv":
            per = n // 3
            idx[0] = torch.cat([j * per * size + t * per + torch.arange(per)
                                for j in range(3)])
        else:
            idx[dim] = t * n + torch.arange(n)
        shape[dim] = n * size
    grp = _shard_group(p)
    if grp is not None:
        import torch.distributed as dist

        chunk = -(-p.shape[0] // dist.get_world_size(grp))
        rows = dist.get_rank(grp) * chunk + torch.arange(local(p).shape[0])
        idx[0] = rows if idx[0] is None else idx[0][rows]
    idx = [None if i is None else i.to(dev) for i in idx]
    return tuple(shape), idx[:p.ndim]


def _scatter(t: torch.Tensor, idx: list, shape) -> torch.Tensor:
    """`t`, a piece of a tensor of `shape`, placed at the indices `idx` (per
    axis, None where it spans the axis), zeros elsewhere."""
    for a, ix in enumerate(idx):
        if ix is not None:
            whole = t.new_zeros(t.shape[:a] + (shape[a],) + t.shape[a + 1:])
            t = whole.index_add_(a, ix, t)
    return t


def _select(t: torch.Tensor, idx: list) -> torch.Tensor:
    """The piece of `t` at the indices `idx` (`_scatter`'s inverse)."""
    for a, ix in enumerate(idx):
        if ix is not None:
            t = t.index_select(a, ix)
    return t


class RuleOptimizer(torch.optim.Optimizer):
    """optax's update rules (`RULES`) as one torch optimizer: each step
    computes the rule's update u from the gradient, adds weight_decay * p
    (a group's `weight_decay`, 0 for rules outside `DECAYS_WEIGHTS`) and
    moves p by -lr * u (the group's `lr`: the schedule's rate times the
    group's multiplier). With `lookahead` every LOOKAHEAD_PERIOD-th update
    then pulls the parameters LOOKAHEAD_STEP of the way back to a slow copy
    (which starts at the parameters of the first step) and both go on from
    there, inside the step, so that ZeRO-1 broadcasts the reset.

    A parameter may be a DTensor shard (fsdp) or a tensor rank's share
    (`tensor_axis`); the rule then works on its local piece, and the
    statistics optax takes over a whole leaf (lamb's and lars's trust
    ratio, novograd's squared gradient norm, adafactor's row and column
    means) add their pieces over the processes (`_leaf_sums`). Adafactor
    factors by the whole leaf's shape (`_leaf_layout`); its row and column
    statistics are kept whole on every process. It factors the torch
    layout: optax picks the two largest axes by size, the same physical
    axes in the flax (in, out) / HWIO layout, and a 2-D update is the same
    whichever of the two is called the row."""

    def __init__(self, params, rule: str = "adam", lr: float = 0.0,
                 weight_decay: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 momentum: float = 0.9, lookahead: bool = False):
        if rule not in RULES:
            raise NotImplementedError(f"optimizer {rule!r}")
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, rule=rule,
                                      betas=tuple(betas), eps=eps, momentum=momentum,
                                      lookahead=lookahead))
        self._layouts: dict[int, tuple] = {}

    def _layout(self, p: torch.Tensor) -> tuple:
        if id(p) not in self._layouts:
            self._layouts[id(p)] = _leaf_layout(p)
        return self._layouts[id(p)]

    def _init_state(self, p: torch.Tensor, st: dict) -> None:
        rule = self.defaults["rule"]
        st["step"] = torch.tensor(0.0)
        zeros = functools.partial(torch.zeros_like, p, memory_format=torch.preserve_format)
        keys = {"lars": ("trace",), "momentum": ("trace",), "nesterov": ("trace",),
                "rmsprop": ("nu",), "rmsproptf": ("nu",), "adadelta": ("e_g", "e_x"),
                "novograd": ("mu",), "lion": ("mu",), "sgd": ()}.get(rule, ("mu", "nu"))
        if rule == "adafactor":
            shape, _ = self._layout(p)
            dims = factored_dims(shape)
            if dims is None:
                keys = ("v",)
            else:
                dev = local(p).device
                st["v_row"] = torch.zeros([s for a, s in enumerate(shape) if a != dims[1]],
                                          device=dev)
                st["v_col"] = torch.zeros([s for a, s in enumerate(shape) if a != dims[0]],
                                          device=dev)
                keys = ()
        if rule == "novograd":
            st["nu_leaf"] = torch.zeros((), device=local(p).device)
        for k in keys:
            st[k] = zeros()
        if self.defaults["lookahead"]:
            st["slow"] = p.detach().clone()

    @torch.no_grad()
    def step(self, closure=None):
        items = []
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    self._init_state(p, st)
                st["step"] += 1
                items.append((p, group, st))
        if not items:
            return None
        updates = self._updates(items)
        d = self.defaults
        for (p, group, st), u in zip(items, updates):
            pl = local(p)
            if group["weight_decay"]:
                u = u + group["weight_decay"] * pl
            pl.add_(u, alpha=-group["lr"])
            if d["lookahead"] and int(st["step"]) % LOOKAHEAD_PERIOD == 0:
                slow = local(st["slow"])
                slow.add_(pl - slow, alpha=LOOKAHEAD_STEP)
                pl.copy_(slow)
        return None

    def _updates(self, items: list) -> list[torch.Tensor]:
        """Each parameter's update u (its local piece), before the decay and
        the learning rate."""
        d = self.defaults
        rule, (b1, b2), eps, m = d["rule"], d["betas"], d["eps"], d["momentum"]
        params = [p for p, _, _ in items]
        if rule == "adafactor":
            return self._adafactor(items)
        if rule == "novograd":
            norms = _leaf_sums(params, [local(p.grad).square().sum().reshape(1)
                                        for p in params])
        out = []
        for i, (p, _, st) in enumerate(items):
            g = local(p.grad)
            c = float(st["step"])

            def s(key):
                return local(st[key])

            if rule in ("adam", "adamw", "nadam", "radam", "lamb"):
                mu, nu = s("mu"), s("nu")
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                if rule == "nadam":
                    mu_hat = b1 * (mu / (1 - b1 ** (c + 1))) + (1 - b1) * (g / (1 - b1 ** c))
                else:
                    mu_hat = mu / (1 - b1 ** c)
                u = mu_hat / ((nu / (1 - b2 ** c)).sqrt() + eps)
                if rule == "radam":
                    ro_inf = 2.0 / (1.0 - b2) - 1.0
                    ro = ro_inf - 2 * c * b2 ** c / (1 - b2 ** c)
                    if ro >= RADAM_THRESHOLD:
                        u = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                      / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)) * u
                    else:
                        u = mu_hat
            elif rule in ("lars", "momentum", "nesterov"):
                trace = s("trace").mul_(m).add_(g)
                u = g + m * trace if rule == "nesterov" else trace.clone()
            elif rule == "sgd":
                u = g
            elif rule in ("rmsprop", "rmsproptf"):
                nu = s("nu").mul_(RMS_DECAY).addcmul_(g, g, value=1 - RMS_DECAY)
                u = torch.rsqrt(nu + eps) * g
            elif rule == "adadelta":
                e_g = s("e_g").mul_(ADADELTA_RHO).addcmul_(g, g, value=1 - ADADELTA_RHO)
                e_x = s("e_x")
                u = (e_x + eps).sqrt() / (e_g + eps).sqrt() * g
                e_x.mul_(ADADELTA_RHO).addcmul_(u, u, value=1 - ADADELTA_RHO)
            elif rule == "novograd":
                nu = st["nu_leaf"]
                n = norms[i].reshape(())
                if c == 1:
                    nu.copy_(n)
                else:
                    nu.mul_(b2).add_(n, alpha=1 - b2)
                scaled = g / (nu.sqrt() + eps)
                mu = s("mu")
                if c == 1:
                    mu.copy_(scaled)
                else:
                    mu.mul_(b1).add_(scaled)
                u = mu.clone()
            else:  # lion
                mu = s("mu")
                u = torch.sign((1 - b1) * g + b1 * mu)
                mu.mul_(b2).add_(g, alpha=1 - b2)
            out.append(u)
        if rule in ("lamb", "lars"):
            # optax.scale_by_trust_ratio: ||p|| / ||u|| over the whole leaf,
            # 1 where either is 0
            sums = _leaf_sums(params, [torch.stack([local(p).square().sum(), u.square().sum()])
                                       for p, u in zip(params, out)])
            for i, sq in enumerate(sums):
                pn, un = sq.sqrt().unbind()
                ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
                out[i] = out[i] * ratio
        return out

    def _adafactor(self, items: list) -> list[torch.Tensor]:
        """optax.scale_by_factored_rms() on each parameter's piece: the
        factored leaves' row and column sums of g^2 + eps added over the
        pieces, their means taken of the whole leaf."""
        out: list = [None] * len(items)
        factored, parts = [], []
        for i, (p, _, st) in enumerate(items):
            g = local(p.grad)
            decay = 1.0 - float(st["step"]) ** -FACTORED_DECAY
            sq = g * g + FACTORED_EPS
            if "v" in st:
                v = local(st["v"]).mul_(decay).add_(sq, alpha=1 - decay)
                out[i] = g * v.pow(-0.5)
                continue
            shape, idx = self._layout(p)
            d1, d0 = factored_dims(shape)
            parts.append(torch.cat([
                _scatter(sq.sum(d0), idx[:d0] + idx[d0 + 1:],
                         shape[:d0] + shape[d0 + 1:]).reshape(-1),
                _scatter(sq.sum(d1), idx[:d1] + idx[d1 + 1:],
                         shape[:d1] + shape[d1 + 1:]).reshape(-1)]))
            factored.append((i, decay))
        sums = _leaf_sums([items[i][0] for i, _ in factored], parts)
        for (i, decay), total in zip(factored, sums):
            p, _, st = items[i]
            shape, idx = self._layout(p)
            d1, d0 = factored_dims(shape)
            v_row, v_col = st["v_row"], st["v_col"]
            row, col = total.split([v_row.numel(), v_col.numel()])
            v_row.mul_(decay).add_(row.view_as(v_row) / shape[d0], alpha=1 - decay)
            v_col.mul_(decay).add_(col.view_as(v_col) / shape[d1], alpha=1 - decay)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)) ** -0.5
            col_factor = v_col ** -0.5
            out[i] = (local(p.grad) * _select(row_factor, idx[:d0] + idx[d0 + 1:]).unsqueeze(d0)
                      * _select(col_factor, idx[:d1] + idx[d1 + 1:]).unsqueeze(d1))
        return out


class Optimizer:
    """The update rule driven by the schedules: `step(t)` clips, sets each
    group's lr and weight decay for step t, and updates. The rule is
    `torch.optim.AdamW` for adamw and `RuleOptimizer` for every other
    name of the menu (`name`, as `train.opt.name` gives it, normalized).

    The presets (`parallel/partitioning.py`): with a `zero_group` the
    update is `ZeroRedundancyOptimizer` over the same groups, each process
    of the group holding the state of its share of the parameters
    (zero1); sharded (DTensor) parameters hold sharded state (fsdp), and
    the gradient norm sums their shards over the processes; a parameter
    split over the tensor axis (`partitioning.mark_tensor_sharded`) holds
    its share's state, which the whole state gathers; with `offload`
    every state tensor lives in pinned host memory between steps and is
    copied to the device around each update (fsdp_offload on CUDA)."""

    def __init__(self, groups: list[dict], schedule: Schedule,
                 wd_schedule: Schedule | None, weight_decay: float,
                 clip_grad: float | None, betas, eps: float, *,
                 name: str = "adamw", momentum: float = 0.9,
                 zero_group=None, offload: bool = False):
        self.schedule = schedule
        self.wd_schedule = wd_schedule
        self.weight_decay = weight_decay
        self.clip_grad = clip_grad
        self.params = [p for g in groups for p in g["params"]]
        self.offload = offload
        rule, lookahead = parse_name(name)
        self.name = ("lookahead_" if lookahead else "") + rule
        # (state, key, the sharded layout or None, device) of each parked
        # state tensor, and the host buffers, kept from step to step
        self._parked: list = []
        self._host: dict = {}
        kwargs = dict(lr=0.0, betas=tuple(betas), eps=eps, weight_decay=0.0)
        if self.name == "adamw":
            cls = torch.optim.AdamW
        else:
            cls = RuleOptimizer
            kwargs.update(rule=rule, momentum=momentum, lookahead=lookahead)
        self.zero = zero_group is not None
        if self.zero:
            from torch.distributed.optim import ZeroRedundancyOptimizer

            self.torch = ZeroRedundancyOptimizer(groups, optimizer_class=cls,
                                                 process_group=zero_group, **kwargs)
        else:
            self.torch = cls(groups, **kwargs)

    def stage_in(self) -> None:
        """The parked state back on its parameters' devices."""
        for st, k, layout, dev in self._parked:
            st[k] = _with_local(layout, st[k].to(dev, non_blocking=True))
        self._parked = []

    def park(self) -> None:
        """Every state tensor's local shard copied to pinned host memory,
        where it stays in the state until `stage_in` (`offload`); the device
        copy is freed. The step counts stay where they are (on the host)."""
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
                # a sharded tensor's layout, not the tensor: nothing keeps
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
        """The update's state whole, in the torch optimizer's format (state
        by parameter index, on the host) with the menu's name under "rule":
        the zero1 shards consolidated on rank 0, the fsdp shards gathered,
        the tensor shares gathered. Every process must call; ranks other
        than 0 of a zero1 group get None."""
        self.stage_in()
        try:
            if self.zero:
                self.torch.consolidate_state_dict(to=0)
                if self.torch.global_rank != 0:
                    return None
            sd = self.torch.state_dict()
            sd["state"] = {i: {k: self._whole(i, k, v) for k, v in st.items()}
                           for i, st in sd["state"].items()}
            sd["rule"] = self.name
            return sd
        finally:
            if self.offload:
                self.park()

    def _whole(self, i: int, key: str, v):
        """State entry `key` of parameter i whole on the host: gathered from
        its fsdp shards, then from the tensor axis where the parameter is
        split there; entries of `WHOLE_STATE` are whole already (every
        process must call)."""
        if not isinstance(v, torch.Tensor):
            return v
        v = full(v)
        axis = getattr(self.params[i], "tensor_axis", None)
        if axis is not None and key not in WHOLE_STATE:
            import torch.distributed as dist

            parts = [torch.empty_like(v) for _ in range(axis.size)]
            dist.all_gather(parts, v.contiguous(), group=axis.group)
            v = gather_tensor(parts, self.params[i].tensor_split)
        return v.cpu()

    def _share(self, i: int, key: str, v):
        """State entry `key` (whole) of parameter i as the parameter is
        held: this rank's share over the tensor axis, then its fsdp shard;
        entries of `WHOLE_STATE` stay whole."""
        if not isinstance(v, torch.Tensor) or key in WHOLE_STATE:
            return v
        p = self.params[i]
        axis = getattr(p, "tensor_axis", None)
        if axis is not None:
            v = shard_tensor(v, p.tensor_split, axis.rank, axis.size)
        return like(p, v)

    def load_full_state_dict(self, sd: dict) -> None:
        """Load `full_state_dict`'s format: each entry sharded as its
        parameter is. A state of another rule raises ValueError (a file
        without "rule" holds AdamW's)."""
        rule = sd.get("rule", "adamw")
        if rule != self.name:
            raise ValueError(f"the checkpoint's optimizer state is {rule!r}'s; this run "
                             f"uses {self.name!r}")
        sd = {k: v for k, v in sd.items() if k != "rule"}
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
    """The `train.opt.name` rule over the trainable `named_params` (torch
    names), grouped by LR multiplier and weight decay as the JAX
    `create_optimizer` groups them; `zero_group` and `offload` as
    `Optimizer` takes them."""
    t = cfg["train"]
    opt = t["opt"]
    rule, _ = parse_name(opt["name"])
    schedule = build_schedule(t, steps_per_epoch)
    paths = {flax_path(n): p for n, p in named_params.items()}
    mults = lr_multipliers(
        paths, cfg["model"]["fusion_layer"], cfg["model"]["depth"],
        lr_mult_head=t.get("lr_mult_head", 1.0),
        lr_mult_fusion=t.get("lr_mult_fusion", 1.0),
        freeze_predicate=fixed_attn_predicate if t.get("fixed_attn") else None)
    decayed = no_decay_mask(paths)
    decays = rule in DECAYS_WEIGHTS
    groups: dict[tuple[float, bool], list] = {}
    for path, p in paths.items():
        groups.setdefault((mults[path], decays and decayed[path]), []).append(p)
    param_groups = [{"params": ps, "lr_mult": m, "decay": d}
                    for (m, d), ps in groups.items()]
    return Optimizer(param_groups, schedule, build_wd_schedule(t, steps_per_epoch),
                     float(t["weight_decay"]), t.get("clip_grad"),
                     opt.get("betas", [0.9, 0.999]), float(opt.get("eps", 1e-8)),
                     name=opt["name"], momentum=float(opt.get("momentum", 0.9)),
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
    """The L2 norm of every gradient together, as fp32; the squares are
    added in fp64, so that the sum does not depend on the order in which a
    layout adds them (fp32 sums of a few million squares drift by 1e-5 to
    1e-4). Sharded (DTensor) gradients add their shards' squares over the
    processes; gradients of parameters split over the tensor axis add
    theirs over the tensor group, and those whole on it count once."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    if any(hasattr(p, "tensor_axis") for p in params):
        return _tensor_norm(params)
    if not any(hasattr(g, "device_mesh") for g in grads):
        norms = [torch.linalg.vector_norm(g, dtype=torch.float64) for g in grads]
        return torch.linalg.vector_norm(torch.stack(norms)).float()
    import torch.distributed as dist

    sharded = [g for g in grads if hasattr(g, "device_mesh")]
    sq = torch.stack([torch.linalg.vector_norm(local(g), dtype=torch.float64) ** 2
                      for g in sharded]).sum()
    dist.all_reduce(sq, group=sharded[0].device_mesh.get_group())
    # a gradient kept whole on every process counts once
    whole = [torch.linalg.vector_norm(g, dtype=torch.float64) ** 2 for g in grads
             if not hasattr(g, "device_mesh")]
    return torch.sqrt(sq + torch.stack(whole).sum() if whole else sq).float()


def _tensor_norm(params: list[torch.Tensor]) -> torch.Tensor:
    """`global_norm` where some parameters are split over the tensor axis:
    the squares of four kinds of gradient, whole, fsdp-sharded,
    tensor-split, both; the fsdp-sharded sums added over the fsdp group,
    then the tensor-split ones over the tensor group."""
    import torch.distributed as dist

    dev = local(params[0].grad).device
    # squares by kind: 2 * (tensor-split) + (fsdp-sharded)
    sums = [torch.zeros((), dtype=torch.float64, device=dev) for _ in range(4)]
    fsdp_group = tensor_group = None
    for p in params:
        g = p.grad
        dtensor, split = hasattr(g, "device_mesh"), hasattr(p, "tensor_axis")
        if dtensor:
            fsdp_group = g.device_mesh.get_group()
        if split:
            tensor_group = p.tensor_axis.group
        sums[2 * split + dtensor] = (sums[2 * split + dtensor]
                                     + torch.linalg.vector_norm(local(g), dtype=torch.float64)
                                     ** 2)
    whole, fsdp, split, both = sums
    if fsdp_group is not None:
        v = torch.stack([fsdp, both])
        dist.all_reduce(v, group=fsdp_group)
        fsdp, both = v.unbind()
    v = torch.stack([split, both])
    dist.all_reduce(v, group=tensor_group)
    return torch.sqrt(whole + fsdp + v.sum()).float()
