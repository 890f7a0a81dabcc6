"""One rank of the port's multi-process CPU tests (tests/test_torch_port_parallel.py,
tests/test_torch_port_tp.py).

    python tests/_torch_parallel_child.py <port> <rank> <world> <workdir>

Starts a gloo group through `runtime.coordinator_address`, reads the
parent's inputs from `<workdir>/in.pt` (the global batch, the ITM
negatives, the weights, the configs of the cases) and, before the first
case that needs JAX's weights, `<workdir>/in_jax.pt`, which the parent
writes while the ranks run; runs every case on its share of the batch
(by its data coordinate: tensor peers take the same rows), and writes what
each gave to `<workdir>/out_<rank>.pt`.
Imports torch and the port only.
"""

import contextlib
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from exploremultimodal_torch.config import load_config  # noqa: E402
from exploremultimodal_torch.models.convert import load_flax_train_state  # noqa: E402
from exploremultimodal_torch.parallel import (  # noqa: E402
    all_gather_with_grad,
    concat_all_gather,
    global_sum,
    initialize_runtime,
)
from exploremultimodal_torch.parallel.partitioning import (  # noqa: E402
    full,
    gather_tensor,
    like,
    shard_tensor,
    tensor_split,
)
from exploremultimodal_torch.train import checkpoints as ckpt_lib  # noqa: E402
from exploremultimodal_torch.train.trainer import Trainer  # noqa: E402
from exploremultimodal_torch.utils.metrics import SmoothedValue  # noqa: E402


def rows_of(batch: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in batch.items()}


def collectives(rank: int, world: int) -> dict:
    out = {}
    group = dist.group.WORLD
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 100 * rank
    out["gather"] = all_gather_with_grad(x, group, roll_local_first=False)
    out["rolled"] = all_gather_with_grad(x, group, roll_local_first=True)
    out["const"] = concat_all_gather(x, group)
    # the gradient of one global loss over the gathered rows, each rank
    # holding its rows (the parent holds it against dense autodiff)
    g = torch.Generator().manual_seed(0)
    full = torch.randn(4 * world, 3, generator=g)
    w = torch.randn(4 * world, 3, generator=g)
    mine = full[4 * rank:4 * (rank + 1)].clone().requires_grad_()
    loss = global_sum((torch.tanh(all_gather_with_grad(mine, group, False)) * w).sum()
                      / world, group)
    loss.backward()
    out["vjp"] = mine.grad
    mine2 = full[4 * rank:4 * (rank + 1)].clone().requires_grad_()
    concat_all_gather(mine2, group).sum()
    out["const_requires_grad"] = torch.tensor(concat_all_gather(mine2, group).requires_grad)
    v = SmoothedValue()
    for value in range(rank, rank + 3):
        v.update(torch.tensor(float(value)), n=rank + 1)
    v.synchronize_between_processes()
    out["meter"] = torch.tensor([v.count, v.total], dtype=torch.float64)
    return out


def step_case(case: dict, inputs: dict, rank: int, world: int) -> dict:
    cfg = load_config(case["overrides"])
    tr = Trainer(cfg, device="cpu")
    if case.get("park"):
        # fsdp_offload parks the moments only on CUDA; here too, to run it
        tr.state.optimizer.offload = True
    if case["weights"] is not None:
        ckpt_lib.load_model_state_dict(tr.task, inputs["weights"][case["weights"]])
        if tr.state.ema_task is not None:
            ckpt_lib.load_model_state_dict(tr.state.ema_task,
                                           inputs["weights"][case["weights"]])
    if case.get("flax"):
        load_flax_train_state(tr.state, inputs["flax"][case["flax"]])
    # this process's rows: its data coordinate's share (tensor peers, which
    # split the blocks, take the same rows)
    d, size = tr.mesh.data_rank, tr.mesh.data_size
    per = inputs["batch_rows"] // size
    batch = (None if case["batch"] is None else
             rows_of(inputs["batches"][case["batch"]], d * per, (d + 1) * per))
    negatives = None
    if case.get("negatives"):
        given = inputs["negatives"] if case["negatives"] is True else case["negatives"]
        # per microbatch under accumulation: indices into its candidates
        per_neg = given[0].shape[0] // size
        negatives = tuple(n[d * per_neg:(d + 1) * per_neg] for n in given)
    out = {"mesh": (tr.mesh.data_rank, tr.mesh.tensor_rank, tr.preset)}
    if case.get("resume"):
        # a checkpoint of this layout, taken mid-run: the steps go on from it
        ckpt_lib.auto_load(case["resume"], tr.state, cfg)
    if case.get("load_raises"):
        # a checkpoint of another optimizer rule
        try:
            ckpt_lib.auto_load(case["load_raises"], tr.state, cfg)
            out["load_error"] = None
        except ValueError as e:
            out["load_error"] = str(e)
        return out
    if case.get("inject"):
        # the optimizer alone, on seeded whole gradients given to each
        # parameter as it is held (its tensor share, then its fsdp shard)
        opt = tr.state.optimizer
        for i in range(case["inject"]):
            opt.zero_grad()
            whole = seeded_grads(inputs["grad_shapes"], i)
            for name, p in tr.task.named_parameters():
                if p.requires_grad:
                    p.grad = held_like(p, whole[name])
            opt.step(i)
    if case.get("logits"):
        with torch.no_grad():
            _, _, extra = tr.eval_step(batch, torch.Generator().manual_seed(0))
        out["logits"] = extra["vqa_logits"].detach().float().clone()
    codes = CodeRecorder() if case.get("record") else contextlib.nullcontext([])
    with codes as records:
        for i in range(0 if case.get("inject") else case.get("steps", 1)):
            m = tr.step(batch, negatives=negatives)
            out[f"metrics_{i}"] = {k: v.detach().clone() for k, v in m.items()}
            if case.get("save_after") == i + 1:
                out["saved"] = ckpt_lib.save(case["save"], tr.state, cfg, 0)
    if case.get("record"):
        out["codes"] = records
    if case.get("grads"):
        out["grads"] = whole_grads(tr.task, case["grads"])
    if case["params"]:
        full = ckpt_lib.model_state_dict(tr.task)
        out["params"] = {k: full[k] for k in case["params"]} if rank == 0 else {}
    if case.get("whole_params"):
        # the parameters each rank holds whole on the tensor axis, as held
        out["whole_params"] = {k: v.clone() for k, v in tr.task.state_dict().items()
                               if tensor_split(k) is None}
    if tr.state.img_queue is not None:
        out["queue"] = tr.state.img_queue.clone()
        out["queue_ptr"] = torch.tensor(tr.state.queue_ptr)
    if case.get("save") and not case.get("save_after"):
        path = ckpt_lib.save(case["save"], tr.state, cfg, 0)
        out["saved"] = path
    if case.get("load"):
        restored = ckpt_lib.auto_load(case["load"], tr.state, cfg)
        full = ckpt_lib.model_state_dict(tr.task)
        out["loaded_epoch"] = torch.tensor(restored[1])
        out["loaded"] = {k: full[k] for k in case["params"]} if rank == 0 else {}
        out["loaded_step"] = torch.tensor(tr.state.step)
        sd = tr.state.optimizer.full_state_dict()
        if rank == 0:
            out["loaded_moments"] = sd["state"][0]["exp_avg"]
            out["loaded_optimizer"] = sd
    if case.get("submit"):
        from exploremultimodal_torch.train.phases import write_vqa_submission

        tr.output_dir = case["submit"]
        out["submission"] = write_vqa_submission(tr)
    return out


class CodeRecorder:
    """A context that records, in call order, every int8 code tensor and
    scale the quantizers give (`quant_fused.row_quant`,
    `quant_fused.quantize_weights`, `quant._quantize_int8`), as (name,
    codes, scale); a call whose result equals the one before is recorded
    once (the split MLP's second pass quantizes x again)."""

    def __enter__(self) -> list:
        from exploremultimodal_torch.ops import quant, quant_fused

        self.records: list = []
        self.saved = [(quant_fused, "row_quant"), (quant_fused, "quantize_weights"),
                      (quant, "_quantize_int8")]
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.saved]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._wrap(name, fn))
        return self.records

    def _wrap(self, name, fn):
        def recorded(*args, **kwargs):
            q, s = fn(*args, **kwargs)
            rec = (name, q.detach().clone(), s.detach().float().reshape(-1).clone())
            last = self.records[-1] if self.records else None
            if not (last and last[0] == name and last[1].shape == q.shape
                    and torch.equal(last[1], rec[1]) and torch.equal(last[2], rec[2])):
                self.records.append(rec)
            return q, s
        return recorded

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def whole_grads(task, names) -> dict:
    """The gradients of the parameters `names` whole: gathered from their
    fsdp shards, then over the tensor axis (every process must call)."""
    named = dict(task.named_parameters())
    out = {}
    for name in names:
        p = named[name]
        g = full(p.grad)
        axis = getattr(p, "tensor_axis", None)
        if axis is not None:
            parts = [torch.empty_like(g) for _ in range(axis.size)]
            dist.all_gather(parts, g.contiguous(), group=axis.group)
            g = gather_tensor(parts, p.tensor_split)
        out[name] = g.detach().clone()
    return out


def seeded_grads(shapes: dict, step: int) -> dict:
    """Whole gradients of `shapes` (by torch name, in name order) drawn
    from a seed of the step: N(0, 0.01^2), the same in every process."""
    g = torch.Generator().manual_seed(1000 + step)
    return {name: torch.randn(shapes[name], generator=g) * 0.01 for name in sorted(shapes)}


def held_like(p: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """A whole tensor as parameter p is held: its tensor share, then its
    fsdp shard."""
    axis = getattr(p, "tensor_axis", None)
    if axis is not None:
        whole = shard_tensor(whole, p.tensor_split, axis.rank, axis.size)
    return like(p, whole)


def wait_for(path: str, timeout: float = 180.0) -> dict:
    """The parent's second file (JAX's weights), once it is there."""
    end = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(path)
        time.sleep(0.05)
    return {**torch.load(path, weights_only=False), "jax": True}


def main() -> int:
    port, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    inputs = torch.load(os.path.join(workdir, "in.pt"), weights_only=False)
    results = {}
    base = [f"runtime.coordinator_address=localhost:{port}", f"runtime.num_processes={world}",
            f"runtime.process_id={rank}"]
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    try:
        initialize_runtime(load_config(base), "cpu")
        for name, case in inputs["cases"].items():
            if case.get("jax") and "jax" not in inputs:
                inputs.update(wait_for(os.path.join(workdir, "in_jax.pt")))
            case = {**case, "overrides": case["overrides"] + base}
            if case.get("raises"):
                try:
                    Trainer(load_config(case["overrides"]), device="cpu")
                    results[name] = {"raised": None}
                except (ValueError, NotImplementedError) as e:
                    results[name] = {"raised": str(e), "type": type(e).__name__}
                continue
            results[name] = step_case(case, inputs, rank, world)
        results["collectives"] = collectives(rank, world)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        torch.save(results, os.path.join(workdir, f"out_{rank}.pt"))
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
