"""The optimizer menu on more than one process, on the CPU: lamb, lars,
novograd, adafactor and lookahead_adamw under zero1, fsdp and a tensor axis
of 2, each against the same steps in one process, and their checkpoints.

The rules' steps are compared on the same seeded whole gradients, given to
each layout's parameters as they are held (`_torch_parallel_child.py`
`seeded_grads`): the data-parallel gradients differ from one process's in
their last bits, and these rules amplify that where a gradient is near 0
(adafactor's per-row and per-column normalization, Adam's g / |g| at eps
1e-8), which no layout of the sums can avoid. Whole training steps run
under the rules in the checkpoint cases.

The rules whose statistics span a whole leaf (lamb's and lars's trust
ratio, novograd's gradient norm, adafactor's row and column means) add
their pieces over the fsdp shards and the tensor shares; lookahead's reset
runs inside the step that ZeRO-1 broadcasts. The ranks are child processes
(`tests/_torch_parallel_child.py`, torch and the port only), in two
launches of two at once; the parent takes the one-process steps meanwhile.

vlmo_debug cut to depth 2, width 128 with 2 heads (so that adafactor
factors the block kernels and the word embeddings, as at vlmo_base), 32^2
images, 12 tokens, batch 8, fp32, dropout 0: tolerances as in
tests/test_torch_port_tp.py (rtol 1e-5 on the losses, 1e-4 on the gradient
norm, 2e-6 plus 1e-5 relative on the parameters; the processes add their
sums in another order).
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_parallel_child import seeded_grads  # noqa: E402

from exploremultimodal_torch.config import load_config  # noqa: E402
from exploremultimodal_torch.train.trainer import Trainer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_torch_parallel_child.py")
ROWS = 8
TINY = [
    "model=vlmo_debug", "train=pretrain_mum", "train.datasets=[synthetic]",
    "data.synthetic_size=16", "model.img_size=32", "model.embed_dim=128",
    "model.num_heads=2", "model.max_text_len=12", "model.itc_dim=16",
    "data.num_mask_patches=2", "data.min_mask_patches_per_block=1", "data.num_workers=0",
    "train.discrete_vae_type=random", "compute_dtype=float32", "log_level=error",
    "train.loss_names=[itc,itm,mlm]", "model.attn_drop_rate=0.0", "model.drop_rate=0.0",
    "model.drop_path_rate=0.0", "train.warmup_steps=1", "train.warmup_lr=1e-3",
    "train.base_lr=1e-3", "train.clip_grad=1.0", f"data.batch_size={ROWS}",
]
RULES = ("lamb", "lars", "novograd", "adafactor", "lookahead_adamw")
PRESETS = ("zero1", "fsdp", "tp")
STEPS = {"lookahead_adamw": 6}  # lookahead syncs at the 6th update
PARAMS = ("transformer.blocks.0.attn.qkv.weight", "transformer.blocks.0.attn.q_bias",
          "transformer.blocks.1.attn.proj.weight", "transformer.blocks.1.mlp_vl.fc1.weight",
          "transformer.blocks.1.mlp_vl.fc1.bias", "transformer.blocks.1.mlp_vl.fc2.weight",
          "transformer.txt_embeddings.word_embeddings.weight", "transformer.pos_embed",
          "transformer.norm.weight", "itm_head.fc.weight", "itc_temp")
METRICS = ("total_loss", "itc_task_loss", "mlm_task_loss", "itm_task_loss")
RESUMED = (("adafactor", "fsdp"), ("adafactor", "tp"), ("lamb", "fsdp"), ("lamb", "tp"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _close(got, want, rtol=1e-5, atol=2e-6, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _close_step(got, want, before, what=""):
    """The step got - before against want - before: within 1e-5 of the
    largest element of one process's step, plus two fp32 spacings of the
    parameter (each side rounds p + du). A statistic of one shard alone
    (a trust ratio, a row mean) moves the step by far more."""
    got, want, before = (np.asarray(x, np.float64) for x in (got, want, before))
    dg, dw = got - before, want - before
    tol = 1e-5 * np.abs(dw).max() + 2 * np.spacing(np.abs(before).astype(np.float32))
    bad = np.abs(dg - dw) > tol
    assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} off, "
                           f"{dg[bad][:4]} against {dw[bad][:4]}")


def _negatives(rows: int) -> tuple:
    g = torch.Generator().manual_seed(3)
    return tuple((torch.arange(rows) + torch.randint(1, rows, (rows,), generator=g)) % rows
                 for _ in range(2))


def _spawn(tmp: str, world: int) -> list:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    return [subprocess.Popen([sys.executable, CHILD, str(port), str(r), str(world), tmp],
                             env=env, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _overrides(rule: str, preset: str | None, tmp: str, tag: str) -> list:
    # the data-parallel presets take 4 rows a process: the global batch, and
    # so the epoch's steps and the schedules, are one process's
    extra = ([] if preset is None else [f"parallel={preset}"]
             + (["data.batch_size=4"] if preset in ("zero1", "fsdp") else []))
    return TINY + extra + [f"train.opt.name={rule}", f"exp_dir={tmp}/{tag}"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("optim_ranks"))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield _run(tmp)
    finally:
        torch.set_num_threads(n_threads)


def _run(tmp: str) -> dict:
    one = Trainer(load_config(_overrides("lamb", None, tmp, "w")), device="cpu")
    batch = next(one.loader.epoch(0))
    weights = {k: v.clone() for k, v in one.task.state_dict().items()}
    negatives = _negatives(ROWS)
    common = {"weights": "w", "batch": "b", "negatives": True, "params": PARAMS}
    launches: dict[str, dict] = {"a": {}, "b": {}}
    for preset in PRESETS:
        for rule in RULES:
            where = launches["a" if preset == "fsdp" else "b"]
            where[f"{preset}_{rule}"] = {
                **common, "overrides": _overrides(rule, preset, tmp, f"{preset}_{rule}"),
                "inject": STEPS.get(rule, 2)}
            if (rule, preset) in RESUMED:
                where[f"{preset}_{rule}_steps"] = {
                    **common, "overrides": _overrides(rule, preset, tmp, f"s_{preset}_{rule}"),
                    "steps": 2, "save": f"{tmp}/ckpt_{preset}_{rule}", "save_after": 1}
    for rule, preset in RESUMED:
        launches["a" if preset == "fsdp" else "b"][f"{preset}_{rule}_resumed"] = {
            **common, "overrides": _overrides(rule, preset, tmp, f"r_{preset}_{rule}"),
            "steps": 1, "resume": f"{tmp}/ckpt_{preset}_{rule}"}
    # lamb's run reading adafactor's checkpoint
    launches["a"]["fsdp_lamb_reads_adafactor"] = {
        **common, "overrides": _overrides("lamb", "fsdp", tmp, "x"),
        "load_raises": f"{tmp}/ckpt_fsdp_adafactor"}
    shapes = {n: tuple(p.shape) for n, p in one.task.named_parameters() if p.requires_grad}
    inputs = {"weights": {"w": weights}, "batch_rows": ROWS, "batches": {"b": batch},
              "negatives": negatives, "grad_shapes": shapes}
    dirs = {key: f"{tmp}/{key}" for key in launches}
    for key, cases in launches.items():
        os.makedirs(dirs[key])
        torch.save({**inputs, "cases": cases}, os.path.join(dirs[key], "in.pt"))
    t0 = time.perf_counter()
    procs = {key: _spawn(dirs[key], 2) for key in launches}
    out = {"one": {}, "before": {k: weights[k].clone() for k in PARAMS}}
    try:
        for rule in RULES:
            tr = Trainer(load_config(_overrides(rule, None, tmp, f"one_{rule}")), device="cpu")
            tr.task.load_state_dict(weights)
            opt = tr.state.optimizer
            named = dict(tr.task.named_parameters())
            for i in range(STEPS.get(rule, 2)):
                opt.zero_grad()
                for name, g in seeded_grads(shapes, i).items():
                    named[name].grad = g
                opt.step(i)
            sd = tr.task.state_dict()
            out["one"][rule] = {k: sd[k].clone() for k in PARAMS}
        logs = {key: [p.communicate(timeout=240)[0] for p in ps] for key, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
    out["child_s"] = time.perf_counter() - t0
    for key, ps in procs.items():
        for rank, (p, log) in enumerate(zip(ps, logs[key])):
            assert p.returncode == 0, f"{key} rank {rank} failed:\n{log[-4000:]}"
    out["tmp"] = tmp
    out["ranks"] = [{**torch.load(os.path.join(dirs["a"], f"out_{r}.pt"), weights_only=False),
                     **torch.load(os.path.join(dirs["b"], f"out_{r}.pt"), weights_only=False)}
                    for r in range(2)]
    return out


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("rule", RULES)
def test_rule_on_two_ranks_equals_one_process(run, rule, preset):
    """The rule's steps (2, or 6 under lookahead, with the global norm
    clip) on each layout's parameters from the same weights and the same
    seeded whole gradients: the whole parameters after (gathered on rank
    0) equal the one process's, and so does their change from the weights
    (`_close_step`)."""
    case = f"{preset}_{rule}"
    assert run["ranks"][1][case]["mesh"][2] == preset
    for k in PARAMS:
        got = run["ranks"][0][case]["params"][k]
        _close(got, run["one"][rule][k], what=f"{case} {k}")
        _close_step(got, run["one"][rule][k], run["before"][k], what=f"{case} {k}")


@pytest.mark.parametrize("rule,preset", RESUMED)
def test_checkpoint_resumes_bit_for_bit(run, rule, preset):
    """Two training steps of the rule on two ranks (the losses the same on
    both); a checkpoint saved after the first, read by a new pair of ranks
    of the same layout, which take the second step: its losses and its
    parameters equal the uninterrupted run's, bit for bit."""
    straight = run["ranks"][0][f"{preset}_{rule}_steps"]
    for k in METRICS:
        assert float(straight["metrics_1"][k]) == float(run["ranks"][1][f"{preset}_{rule}_steps"]
                                                         ["metrics_1"][k]), k
    resumed = run["ranks"][0][f"{preset}_{rule}_resumed"]
    for k in METRICS + ("grad_norm",):
        assert float(resumed["metrics_0"][k]) == float(straight["metrics_1"][k]), k
    for k in PARAMS:
        assert torch.equal(resumed["params"][k], straight["params"][k]), k


@pytest.mark.parametrize("rule,preset", RESUMED)
def test_checkpoint_of_two_ranks_reads_in_one_process(run, rule, preset):
    """The two ranks' checkpoint (rank 0's whole layout: fsdp shards and
    tensor shares gathered, adafactor's factored statistics whole already)
    read by one process: its parameters and every state entry of the rule,
    gathered back, are the file's, bit for bit."""
    from exploremultimodal_torch.train import checkpoints as ckpt_lib

    path = os.path.join(run["tmp"], f"ckpt_{preset}_{rule}")
    tr = Trainer(load_config(_overrides(rule, None, run["tmp"], f"l_{preset}_{rule}")),
                 device="cpu")
    assert ckpt_lib.auto_load(path, tr.state, tr.cfg) is not None and tr.state.step == 1
    sd, _ = ckpt_lib.read_checkpoint(os.path.join(path, "checkpoint-0"))
    got = tr.state.optimizer.full_state_dict()
    assert got["rule"] == sd["optimizer"]["rule"] == rule
    assert got["state"].keys() == sd["optimizer"]["state"].keys()
    for i, st in sd["optimizer"]["state"].items():
        assert got["state"][i].keys() == st.keys()
        for key, v in st.items():
            assert torch.equal(got["state"][i][key], v), (i, key)
    named = dict(tr.task.named_parameters())
    for k in PARAMS:
        assert torch.equal(named[k].detach(), sd["model"][k]), k


@pytest.mark.parametrize("rule", ["adafactor", "novograd", "lookahead_lamb"])
def test_offload_parks_every_state_tensor(rule, tmp_path):
    """fsdp_offload's parking with a rule's state (one process): after each
    step every state tensor but the step count is parked (a host copy
    in the state, restored around the update), and two steps equal the
    steps without parking, bit for bit."""
    overrides = _overrides(rule, None, str(tmp_path), "p")
    results = []
    for offload in (False, True):
        tr = Trainer(load_config(overrides), device="cpu")
        opt = tr.state.optimizer
        opt.offload = offload
        named = dict(tr.task.named_parameters())
        shapes = {n: tuple(p.shape) for n, p in named.items() if p.requires_grad}
        for i in range(2):
            opt.zero_grad()
            for name, g in seeded_grads(shapes, i).items():
                named[name].grad = g
            opt.step(i)
            if offload:
                entries = [(k, v) for st in opt.torch.state.values() for k, v in st.items()
                           if isinstance(v, torch.Tensor) and k != "step"]
                assert len(opt._parked) == len(entries) > 0
        results.append({k: p.detach().clone() for k, p in named.items()})
    for k, v in results[0].items():
        assert torch.equal(v, results[1][k]), k


def test_another_rules_checkpoint_raises(run):
    """lamb's run reading adafactor's checkpoint raises ValueError naming
    both rules, on every rank."""
    for rank in run["ranks"]:
        err = rank["fsdp_lamb_reads_adafactor"]["load_error"]
        assert err is not None and "'adafactor'" in err and "'lamb'" in err


def test_the_module_runs_its_ranks_within_budget(run):
    assert run["child_s"] < 120
