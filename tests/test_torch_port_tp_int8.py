"""int8 (W8A8) under tensor parallelism in the port, on the CPU: every
`model.quantize` mode at `parallel=tp` on two gloo ranks, and `w8a8_pallas`
at (fsdp 2, tensor 2) on four, against one process; and rows 8-10's plain
split versions against their whole ones.

The split gives each site the whole call's int8 codes and scales, as
JAX's GSPMD does: qkv and fc1 are column-parallel (their rows and scales
whole on each rank); proj and fc2 are row-parallel, with each activation
row's (or, under `w8a8`, the whole tensor's) absmax and each weight
channel's maxed over the tensor group, and fp32 partial outputs added
before the bias and one rounding; the int8 MLP quantizes its hidden's rows
at their absmax over the whole hidden (rows 9 and 10's split mode: two
launches with an all-reduce-max between).

The ranks are child processes (`tests/_torch_parallel_child.py`, torch and
the port only) that record every code and scale their quantizers give
(`CodeRecorder`); the parent records the one process's. finetune_vqa at
vlmo_debug cut to width 32, 2 heads, MLP hidden 128, fp32, with the tp
test's settings (AdamW eps 1, so the step follows the gradients
continuously): every dropout on at two ranks (the masks are the one
process's by construction), attention dropout only at four (each data
coordinate draws its own hidden dropout, as JAX's processes do).
Tolerances: codes and scales bit for bit; losses and logits within 1e-5
relative (the ranks add their fp32 partial sums in another order);
gradients within 1e-4 relative L2; parameters as tests/test_torch_port_tp.py.
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
from _torch_parallel_child import CodeRecorder  # noqa: E402

from exploremultimodal_torch.config import load_config  # noqa: E402
from exploremultimodal_torch.ops import quant_fused as qf  # noqa: E402
from exploremultimodal_torch.parallel.partitioning import gather_tensor  # noqa: E402
from exploremultimodal_torch.train.trainer import Trainer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_torch_parallel_child.py")
ROWS = 4
VQA = [
    "model=vlmo_debug", "train=finetune_vqa", "train.datasets=[synthetic]",
    "data.synthetic_size=12", "model.img_size=32", "model.embed_dim=32",
    "model.num_heads=2", "model.max_text_len=12", "data.num_workers=0",
    "compute_dtype=float32", "log_level=error", "train.opt.eps=1.0",
    "train.warmup_steps=1", "train.warmup_lr=1e-2", "train.base_lr=1e-2",
    "attn_impl=pallas", "model.attn_drop_rate=0.1",
]
ALL_DROP = ["model.drop_rate=0.1", "model.drop_path_rate=0.1"]
NO_HIDDEN_DROP = ["model.drop_rate=0.0", "model.drop_path_rate=0.0"]
MODES = ("w8a8", "w8a8_pallas", "w8a8_pallas_mlp", "w8a8_pallas_noproj")
FSDP_TENSOR = ["runtime.mesh.data=1", "runtime.mesh.fsdp=2", "runtime.mesh.tensor=2"]
GRADS = ("transformer.blocks.0.attn.qkv.weight", "transformer.blocks.1.attn.proj.weight",
         "transformer.blocks.1.mlp_vl.fc1.weight", "transformer.blocks.1.mlp_vl.fc2.weight",
         "transformer.blocks.0.mlp_l.fc1.bias", "transformer.blocks.1.attn.proj.bias",
         "transformer.blocks.1.mlp_vl.fc2.bias", "vqa_classifier.fc1.weight")
PARAMS = GRADS[:4] + ("vqa_classifier.fc1.weight",)
METRICS = ("total_loss", "vqa_task_loss", "vqa_mean_score")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _close(got, want, rtol=1e-5, atol=2e-6, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _spawn(tmp: str, world: int) -> list:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    return [subprocess.Popen([sys.executable, CHILD, str(port), str(r), str(world), tmp],
                             env=env, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _one(overrides, weights, batch, tmp):
    """One process: the logits of an eval forward, then one recorded step;
    its metrics, codes, gradients and parameters."""
    tr = Trainer(load_config(overrides + [f"exp_dir={tmp}"]), device="cpu")
    tr.task.load_state_dict(weights)
    with torch.no_grad():
        _, _, extra = tr.eval_step(batch, torch.Generator().manual_seed(0))
    with CodeRecorder() as codes:
        metrics = tr.step(batch)
    named = dict(tr.task.named_parameters())
    sd = tr.task.state_dict()
    return {"logits": extra["vqa_logits"].float(), "metrics": metrics, "codes": codes,
            "grads": {k: named[k].grad.clone() for k in GRADS},
            "params": {k: sd[k].clone() for k in PARAMS}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_int8"))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield _run(tmp)
    finally:
        torch.set_num_threads(n_threads)


def _run(tmp: str) -> dict:
    first = Trainer(load_config(VQA + ALL_DROP + [f"data.batch_size={ROWS}",
                                                  f"exp_dir={tmp}/w"]), device="cpu")
    batch = next(first.loader.epoch(0))
    weights = {k: v.clone() for k, v in first.task.state_dict().items()}
    common = {"weights": "w", "batch": "b", "params": PARAMS, "logits": True,
              "record": True, "grads": GRADS}
    two = {mode: {**common, "overrides": VQA + ALL_DROP + [
        f"model.quantize={mode}", "parallel=tp", f"data.batch_size={ROWS}",
        f"exp_dir={tmp}/{mode}"]} for mode in MODES}
    four = {"fsdp_tensor": {**common, "overrides": VQA + NO_HIDDEN_DROP + FSDP_TENSOR + [
        "model.quantize=w8a8_pallas", "parallel=tp", f"data.batch_size={ROWS // 2}",
        f"exp_dir={tmp}/ft"]}}
    inputs = {"weights": {"w": weights}, "batch_rows": ROWS, "batches": {"b": batch}}
    dirs = {"two": f"{tmp}/two", "four": f"{tmp}/four"}
    for key, cases in (("two", two), ("four", four)):
        os.makedirs(dirs[key])
        torch.save({**inputs, "cases": cases}, os.path.join(dirs[key], "in.pt"))
    t0 = time.perf_counter()
    procs = {"two": _spawn(dirs["two"], 2), "four": _spawn(dirs["four"], 4)}
    out = {"one": {}}
    try:
        for mode in MODES:
            out["one"][mode] = _one(VQA + ALL_DROP + [f"model.quantize={mode}",
                                                      f"data.batch_size={ROWS}"],
                                    weights, batch, f"{tmp}/one_{mode}")
        out["one"]["fsdp_tensor"] = _one(VQA + NO_HIDDEN_DROP + [
            "model.quantize=w8a8_pallas", f"data.batch_size={ROWS}"], weights, batch,
            f"{tmp}/one_ft")
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
    out["two"] = [torch.load(os.path.join(dirs["two"], f"out_{r}.pt"), weights_only=False)
                  for r in range(2)]
    out["four"] = [torch.load(os.path.join(dirs["four"], f"out_{r}.pt"), weights_only=False)
                   for r in range(4)]
    return out


def _combine(whole: torch.Tensor, parts: list[torch.Tensor]) -> bool:
    """Whether the tensor ranks' `parts` are `whole`'s shares: equal to it
    (held whole), its last axis, rows or columns in rank order, or qkv's
    head split."""
    if all(p.shape == whole.shape for p in parts):
        return all(torch.equal(p, whole) for p in parts)
    if torch.cat(parts, -1).shape == whole.shape and torch.equal(torch.cat(parts, -1), whole):
        return True  # an activation's K, its last axis
    for how in ("rows", "cols", "qkv"):
        try:
            if torch.equal(gather_tensor(parts, how), whole):
                return True
        except (RuntimeError, IndexError):  # shapes that do not split so
            pass
    return False


def _codes_match(want: list, grid: list[list[list]]):
    """Each record of one process against the ranks' (grid[d][t]: data
    coordinate d, tensor rank t): its codes and scales the tensor ranks'
    shares of the data coordinate's, and those the data coordinates' rows
    (or, for weights, equal on each)."""
    assert want
    for ranks in (r for row in grid for r in row):
        assert len(ranks) == len(want), (len(ranks), len(want))
    for i, (name, q, s) in enumerate(want):
        for field, whole in ((1, q), (2, s)):
            per_data = []
            for row in grid:
                parts = [ranks[i][field] for ranks in row]
                assert all(ranks[i][0] == name for ranks in row), (i, name)
                per_data.append(parts)
            if len(per_data) == 1:
                ok = _combine(whole, per_data[0])
            else:  # the data coordinates' rows, each a tensor split
                halves = whole.chunk(len(per_data), 0)
                ok = (all(_combine(whole, parts) for parts in per_data)
                      or all(_combine(h, parts) for h, parts in zip(halves, per_data)))
            assert ok, f"record {i} ({name}) field {field}: {tuple(whole.shape)}"


@pytest.mark.parametrize("mode", MODES)
def test_int8_tp_codes_are_one_processs(run, mode):
    """Every int8 code and scale of the step's forward on each tensor rank
    is its share of the one process's, bit for bit."""
    _codes_match(run["one"][mode]["codes"], [[rank[mode]["codes"] for rank in run["two"]]])


@pytest.mark.parametrize("mode", MODES)
def test_int8_tp_logits_and_step_equal_one_process(run, mode):
    """An eval forward's VQA logits, the step's losses, its gradients and
    the parameters after it on two tensor ranks, every dropout on, equal
    the one process's."""
    want = run["one"][mode]
    for rank in run["two"]:
        got = rank[mode]
        assert got["mesh"] == (0, got["mesh"][1], "tp")
        _close(got["logits"], want["logits"], what=f"{mode} logits")
        for k in METRICS:
            _close(got["metrics_0"][k], want["metrics"][k], what=f"{mode} {k}")
        _close(got["metrics_0"]["grad_norm"], want["metrics"]["grad_norm"], rtol=1e-4)
    for k in GRADS:
        g, w = run["two"][0][mode]["grads"][k], want["grads"][k]
        assert float((g - w).norm() / w.norm()) < 1e-4, (mode, k)
    for k in PARAMS:
        _close(run["two"][0][mode]["params"][k], want["params"][k], what=f"{mode} {k}")


def test_w8a8_pallas_at_fsdp_and_tensor_equals_one_process(run):
    """`w8a8_pallas` at (fsdp 2, tensor 2), attention dropout on: each data
    coordinate's codes are its rows' share of the one process's (the
    weights' the same on both), and the logits, losses, gradients and
    parameters equal the one process's on the 4 rows."""
    ranks = [rank["fsdp_tensor"] for rank in run["four"]]
    want = run["one"]["fsdp_tensor"]
    _codes_match(want["codes"], [[ranks[0]["codes"], ranks[1]["codes"]],
                                 [ranks[2]["codes"], ranks[3]["codes"]]])
    _close(torch.cat([ranks[0]["logits"], ranks[2]["logits"]]), want["logits"], what="logits")
    for rank in ranks:
        for k in METRICS:
            _close(rank["metrics_0"][k], want["metrics"][k], what=k)
    for k in GRADS:
        g, w = ranks[0]["grads"][k], want["grads"][k]
        assert float((g - w).norm() / w.norm()) < 1e-4, k
    for k in PARAMS:
        _close(ranks[0]["params"][k], want["params"][k], what=k)


# ------------------------------------------- rows 8-10: the split modes


def _mlp_inputs(m=12, k=32, hidden=128, seed=7):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g)
    w1, w2 = torch.randn(hidden, k, generator=g) * 0.2, torch.randn(k, hidden, generator=g) * 0.2
    b1, b2 = torch.randn(hidden, generator=g) * 0.1, torch.randn(k, generator=g) * 0.1
    bits = torch.randint(-32768, 32768, (m, hidden), generator=g, dtype=torch.int16)
    return x, w1, b1, w2, b2, bits


def test_plain_row8_partial_summed_is_the_whole():
    """Row 8 on proj's row-parallel shares (K/2 columns of x and qw, x's
    rows at their absmax over the whole K, the weight's channels at theirs):
    each share's codes are the whole call's columns, and the fp32 partial
    products summed are the whole product (fp32: to the order of the sums);
    on qkv's column share (N/2 of each of q, k, v) the whole call's columns
    bit for bit."""
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(10, 64, generator=g), torch.randn(48, 64, generator=g) * 0.1
    qw, sw = qf.quantize_weights(w)
    whole = qf.w8a8_matmul_plain(x, qw, sw)
    amax = x.abs().amax(1)
    wmax = torch.maximum(w[:, :32].abs().amax(1), w[:, 32:].abs().amax(1))
    parts = []
    for cols in (slice(0, 32), slice(32, 64)):
        qw_t, sw_t = qf.quantize_weights(w[:, cols], wmax)
        assert torch.equal(qw_t, qw[:, cols]) and torch.equal(sw_t, sw)
        qx_t, _ = qf.row_quant(x[:, cols], amax)
        assert torch.equal(qx_t, qf.row_quant(x)[0][:, cols])
        part = qf.w8a8_matmul_partial_plain(x[:, cols], qw_t, sw_t, amax)
        assert part.dtype == torch.float32
        parts.append(part)
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=1e-6, atol=1e-6)
    rows = torch.cat([torch.arange(j * 16, j * 16 + 8) for j in range(3)])
    assert torch.equal(qf.w8a8_matmul_plain(x, *qf.quantize_weights(w[rows])),
                       whole[:, rows])


@pytest.mark.parametrize("drop", [False, True])
def test_plain_rows_9_and_10_split_summed_is_the_whole(drop):
    """Rows 9 and 10's split mode on two hidden shares: the first pass's
    row absmax of each share, maxed, is the whole hidden's; the second
    pass's codes of h at it are the whole call's columns; the fp32 partial
    outputs plus b2, rounded once, are the whole MLP (fp32: to the order of
    the sums); the split wrappers with an all-reduce-max stand-in give the
    same."""
    x, w1, b1, w2, b2, bits = _mlp_inputs()
    thr = 6554 if drop else 0
    bits = bits if drop else None
    qw1, sw1 = qf.quantize_weights(w1)
    qw2, sw2 = qf.quantize_weights(w2)
    extra = (bits, thr) if drop else ()
    whole = (qf.w8a8_mlp_fwd_drop_plain if drop else qf.w8a8_mlp_fwd_plain)(
        x, qw1, sw1, b1, qw2, sw2, b2, *extra)
    h = qf._mlp_hidden(x, qw1, sw1, b1, bits, thr)
    shares = [slice(0, 64), slice(64, 128)]
    amaxes = [qf.w8a8_mlp_amax_plain(x, qw1[c], sw1[c], b1[c],
                                     None if bits is None else bits[:, c], thr) for c in shares]
    amax = torch.maximum(*amaxes)
    assert torch.equal(amax, h.abs().amax(1))
    wmax = torch.maximum(w2[:, :64].abs().amax(1), w2[:, 64:].abs().amax(1))
    parts = []
    for c in shares:
        qw2_t, sw2_t = qf.quantize_weights(w2[:, c], wmax)
        assert torch.equal(qw2_t, qw2[:, c]) and torch.equal(sw2_t, sw2)
        assert torch.equal(qf.row_quant(h[:, c], amax)[0], qf.row_quant(h)[0][:, c])
        b = None if bits is None else bits[:, c]
        part = qf.w8a8_mlp_partial_plain(x, qw1[c], sw1[c], b1[c], qw2_t, sw2_t, amax, b, thr)
        split = (qf.w8a8_mlp_fwd_drop_split(x, qw1[c], sw1[c], b1[c], qw2_t, sw2_t, b, thr,
                                            lambda a: a.copy_(amax)) if drop else
                 qf.w8a8_mlp_fwd_split(x, qw1[c], sw1[c], b1[c], qw2_t, sw2_t,
                                       lambda a: a.copy_(amax)))
        assert torch.equal(split, part)
        parts.append(part)
    torch.testing.assert_close(parts[0] + parts[1] + b2, whole, rtol=1e-6, atol=1e-6)


# ------------------------------- the split wrappers on the card's route


def _fake_card(monkeypatch, launches):
    """The wrappers' card route with a fake loader (meta tensors, as
    tests/test_torch_port_sm90_host.py drives it): each launch's symbol and
    arguments recorded, every encoder a no-op."""
    import types

    def fake_load(name, argtypes, symbol=None):
        if symbol is not None and symbol.endswith("_encode"):
            return lambda *a: 0
        return lambda *a: launches.append((symbol, len(argtypes), a)) or 0

    monkeypatch.setattr(qf._build, "load", fake_load)
    monkeypatch.setattr(qf, "_MAPS", {})
    monkeypatch.setattr(qf, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(qf.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))


def test_row8_partial_launch_and_checks(monkeypatch):
    """Row 8's partial mode on the card's route: the `_partial` entry with
    qw's map, x, sw, the rows' absmax and an fp32 y (M, 768), the width
    (K 384: proj's row share at a tensor axis of 2), the grid of
    `matmul_grid`, one launch counted; an x, qw, sw or amax whose shape
    disagrees with the others raises ValueError."""
    launches = []
    _fake_card(monkeypatch, launches)
    m = 6304
    x = torch.empty(m, 384, dtype=torch.bfloat16, device="meta")
    qw = torch.empty(768, 384, dtype=torch.int8, device="meta")
    sw, amax = torch.empty(768, device="meta"), torch.empty(m, device="meta")
    before = qf.w8a8_matmul_partial.launches
    y = qf.w8a8_matmul_partial(x, qw, sw, amax)
    assert y.shape == (m, 768) and y.dtype == torch.float32
    assert qf.w8a8_matmul_partial.launches - before == 1
    symbol, nargs, args = launches[-1]
    grid_x, _, per = qf.matmul_grid(m, 768, 132)
    assert symbol == "w8a8_matmul_sm90_partial" and nargs == len(args) == 11
    assert args[1:] == (x.data_ptr(), sw.data_ptr(), amax.data_ptr(), y.data_ptr(), m, 768,
                        384, grid_x, per, 0)
    for bad in ((torch.empty(m, 768, dtype=torch.bfloat16, device="meta"), qw, sw, amax),
                (x, torch.empty(2304, 384, dtype=torch.int8, device="meta"), sw, amax),
                (x, qw, sw, torch.empty(m - 1, device="meta"))):
        with pytest.raises(ValueError):
            qf.w8a8_matmul_partial(*bad)


@pytest.mark.parametrize("m,drop", [(1280, False), (7584, True)])
def test_rows_9_10_split_launch_two_entries_around_the_reduce(monkeypatch, m, drop):
    """Rows 9 and 10's split mode on the card's route: the `_amax` entry,
    then the caller's reduce on the absmax it wrote, then the `_partial`
    entry on the same absmax, into an fp32 y (M, 768), with the whole
    kernel's argument list (the absmax where b2 is) and hidden split; one
    call counted."""
    launches, reduced = [], []
    _fake_card(monkeypatch, launches)
    h = 1536
    x = torch.empty(m, 768, dtype=torch.bfloat16, device="meta")
    args = (x, torch.empty(h, 768, dtype=torch.int8, device="meta"),
            torch.empty(h, device="meta"), torch.empty(h, device="meta"),
            torch.empty(768, h, dtype=torch.int8, device="meta"), torch.empty(768, device="meta"))

    def reduce_max(a):
        reduced.append((len(launches), a.shape))
        return a

    fn = qf.w8a8_mlp_fwd_drop_split if drop else qf.w8a8_mlp_fwd_split
    before = fn.launches
    if drop:
        y = fn(*args, torch.empty(m, h, dtype=torch.int16, device="meta"), 6554, reduce_max)
    else:
        y = fn(*args, reduce_max)
    assert y.shape == (m, 768) and y.dtype == torch.float32 and fn.launches - before == 1
    suffix = "_drop" if drop else ""
    assert [s for s, _, _ in launches] == [f"w8a8_mlp_sm90_amax{suffix}",
                                           f"w8a8_mlp_sm90_partial{suffix}"]
    assert reduced == [(1, (m,))]
    first, second = launches[0][2], launches[1][2]
    maps = 3 if drop else 2
    assert first[maps + 4] == second[maps + 4]  # the absmax, where b2 was
    assert second[maps + 5] == y.data_ptr()
    splits = qf.mlp_splits(m, h, 132)
    assert first[maps + 8:maps + 13] == (m, 768, h, qf.mlp_grid(m, splits), splits)
    assert all(n == len(a) for _, n, a in launches)


def test_the_module_runs_its_ranks_within_budget(run):
    assert run["child_s"] < 120
