"""Tensor parallelism (`parallel=tp`, a tensor axis > 1) in the port, on the
CPU: the Megatron split of each block's qkv, proj, fc1 and fc2, the
attention-dropout masks keyed by the global head (rows 3 and 4's plain
versions), the fused MLP's partial mode (rows 6 and 7's plain versions),
and whole training steps on gloo ranks.

The ranks are child processes (`tests/_torch_parallel_child.py`, torch and
the port only), two of them on a tensor axis of 2 and, in a second launch,
four of them at (data 2, tensor 2) and (fsdp 2, tensor 2); while they run,
the parent takes the same steps in one process and JAX's `parallel=tp` step
on the (data 4, tensor 2) fake mesh of `tests/conftest.py`.

The shapes are vlmo_debug's cut to width 32 with 2 heads (hd 16) and the
MLP hidden 128, fp32. Tolerances as in tests/test_torch_port_parallel.py:
rtol 1e-5 on the losses, 1e-4 on the gradient norm, 2e-6 plus 1e-5
relative on the updated parameters against the one-process step (the
ranks add their partial sums in another order); against JAX, rtol 1e-4
plus 1e-6 on the parameters. Every dropout is on where the tensor axis is
the only one: the masks are the one-process step's by construction (the
hash keyed by the global head, the hidden dropout's columns of the whole
draw, the generators the tensor peers share). With a data axis as well,
each data coordinate draws its own hidden dropout and DropPath, as JAX's
processes do, so those layouts hold the attention dropout on and the
others at 0, as the presets' test does.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.ops import flash_attention as jfa
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.train import trainer as jax_trainer_module
from exploremultimodal_tpu.train.trainer import Trainer as JaxTrainer
from exploremultimodal_torch.config import VlmoConfig, load_config
from exploremultimodal_torch.models.convert import from_flax_params, load_flax_train_state
from exploremultimodal_torch.models.task import VlmoTask
from exploremultimodal_torch.ops import flash_attention as pfa
from exploremultimodal_torch.ops import mlp_fused
from exploremultimodal_torch.ops.stochastic import StepRng
from exploremultimodal_torch.parallel.partitioning import (
    tensor_gather,
    tensor_shard,
    tensor_split,
)
from exploremultimodal_torch.train import checkpoints as ckpt_lib
from exploremultimodal_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_torch_parallel_child.py")
ROWS, TENSOR = 8, 2
TINY = [
    "model=vlmo_debug", "train=pretrain_mum", "train.datasets=[synthetic]",
    "data.synthetic_size=16", "model.img_size=32", "model.embed_dim=32",
    "model.num_heads=2", "model.max_text_len=12", "model.itc_dim=16",
    "data.num_mask_patches=2", "data.min_mask_patches_per_block=1", "data.num_workers=0",
    "train.discrete_vae_type=random", "compute_dtype=float32", "log_level=error",
    "train.opt.eps=1.0", "train.warmup_steps=1", "train.warmup_lr=1e-2",
    "train.base_lr=1e-2",
]
# pretrain_mum's losses but MIM, attention dropout through the hash
STEP = TINY + ["train.loss_names=[itc,itm,mlm]", "attn_impl=pallas",
               "model.attn_drop_rate=0.1", "model.drop_rate=0.0", "model.drop_path_rate=0.0"]
# ... and every dropout on: hidden, attention, DropPath
ALL = STEP + ["model.drop_rate=0.1", "model.drop_path_rate=0.1"]
# finetune_vqa on the fused MLP (rows 6 and 7's plain versions, the partial
# mode under tp) with every dropout on
VQA = TINY + ["train=finetune_vqa", "data.synthetic_size=12", "model.mlp_impl=fused",
              "attn_impl=pallas", "model.attn_drop_rate=0.1", "model.drop_rate=0.1",
              "model.drop_path_rate=0.1", "data.batch_size=4"]
# JAX's comparison: ITC and MLM (no sampled negatives) at dropout 0
JAX_TP = TINY + ["train.loss_names=[itc,mlm]", "model.attn_drop_rate=0.0",
                 "model.drop_rate=0.0", "model.drop_path_rate=0.0"]
PARAMS = ("transformer.blocks.0.attn.qkv.weight", "transformer.blocks.0.attn.q_bias",
          "transformer.blocks.1.attn.proj.weight", "transformer.blocks.1.mlp_vl.fc1.bias",
          "transformer.blocks.1.mlp_vl.fc2.weight", "transformer.blocks.0.mlp_l.fc1.weight",
          "transformer.blocks.1.attn.proj.bias", "itm_head.fc.weight", "itc_temp",
          "transformer.txt_embeddings.LayerNorm.weight")
VQA_PARAMS = ("transformer.blocks.1.mlp_vl.fc1.weight", "transformer.blocks.1.mlp_vl.fc2.weight",
              "transformer.blocks.1.mlp_vl.fc2.bias", "transformer.blocks.0.attn.qkv.weight",
              "vqa_classifier.fc1.weight")
METRICS = ("total_loss", "itc_task_loss", "mlm_task_loss", "itm_task_loss", "i2t_Loss",
           "mlm_mean_acc", "itm_mean_acc")
# the 4-process layouts: (data 2, tensor 2) and (fsdp 2, tensor 2)
LAYOUTS = {"data_tensor": ["runtime.mesh.data=2", "runtime.mesh.tensor=2"],
           "fsdp_tensor": ["runtime.mesh.data=1", "runtime.mesh.fsdp=2",
                           "runtime.mesh.tensor=2"]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _close(got, want, rtol=1e-5, atol=2e-6, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


class _NoData:
    """JAX's trainer needs of its data only the train loader's length here
    (the batch is the port's, which equals JAX's synthetic one)."""

    def __init__(self, cfg):
        self.steps = 16 // int(cfg.data.batch_size)

    def train_loader(self):
        return [None] * self.steps


def _negatives(rows: int) -> tuple:
    g = torch.Generator().manual_seed(3)
    return tuple((torch.arange(rows) + torch.randint(1, rows, (rows,), generator=g)) % rows
                 for _ in range(2))


def _spawn(tmp: str, world: int, threads: int) -> list:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = str(threads)
    port = _free_port()
    return [subprocess.Popen([sys.executable, CHILD, str(port), str(r), str(world), tmp],
                             env=env, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _one(overrides, weights, batch, negatives=None, steps=1, tmp="", params=PARAMS):
    """The one-process reference: `steps` steps on `batch` from `weights`;
    its metrics, the named parameters and the AdamW state after."""
    tr = Trainer(load_config(overrides + [f"exp_dir={tmp}"]), device="cpu")
    tr.task.load_state_dict(weights)
    metrics = [tr.step(batch, negatives=negatives) for _ in range(steps)]
    sd = tr.task.state_dict()
    return {"metrics": metrics, "params": {k: sd[k].clone() for k in params},
            "moments": tr.state.optimizer.full_state_dict()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp"))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    init = JaxTask.init
    jitted = jax.jit(lambda self, r, a, method: init(self, r, *a, method=method),
                     static_argnums=(0, 3))
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JaxTask, "init",
                       lambda self, rngs, *a, method=None: jitted(self, rngs, a, method))
            mp.setattr(jax_trainer_module, "MultiTaskData", _NoData)
            yield _run(tmp)
    finally:
        torch.set_num_threads(n_threads)


def _run(tmp: str) -> dict:
    one = Trainer(load_config(ALL + ["data.batch_size=8", f"exp_dir={tmp}/w"]), device="cpu")
    batch = next(one.loader.epoch(0))
    weights = {"step": {k: v.clone() for k, v in one.task.state_dict().items()}}
    vqa_one = Trainer(load_config(VQA + [f"exp_dir={tmp}/vw"]), device="cpu")
    vqa_batch = next(vqa_one.loader.epoch(0))
    weights["vqa"] = {k: v.clone() for k, v in vqa_one.task.state_dict().items()}
    negatives = _negatives(ROWS)
    # a checkpoint of one process after a step, for the ranks to load
    saved_one = f"{tmp}/ckpt_one"
    saver = Trainer(load_config(STEP + ["data.batch_size=8", f"exp_dir={saved_one}"]),
                    device="cpu")
    saver.task.load_state_dict(weights["step"])
    saver.step(batch, negatives=negatives)
    ckpt_lib.save(saved_one, saver.state, saver.cfg, 0)

    tp = ["parallel=tp", "data.batch_size=8"]
    common = {"weights": "step", "batch": "step", "negatives": True, "params": PARAMS}
    cases = {
        "tp": {**common, "overrides": ALL + tp + [f"exp_dir={tmp}/tp"], "steps": 3,
               "whole_params": True, "save": f"{tmp}/ckpt_tp"},
        "tp_remat": {**common, "overrides": ALL + tp + ["parallel.remat=true",
                                                       f"exp_dir={tmp}/tr"]},
        "tp_vqa": {"overrides": VQA + ["parallel=tp", f"exp_dir={tmp}/tv"],
                   "weights": "vqa", "batch": "vqa", "params": VQA_PARAMS},
        "tp_load": {**common, "overrides": STEP + tp + [f"exp_dir={tmp}/tl"], "steps": 0,
                    "load": saved_one},
        # JAX's initial weights (in_jax.pt, written while the ranks run)
        "tp_jax": {"overrides": JAX_TP + tp + [f"exp_dir={tmp}/tj"], "weights": "jax",
                   "batch": "step", "params": PARAMS[:7] + PARAMS[8:], "jax": True},
    }
    four = {name: {**common, "overrides": STEP + ["parallel=tp", "data.batch_size=4",
                                                  f"exp_dir={tmp}/{name}"] + extra}
            for name, extra in LAYOUTS.items()}
    four["fsdp_tensor"]["save"] = f"{tmp}/ckpt_ft"
    inputs = {"weights": weights, "batch_rows": ROWS,
              "batches": {"step": batch, "vqa": vqa_batch}, "negatives": negatives}
    dirs = {"two": f"{tmp}/two", "four": f"{tmp}/four"}
    for key, group in (("two", cases), ("four", four)):
        os.makedirs(dirs[key])
        torch.save({**inputs, "cases": group}, os.path.join(dirs[key], "in.pt"))
    t0 = time.perf_counter()
    procs = {"two": _spawn(dirs["two"], TENSOR, 2), "four": _spawn(dirs["four"], 4, 1)}
    out = {"one": {}}
    try:
        # JAX's tp step on the (data 4, tensor 2) mesh, its initial weights
        # to the ranks
        jbatch = {k: v for k, v in batch.items() if not isinstance(v, list)}
        jtr = JaxTrainer(jax_load_config(JAX_TP + [
            "data.batch_size=8", "parallel=tp", "runtime.mesh.data=4", "runtime.mesh.tensor=2",
            f"exp_dir={tmp}/jax"]))
        jstate = jtr.init_state({k: jnp.asarray(v) for k, v in jbatch.items()})
        holder = Trainer(load_config(JAX_TP + ["data.batch_size=8", f"exp_dir={tmp}/jh"]),
                         device="cpu")
        load_flax_train_state(holder.state, jax.device_get({"params": jstate.params}))
        weights["jax"] = {k: v.clone() for k, v in holder.task.state_dict().items()}
        path = os.path.join(dirs["two"], "in_jax.tmp")
        torch.save({"weights": weights}, path)
        os.replace(path, os.path.join(dirs["two"], "in_jax.pt"))
        new, jmetrics = jtr.make_train_step()(
            jstate, {k: jnp.asarray(v) for k, v in jbatch.items()}, jnp.asarray(0.0))
        out["jax"] = {"params": from_flax_params(jax.device_get(new.params)),
                      "metrics": jax.device_get(jmetrics),
                      "specs": [str(s.spec) for s in jax.tree.leaves(
                          jtr.state_shardings.params)]}
        # meanwhile: the one-process steps
        out["one"]["all"] = _one(ALL + ["data.batch_size=8"], weights["step"], batch,
                                 negatives, steps=3, tmp=f"{tmp}/o1")
        out["one"]["step"] = _one(STEP + ["data.batch_size=8"], weights["step"], batch,
                                  negatives, tmp=f"{tmp}/o2")
        out["one"]["vqa"] = _one(VQA, weights["vqa"], vqa_batch, tmp=f"{tmp}/o3",
                                 params=VQA_PARAMS)
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
                  for r in range(TENSOR)]
    out["four"] = [torch.load(os.path.join(dirs["four"], f"out_{r}.pt"), weights_only=False)
                   for r in range(4)]
    out.update(tmp=tmp, saved_one=saved_one, weights=weights)
    return out


def _check_step(ranks, case, want, step=0, params=PARAMS, metrics=METRICS):
    for rank in ranks:
        got = rank[case][f"metrics_{step}"]
        for k in metrics:
            _close(got[k], want["metrics"][step][k], what=f"{case} {k}")
        _close(got["grad_norm"], want["metrics"][step]["grad_norm"], rtol=1e-4,
               what=f"{case} grad_norm")
    for k in params:
        _close(ranks[0][case]["params"][k], want["params"][k], what=f"{case} {k}")


# ------------------------------------------------------- the split itself


def _task_state() -> dict:
    cfg = VlmoConfig.from_config(load_config(TINY))
    task = VlmoTask(cfg)
    task.init_weights(torch.Generator().manual_seed(0))
    return task.state_dict()


@pytest.mark.parametrize("size", [2, 4])
def test_tensor_shard_and_gather_round_trip(size):
    """`tensor_gather` of every rank's `tensor_shard` is the whole state
    dict bit for bit; rank t's qkv rows are [q_t | k_t | v_t] (each of q, k
    and v split by head, not GSPMD's contiguous split), its q_bias / v_bias
    and fc1 rows and its proj / fc2 columns the matching slices, and every
    other parameter whole."""
    sd = _task_state()
    shards = [tensor_shard(sd, t, size) for t in range(size)]
    back = tensor_gather(shards)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    c = 32
    w = sd["transformer.blocks.0.attn.qkv.weight"]
    for t, shard in enumerate(shards):
        rows = [w[j * c + t * c // size:j * c + (t + 1) * c // size] for j in range(3)]
        assert torch.equal(shard["transformer.blocks.0.attn.qkv.weight"], torch.cat(rows))
        lo, hi = t * c // size, (t + 1) * c // size
        assert torch.equal(shard["transformer.blocks.0.attn.q_bias"],
                           sd["transformer.blocks.0.attn.q_bias"][lo:hi])
        assert torch.equal(shard["transformer.blocks.0.attn.proj.weight"],
                           sd["transformer.blocks.0.attn.proj.weight"][:, lo:hi])
        h = 4 * c // size
        assert torch.equal(shard["transformer.blocks.1.mlp_vl.fc1.weight"],
                           sd["transformer.blocks.1.mlp_vl.fc1.weight"][t * h:(t + 1) * h])
        assert torch.equal(shard["transformer.blocks.1.mlp_vl.fc2.weight"],
                           sd["transformer.blocks.1.mlp_vl.fc2.weight"][:, t * h:(t + 1) * h])
    whole = [k for k in sd if tensor_split(k) is None]
    assert "transformer.blocks.0.attn.proj.bias" in whole
    assert "transformer.blocks.0.mlp_v.fc2.bias" in whole and "itc_temp" in whole
    assert all(torch.equal(shards[1][k], sd[k]) for k in whole)


# ----------------------------------------- rows 3 and 4: the global heads


@pytest.mark.parametrize("t,size,runs", [(0, 2, 1), (1, 2, 1), (1, 2, 3), (2, 4, 1)])
def test_plain_masks_at_a_tensor_rank_are_jaxs_at_the_global_heads(t, size, runs):
    """The plain mask (and so rows 3 and 4, which hash the same key) of a
    call holding heads t H/T .. (t+1) H/T - 1 of each row's H, with and
    without a data rank's row index, is JAX's `dropout_keep_mask` of the
    whole global batch at those heads, bit for bit; with H_total = H and
    head0 = 0 the key is today's."""
    heads, n, seed, b_local, ranks = 4, 17, -4321, 2, 2
    local = heads // size
    b_global = ranks * b_local * runs
    want = np.asarray(jfa.dropout_keep_mask(np.asarray([seed], np.int32), b_global, heads,
                                            n, 0.1)).reshape(b_global, heads, n, n)
    seed_t = torch.tensor([seed], dtype=torch.int32)
    rng = StepRng(torch.Generator(), torch.Generator(), torch.device("cpu"), rank=1,
                  world=ranks)
    with rng.runs(runs):
        rows = rng.row_index(b_local * runs, torch.device("cpu"))
    got = pfa.dropout_keep_mask_plain(seed_t, b_local * runs * local, n, 0.1, rows,
                                      heads_total=heads, head0=t * local)
    np.testing.assert_array_equal(got.numpy().reshape(-1, local, n, n),
                                  want[rows.numpy()][:, t * local:(t + 1) * local])
    # one data rank: the first rows of the global batch
    got = pfa.dropout_keep_mask_plain(seed_t, b_global * local, n, 0.1, batch=b_global,
                                      heads_total=heads, head0=t * local)
    np.testing.assert_array_equal(got.numpy().reshape(-1, local, n, n),
                                  want[:, t * local:(t + 1) * local])
    for idx, bh in ((None, b_global * heads), (rows, rows.numel() * heads)):
        assert torch.equal(pfa.dropout_heads(bh, idx, "cpu", bh // heads, heads, 0),
                           pfa.dropout_heads(bh, idx, "cpu"))


def test_plain_attention_with_the_head_offset_matches_the_whole_call():
    """Row 3's and row 4's plain versions on rank t's heads with its
    offset equal the whole call's outputs and gradients at those heads
    (fp32, exact: the same arithmetic per head)."""
    b, heads, n, d, size = 3, 4, 20, 8, 2
    local = heads // size
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(b * heads, n, d, generator=g) for _ in range(4))
    kb = torch.zeros(b, n)
    seed = torch.tensor([99], dtype=torch.int32)
    out, lse = pfa.flash_attention_fwd_drop(q, k, v, kb, seed, 0.25, 0.2)
    grads = pfa.flash_attention_bwd_drop(q, k, v, kb, seed, out, do, lse, 0.25, 0.2)
    for t in range(size):
        sel = (torch.arange(b)[:, None] * heads + t * local + torch.arange(local)).reshape(-1)
        o_t, l_t = pfa.flash_attention_fwd_drop(q[sel], k[sel], v[sel], kb, seed, 0.25, 0.2,
                                                heads_total=heads, head0=t * local)
        assert torch.equal(o_t, out[sel]) and torch.equal(l_t, lse[sel])
        g_t = pfa.flash_attention_bwd_drop(q[sel], k[sel], v[sel], kb, seed, o_t, do[sel],
                                           l_t, 0.25, 0.2, heads_total=heads,
                                           head0=t * local)
        for x, y in zip(g_t, grads):
            assert torch.equal(x, y[sel])
    # the kernels' wrappers refuse heads beyond the total
    qkv = [torch.zeros(b * local, n, 64, dtype=torch.bfloat16) for _ in range(3)]
    pfa._check("flash_attention_fwd_drop", kb, *qkv, heads_total=heads, head0=heads - local)
    with pytest.raises(ValueError, match="not within"):
        pfa._check("flash_attention_fwd_drop", kb, *qkv, heads_total=heads, head0=heads - 1)


# ------------------------------------------ rows 6 and 7: the partial mode


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("drop", [False, True])
def test_plain_partial_mlp_summed_is_the_whole(dtype, drop):
    """The partial mode's plain version (fp32, no b2, unrounded) on each
    rank's hidden/T columns, summed over the T ranks plus b2 and rounded
    once, is the whole plain MLP (fp32: to the order of the sums; bf16:
    within one ulp of the output); with dropout, each rank's columns of the
    whole bits. Through the differentiable `fused_mlp`, the ranks' weight
    gradients are the whole one's slices and their input gradients sum to
    the whole one's."""
    m, k, hidden, size, thr = 10, 32, 128, 2, 6554
    g = torch.Generator().manual_seed(11)
    x = torch.randn(m, k, generator=g).to(dtype)
    w1, w2 = torch.randn(hidden, k, generator=g) * 0.2, torch.randn(k, hidden, generator=g) * 0.2
    b1, b2 = torch.randn(hidden, generator=g) * 0.1, torch.randn(k, generator=g) * 0.1
    bits = (torch.randint(-32768, 32768, (m, hidden), generator=g, dtype=torch.int16)
            if drop else None)
    plain = mlp_fused.fused_mlp_fwd_drop_plain if drop else mlp_fused.fused_mlp_fwd_plain
    extra = (bits, thr) if drop else ()
    whole = plain(x, w1.to(dtype), b1, w2.to(dtype), b2, *extra)
    parts = []
    for t in range(size):
        cols = slice(t * hidden // size, (t + 1) * hidden // size)
        ex = (bits[:, cols], thr) if drop else ()
        part = plain(x, w1[cols].to(dtype), b1[cols], w2[:, cols].to(dtype), None, *ex)
        assert part.dtype == torch.float32
        parts.append(part)
    summed = (parts[0] + parts[1] + b2).to(dtype)
    tol = {"rtol": 1e-6, "atol": 1e-6} if dtype == torch.float32 else {"rtol": 8e-3, "atol": 8e-3}
    torch.testing.assert_close(summed, whole, **tol)
    if dtype != torch.float32:
        return
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    y = mlp_fused.fused_mlp(*leaves, bits, thr if drop else 0)
    gy = torch.randn(y.shape, generator=g)
    (y * gy).sum().backward()
    dx = torch.zeros_like(x)
    for t in range(size):
        cols = slice(t * hidden // size, (t + 1) * hidden // size)
        lt = [x.clone().requires_grad_(), w1[cols].clone().requires_grad_(),
              b1[cols].clone().requires_grad_(), w2[:, cols].clone().requires_grad_()]
        yt = mlp_fused.fused_mlp(*lt, None, None if bits is None else bits[:, cols],
                                 thr if drop else 0)
        (yt * gy).sum().backward()
        dx += lt[0].grad
        torch.testing.assert_close(lt[1].grad, leaves[1].grad[cols], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(lt[3].grad, leaves[3].grad[:, cols], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dx, leaves[0].grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [128, 7584])
@pytest.mark.parametrize("drop", [False, True])
def test_partial_launch_hands_the_kernel_an_fp32_y_and_no_b2(monkeypatch, m, drop):
    """Rows 6 and 7's partial mode on the card's route (the wrapper driven
    with a fake loader, as tests/test_torch_port_sm90_host.py drives it):
    an fp32 (M, 768) y, a null b2, the width, the partial flag set, and the
    hidden split of the share (several splits at M = 128, one at 7,584,
    where the kernel stores into y itself and needs no scratch); the source
    sums the splits in fp32 without b2."""
    import types

    launches = []

    def fake_load(name, argtypes, symbol=None):
        if symbol == "fused_mlp_sm90_encode":
            return lambda *a: 0
        assert len(argtypes) == len(mlp_fused._DROP_ARGTYPES if drop
                                   else mlp_fused._SM90_ARGTYPES)
        return lambda *a: launches.append(a) or 0

    monkeypatch.setattr(mlp_fused._build, "load", fake_load)
    monkeypatch.setattr(mlp_fused, "_MAPS", {})
    monkeypatch.setitem(mlp_fused._SMS, None, 132)
    monkeypatch.setattr(mlp_fused.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    hidden = 1536
    x = torch.zeros(m, 768, dtype=torch.bfloat16)
    w1, w2 = torch.zeros(hidden, 768, dtype=torch.bfloat16), torch.zeros(768, hidden,
                                                                          dtype=torch.bfloat16)
    b1 = torch.zeros(hidden)
    bits = torch.zeros(m, hidden, dtype=torch.int16) if drop else None
    y = mlp_fused._launch_sm90("t", x, w1, b1, w2, None, bits, 6554 if drop else 0)
    assert y.dtype == torch.float32 and y.shape == (m, 768)
    args = launches[-1][4 if drop else 3:]
    splits = mlp_fused.hidden_splits(m, hidden, 132)
    assert args[0] == b1.data_ptr() and args[1] is None and args[2] == y.data_ptr()
    assert (args[3] is None) == (splits == 1) and args[4:9] == (m, 768, hidden, splits, 1)
    assert (splits > 1) == (m == 128)
    src = (mlp_fused._build.CSRC / "fused_mlp_sm90.cu").read_text()
    assert "splits > 1 ? part : partial ? y : nullptr" in src
    assert "mlp_sum_splits<true>" in src and "(!partial && b2 == nullptr)" in src


# ------------------------------------------------------ the training step


def test_tp_step_equals_one_process_with_every_dropout_on(run):
    """Two tensor ranks on the same 8 rows, every dropout on (hidden,
    attention through the hash at the global heads, DropPath): three steps
    equal the one process's, the losses the same on both ranks, the
    gradient norm and the whole parameters after (gathered over the
    tensor axis)."""
    want = run["one"]["all"]
    assert run["two"][0]["tp"]["mesh"] == (0, 0, "tp")
    assert run["two"][1]["tp"]["mesh"] == (0, 1, "tp")
    for step in range(3):
        for rank in run["two"]:
            got = rank["tp"][f"metrics_{step}"]
            for k in METRICS:
                _close(got[k], want["metrics"][step][k], what=f"step {step} {k}")
            _close(got["grad_norm"], want["metrics"][step]["grad_norm"], rtol=1e-4)
    for k in PARAMS:
        _close(run["two"][0]["tp"]["params"][k], want["params"][k], what=k)


def test_whole_parameters_stay_bit_equal_across_tensor_ranks(run):
    """After three steps every parameter held whole on the tensor axis
    (norms, embeddings, heads, the proj and fc2 biases, itc_temp) is the
    same on both ranks, bit for bit: their gradients are the same reduced
    sums and the clip coefficient the same norm."""
    a, b = (rank["tp"]["whole_params"] for rank in run["two"])
    assert a.keys() == b.keys() and "transformer.blocks.0.attn.proj.bias" in a
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tp_with_a_data_axis_equals_one_process(run, layout):
    """Four ranks at (data 2, tensor 2) and (fsdp 2, tensor 2): each data
    coordinate takes 4 of the 8 rows, each tensor rank half of every
    block; the step equals the one process's on the 8 rows (attention
    dropout on, through the hash keyed by the global row and head)."""
    want = run["one"]["step"]
    for r, rank in enumerate(run["four"]):
        assert rank[layout]["mesh"] == (r // 2, r % 2, "tp")
    ranks = run["four"]
    for rank in ranks:
        got = rank[layout]["metrics_0"]
        for k in METRICS:
            _close(got[k], want["metrics"][0][k], what=f"{layout} {k}")
        _close(got["grad_norm"], want["metrics"][0]["grad_norm"], rtol=1e-4)
    for k in PARAMS:
        _close(ranks[0][layout]["params"][k], want["params"][k], what=f"{layout} {k}")


def test_fused_mlp_partial_mode_trains_under_tp(run):
    """finetune_vqa with `mlp_impl=fused` (rows 6 and 7's plain versions,
    in the partial mode on each rank's hidden/T) and every dropout on, on
    two tensor ranks: the step equals the one process's."""
    want = run["one"]["vqa"]
    for rank in run["two"]:
        got = rank["tp_vqa"]["metrics_0"]
        for k in ("total_loss", "vqa_task_loss", "vqa_mean_score"):
            _close(got[k], want["metrics"][0][k], what=k)
        _close(got["grad_norm"], want["metrics"][0]["grad_norm"], rtol=1e-4)
    for k in VQA_PARAMS:
        _close(run["two"][0]["tp_vqa"]["params"][k], want["params"][k], what=k)


def test_remat_under_tp_equals_tp_without_it(run):
    """`parallel.remat=true` under tp runs each block's all-reduces again
    in the backward's recomputation: the step's metrics and parameters are
    the step's without remat, bit for bit."""
    for rank in run["two"]:
        a, b = rank["tp_remat"]["metrics_0"], rank["tp"]["metrics_0"]
        for k in METRICS + ("grad_norm",):
            assert float(a[k]) == float(b[k]), k


def test_tp_step_matches_jaxs_tp_step(run):
    """ITC and MLM at dropout 0 from JAX's initial weights: the two tensor
    ranks' step equals JAX's `parallel=tp` step on the (data 4, tensor 2)
    fake mesh (Megatron-split specs on the tensor axis there)."""
    assert any("tensor" in s for s in run["jax"]["specs"])
    want = run["jax"]
    for rank in run["two"]:
        got = rank["tp_jax"]["metrics_0"]
        for k in ("total_loss", "itc_task_loss", "mlm_task_loss", "i2t_Loss"):
            _close(got[k], want["metrics"][k], what=k)
        _close(got["grad_norm"], want["metrics"]["grad_norm"], rtol=1e-4, what="grad_norm")
    for k in PARAMS[:7] + PARAMS[8:]:
        _close(run["two"][0]["tp_jax"]["params"][k], want["params"][k], rtol=1e-4,
               atol=1e-6, what=k)


# ----------------------------------------------------------- checkpoints


def test_checkpoint_of_two_tensor_ranks_loads_in_one_process(run):
    """Rank 0 writes the whole torch layout (the tensor shares gathered):
    one process reads it, its parameters are the ranks' after their three
    steps, its AdamW moments the one process's after the same steps."""
    path = run["two"][0]["tp"]["saved"]
    tr = Trainer(load_config(ALL + ["data.batch_size=8", f"exp_dir={run['tmp']}/l1"]),
                 device="cpu")
    restored = ckpt_lib.auto_load(os.path.dirname(path), tr.state, tr.cfg)
    assert restored is not None and tr.state.step == 3
    sd = tr.task.state_dict()
    for k in PARAMS:
        _close(sd[k], run["two"][0]["tp"]["params"][k], rtol=0, atol=0, what=k)
    got = tr.state.optimizer.full_state_dict()["state"]
    want = run["one"]["all"]["moments"]["state"]
    assert got.keys() == want.keys()
    # the first moments of three steps' gradients: rtol 1e-4 plus 1e-3 of the
    # leaf's largest, the gradient tolerance of tests/test_torch_port_momentum.py
    # (an element near zero carries the sums' order)
    for i in got:
        w = want[i]["exp_avg"]
        _close(got[i]["exp_avg"], w, rtol=1e-4, atol=1e-3 * float(w.abs().max()), what=str(i))


def test_checkpoint_of_fsdp_and_tensor_ranks_loads_in_one_process(run):
    """At (fsdp 2, tensor 2) rank 0 writes the whole layout (the fsdp
    shards gathered, then the tensor shares): one process reads the ranks'
    parameters bit for bit and the one process's AdamW moments after the
    same step."""
    path = run["four"][0]["fsdp_tensor"]["saved"]
    tr = Trainer(load_config(STEP + ["data.batch_size=8", f"exp_dir={run['tmp']}/l2"]),
                 device="cpu")
    assert ckpt_lib.auto_load(os.path.dirname(path), tr.state, tr.cfg) is not None
    sd = tr.task.state_dict()
    for k in PARAMS:
        _close(sd[k], run["four"][0]["fsdp_tensor"]["params"][k], rtol=0, atol=0, what=k)
    got = tr.state.optimizer.full_state_dict()["state"]
    want = run["one"]["step"]["moments"]["state"]
    for i in got:
        w = want[i]["exp_avg"]
        _close(got[i]["exp_avg"], w, rtol=1e-4, atol=1e-3 * float(w.abs().max()), what=str(i))


def test_checkpoint_of_one_process_loads_into_two_tensor_ranks(run):
    """The one process's checkpoint read by two tensor ranks, each taking
    its shares: the whole parameters and every AdamW moment, gathered back,
    are the file's, bit for bit."""
    sd, _ = ckpt_lib.read_checkpoint(os.path.join(run["saved_one"], "checkpoint-0"))
    got = run["two"][0]["tp_load"]
    assert int(got["loaded_epoch"]) == 1 and int(got["loaded_step"]) == 1
    for k in PARAMS:
        _close(got["loaded"][k], sd["model"][k], rtol=0, atol=0, what=k)
    moments = got["loaded_optimizer"]["state"]
    for i, st in sd["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(moments[i][key], st[key]), (i, key)


def test_the_module_runs_its_ranks_within_budget(run):
    assert run["child_s"] < 120
