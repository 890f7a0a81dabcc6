"""Training and serving on more than one process: the port's parallel
presets, collectives, global-batch losses, rank-keyed attention dropout,
remat, accumulation across processes, checkpoints across world sizes and
mesh serving, on the CPU (tensor parallelism: tests/test_torch_port_tp.py).

Two ranks are two child processes (`tests/_torch_parallel_child.py`, torch
and the port only) on a gloo group through `runtime.coordinator_address`,
spawned once for the module on a free port; each runs every case on its
half of an 8-row global batch the parent wrote, and returns its tensors in
a file. While they run, the parent takes the same steps in one process and
JAX's on the 8 fake devices of `tests/conftest.py`, from the same weights
(`convert.load_flax_train_state`).

Tolerances: the presets' two-rank step against the one-process step on
the same 8 rows, rtol 1e-5 on the losses, 1e-4 on the gradient norm and
2e-6 plus 1e-5 relative on the updated parameters (AdamW's eps at 1, so
the update follows the gradient continuously): the only differences are
the order of the cross-rank sums and FSDP2's sharded norm. Against JAX, as
the port's one-process tests hold it (rtol 1e-5, the norm 1e-4).
"""

import itertools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.infer import Predictor as JaxPredictor
from exploremultimodal_tpu.ops import flash_attention as jfa
from exploremultimodal_tpu.parallel import all_gather_with_grad as jax_gather
from exploremultimodal_tpu.parallel import create_mesh as jax_create_mesh
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.train import trainer as jax_trainer_module
from exploremultimodal_tpu.train.trainer import Trainer as JaxTrainer
from exploremultimodal_torch.config import PARALLEL_PRESETS, VlmoConfig, load_config
from exploremultimodal_torch.infer import Predictor
from exploremultimodal_torch.models.convert import from_flax_params, load_flax_train_state
from exploremultimodal_torch.ops import flash_attention as pfa
from exploremultimodal_torch.ops.stochastic import StepRng
from exploremultimodal_torch.parallel import mesh_shape
from exploremultimodal_torch.train import checkpoints as ckpt_lib
from exploremultimodal_torch.train.phases import write_vqa_submission
from exploremultimodal_torch.train.trainer import Trainer
from exploremultimodal_torch.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_torch_parallel_child.py")
ROWS, WORLD = 8, 2
PER = ROWS // WORLD
TINY = [
    "model=vlmo_debug", "train=pretrain_mum", "train.datasets=[synthetic]",
    "data.synthetic_size=16", "model.img_size=32", "model.embed_dim=32",
    "model.num_heads=2", "model.max_text_len=12", "model.itc_dim=16",
    "data.num_mask_patches=2", "data.min_mask_patches_per_block=1", "data.num_workers=0",
    "train.discrete_vae_type=random", "compute_dtype=float32", "log_level=error",
    "model.drop_rate=0.0", "model.drop_path_rate=0.0", "train.opt.eps=1.0",
    "train.warmup_steps=1", "train.warmup_lr=1e-2", "train.base_lr=1e-2",
]
# pretrain_mum's losses but MIM (the random dVAE costs seconds to build),
# attention dropout on through the hash (the pallas route's plain version)
STEP = TINY + ["train.loss_names=[itc,itm,mlm]", "attn_impl=pallas",
               "model.attn_drop_rate=0.1"]
RECIPE = TINY + ["train.loss_names=[itc,itm,mlm]", "model.attn_drop_rate=0.0",
                 "vlmo_ema=true", "train.neg_queue=true", "train.queue_size=32",
                 "model_ema=true", "vlmo_ema_decay=0.9", "model_ema_decay=0.99"]
ITC = TINY + ["train.loss_names=[itc]", "model.attn_drop_rate=0.0"]
VQA = TINY + ["train=finetune_vqa", "data.synthetic_size=12", "model.attn_drop_rate=0.0"]
PRESETS = ("dp", "zero1", "fsdp", "fsdp_offload")
PARAMS = ("transformer.blocks.0.attn.qkv.weight", "transformer.blocks.1.mlp_vl.fc1.bias",
          "itm_head.fc.weight", "itc_temp", "transformer.txt_embeddings.LayerNorm.weight")
ITC_PARAMS = ("transformer.blocks.0.attn.qkv.weight", "itc_head.dense_v.weight", "itc_temp")
STEP_METRICS = ("total_loss", "itc_task_loss", "mlm_task_loss", "itm_task_loss",
                "mlm_mean_acc", "itm_mean_acc", "itc_i2t_mean_acc", "i2t_Loss")
# the recipe at accumulation_steps=2: two microbatches of 4 global rows,
# each rank 2 of them; the ITM negatives of a microbatch, indices into its
# 4 rows (images for each text, then texts for each image), as
# tests/test_torch_port_momentum.py gives them to both packages
ACCUM = RECIPE + ["train.accumulation_steps=2"]
ACCUM_NEG = (np.array([2, 3, 1, 0]), np.array([1, 0, 3, 2]))
ACCUM_METRICS = ("total_loss", "itc_task_loss", "i2t_Loss", "i2i_Loss", "t2t_l_Loss",
                 "mlm_task_loss", "itm_task_loss")
JAX_STATE = ("params", "ema_params", "model_ema_params", "img_queue", "txt_queue",
             "queue_ptr")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _NoData:
    """JAX's trainer needs of its data only the train loader's length here
    (the batches are the port's, which equal JAX's synthetic ones): this
    stands in for `MultiTaskData`, whose tokenizer costs seconds."""

    def __init__(self, cfg):
        self.steps = 16 // int(cfg.data.batch_size)

    def train_loader(self):
        return [None] * self.steps


def _jax_trainer(overrides, tmp):
    return JaxTrainer(jax_load_config(overrides + [f"exp_dir={tmp}"]))


def _jax_init(jtrainer, batch):
    """JAX's initial state on `batch`, its parts on the host."""
    state = jtrainer.init_state({k: jnp.asarray(v) for k, v in batch.items()})
    return state, jax.device_get({"params": state.params})


def _jax_step(jtrainer, state, batch):
    step = jtrainer.make_train_step()
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jnp.asarray(0.0))
    return from_flax_params(jax.device_get(new.params)), jax.device_get(metrics)


def _jax_accum_step(jtrainer, state, batch):
    """JAX's jitted step of the recipe at accumulation_steps=2 with the
    ITM negatives given (`jax.random.categorical` returns ACCUM_NEG's in
    turn: the step traces its microbatch body once, so one pair serves both
    microbatches); the state's parts after it and the metrics."""
    given = itertools.cycle(ACCUM_NEG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "categorical",
                   lambda key, logits, axis=-1: jnp.asarray(next(given)))
        new, metrics = jtrainer.make_train_step()(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0.0))
    return jax.device_get({k: getattr(new, k) for k in JAX_STATE}), jax.device_get(metrics)


def _close(got, want, rtol=1e-5, atol=2e-6, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Everything the module checks: the two ranks' outputs and the one
    process's and JAX's results for the same cases."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    init = JaxTask.init
    # flax's init under one jit (JAX's trainer initializes op by op)
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
    # the one-process steps' inputs: the first 8-row batch, random weights,
    # and the ITM negatives (each row's other than its own)
    one = Trainer(load_config(STEP + ["data.batch_size=8", f"exp_dir={tmp}/one"]),
                  device="cpu")
    batch = next(one.loader.epoch(0))
    g = torch.Generator().manual_seed(3)
    negatives = tuple((torch.arange(ROWS) + torch.randint(1, ROWS, (ROWS,), generator=g))
                      % ROWS for _ in range(2))
    weights = {"step": {k: v.clone() for k, v in one.task.state_dict().items()}}
    recipe = Trainer(load_config(RECIPE + ["data.batch_size=8", f"exp_dir={tmp}/r"]),
                     device="cpu")
    weights["recipe"] = {k: v.clone() for k, v in recipe.task.state_dict().items()}
    # JAX's ITC-only trainers: GSPMD over 8 devices, and the shard_map path
    # over a data axis of 2 (each shard 4 rows over the fsdp axis's 4)
    # a checkpoint the one-process run writes, for the ranks to load
    saved_one = f"{tmp}/ckpt_one"
    one_saver = Trainer(load_config(STEP + ["data.batch_size=8", f"exp_dir={saved_one}"]),
                        device="cpu")
    one_saver.task.load_state_dict(weights["step"])
    one_saver.step(batch, negatives=negatives)
    ckpt_lib.save(saved_one, one_saver.state, one_saver.cfg, 0)

    cases = {p: {"overrides": STEP + ["data.batch_size=4", f"parallel={p}",
                                      f"exp_dir={tmp}/{p}"],
                 "weights": "step", "batch": "step", "negatives": True, "params": PARAMS}
             for p in PRESETS}
    cases["fsdp"]["save"] = f"{tmp}/ckpt_fsdp"
    # the moments' round trip through host buffers, which fsdp_offload takes
    # on CUDA, forced on the CPU, over two steps
    cases["fsdp_offload"].update(park=True, steps=2)
    cases["fsdp_two"] = {**cases["fsdp"], "steps": 2, "save": None}
    cases["load_fsdp"] = {"overrides": STEP + ["data.batch_size=4", "parallel=fsdp",
                                               f"exp_dir={tmp}/lf"],
                          "weights": "step", "batch": "step", "negatives": True,
                          "params": PARAMS, "steps": 0, "load": saved_one}
    cases["recipe"] = {"overrides": RECIPE + ["data.batch_size=4", f"exp_dir={tmp}/rr"],
                       "weights": "recipe", "batch": "step", "negatives": True,
                       "params": PARAMS}
    cases["fsdp_gr"] = {"overrides": ITC + ["data.batch_size=4", "parallel=fsdp",
                                            "runtime.mesh.data=2", "runtime.mesh.fsdp=1",
                                            "train.global_reduce=true"],
                        "raises": True}
    cases["vqa"] = {"overrides": VQA + ["data.batch_size=2", f"exp_dir={tmp}/vqa"],
                    "weights": None, "batch": None, "params": (), "steps": 0,
                    "submit": f"{tmp}/vqa_two"}
    # int8 under tensor parallelism: built, no longer refused
    for mode in ("w8a8", "w8a8_pallas"):
        cases[f"int8_{mode}"] = {"overrides": ITC + ["data.batch_size=4", "parallel=tp",
                                                     f"model.quantize={mode}"],
                                 "raises": True}
    # w8a8's one activation scale on a data axis of two: refused on JAX's
    # GSPMD step, built on its shard_map step and for the row-scaled mode
    for tag, extra in (("gspmd", []), ("gr", ["train.global_reduce=true"]),
                       ("pallas", ["model.quantize=w8a8_pallas"])):
        cases[f"int8_dp_{tag}"] = {"overrides": ITC + ["data.batch_size=4", "parallel=dp",
                                                       "model.quantize=w8a8"] + extra,
                                   "raises": True}
    # accumulation across the two ranks, from JAX's initial state (in_jax.pt)
    cases["accum"] = {"overrides": ACCUM + ["data.batch_size=4", f"exp_dir={tmp}/accum"],
                      "weights": None, "flax": "accum", "batch": "step",
                      "negatives": ACCUM_NEG, "params": PARAMS, "jax": True}
    # the ITC-only cases last: they take JAX's initial weights (in_jax.pt)
    for flag in ("true", "false"):
        cases[f"gr_{flag}"] = {
            "overrides": ITC + ["data.batch_size=4", f"train.global_reduce={flag}",
                                f"exp_dir={tmp}/gr_{flag}"],
            "weights": "itc", "batch": "itc", "params": ITC_PARAMS, "jax": True}
    with open(os.path.join(tmp, "in.pt"), "wb") as f:
        torch.save({"cases": cases, "weights": weights, "batch_rows": ROWS,
                    "batches": {"step": batch}, "negatives": negatives}, f)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "2"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, CHILD, str(port), str(r), str(WORLD), tmp],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        # JAX's ITC-only trainers: GSPMD over 8 devices, and the shard_map
        # path over a data axis of 2 (each shard 4 rows over the fsdp
        # axis's 4); its initial weights to the ranks
        itc_one = Trainer(load_config(ITC + ["data.batch_size=8", f"exp_dir={tmp}/i"]),
                          device="cpu")
        jbatch = {k: v for k, v in next(itc_one.loader.epoch(0)).items()
                  if not isinstance(v, list)}
        jgspmd = _jax_trainer(ITC + ["data.batch_size=8"], f"{tmp}/jg")
        jstate, jparts = _jax_init(jgspmd, jbatch)
        load_flax_train_state(itc_one.state, jparts)
        weights["itc"] = {k: v.clone() for k, v in itc_one.task.state_dict().items()}
        # the recipe at accumulation_steps=2 on JAX's GSPMD step (8 rows)
        jaccum = _jax_trainer(ACCUM + ["data.batch_size=8"], f"{tmp}/ja")
        step_batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
        jaccum_state, _ = _jax_init(jaccum, step_batch)
        accum_init = jax.device_get({k: getattr(jaccum_state, k) for k in JAX_STATE})
        with open(os.path.join(tmp, "in_jax.tmp"), "wb") as f:
            torch.save({"weights": weights, "batches": {"step": batch, "itc": jbatch},
                        "flax": {"accum": accum_init}}, f)
        os.replace(os.path.join(tmp, "in_jax.tmp"), os.path.join(tmp, "in_jax.pt"))
        out = {"one": {}, "jax": {}}
        # meanwhile: the one-process steps and JAX's
        for name, cfg, w in (("step", STEP, "step"), ("recipe", RECIPE, "recipe")):
            tr = Trainer(load_config(cfg + ["data.batch_size=8", f"exp_dir={tmp}/o{name}"]),
                         device="cpu")
            tr.task.load_state_dict(weights[w])
            if tr.state.ema_task is not None:
                tr.state.ema_task.load_state_dict(weights[w])
            m = tr.step(batch, negatives=negatives)
            out["one"][name] = {"metrics": m, "params": {k: tr.task.state_dict()[k].clone()
                                                         for k in PARAMS},
                                "queue": (None if tr.state.img_queue is None
                                          else tr.state.img_queue.clone()),
                                "ptr": tr.state.queue_ptr,
                                "moments": tr.state.optimizer.full_state_dict()}
        out["jax"]["gr_false"] = _jax_step(jgspmd, jstate, jbatch)
        out["jax"]["accum"] = _jax_accum_step(jaccum, jaccum_state, step_batch)
        jshard = _jax_trainer(ITC + ["data.batch_size=8", "train.global_reduce=true",
                                     "runtime.mesh.data=2", "runtime.mesh.fsdp=4"],
                              f"{tmp}/js")
        jstate2, _ = _jax_init(jshard, jbatch)
        out["jax"]["gr_true"] = _jax_step(jshard, jstate2, jbatch)
        vqa_one = Trainer(load_config(VQA + ["data.batch_size=2", f"exp_dir={tmp}/vqa1"]),
                          device="cpu")
        out["one"]["submission"] = json.load(open(write_vqa_submission(vqa_one)))
        logs = []
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    out["child_s"] = time.perf_counter() - t0
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    out["ranks"] = [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
                    for r in range(WORLD)]
    out["batch"], out["tmp"], out["saved_one"] = batch, tmp, saved_one
    out["weights"], out["jax_params"] = weights, jparts["params"]
    return out


# ----------------------------------------------------------- config, mesh


def test_parallel_presets_equal_the_jax_yaml():
    """The `parallel` group is a whole copy of configs/parallel/*.yaml, and
    the runtime keys of base.yaml are the JAX loader's."""
    for name in PARALLEL_PRESETS:
        want = jax_load_config([f"parallel={name}"])["parallel"].to_dict()
        assert load_config([f"parallel={name}"])["parallel"] == want, name
    assert load_config([])["runtime"] == jax_load_config([])["runtime"].to_dict()
    assert load_config([])["parallel"]["name"] == "dp"


@pytest.mark.parametrize("overrides,world,want", [
    ([], 8, (8, 1, 1)),
    (["runtime.mesh.data=4", "runtime.mesh.fsdp=2"], 8, (4, 2, 1)),
    (["parallel=fsdp"], 2, (1, 2, 1)),
    (["parallel=zero1"], 4, (1, 4, 1)),
    (["parallel=fsdp", "runtime.mesh.data=2"], 2, (2, 1, 1)),
    (["parallel=dp"], 1, (1, 1, 1)),
])
def test_mesh_shape_follows_jax(overrides, world, want, eight_devices):
    """-1 absorbs the rest, a sharding preset takes the whole mesh, as JAX's
    `create_mesh` does over the same number of devices."""
    got = mesh_shape(load_config(overrides), world=world)
    assert tuple(got.values()) == want
    jmesh = jax_create_mesh(jax_load_config(overrides), devices=eight_devices[:world])
    assert tuple(jmesh.shape.values()) == want


def test_mesh_that_does_not_cover_the_world_raises():
    with pytest.raises(ValueError):
        mesh_shape(world=8, data=3)
    with pytest.raises(ValueError):
        mesh_shape(load_config(["runtime.mesh.data=3", "runtime.mesh.fsdp=1"]), world=2)


@pytest.mark.parametrize("mode", ["w8a8", "w8a8_pallas"])
def test_int8_under_tensor_parallelism_raises_naming_the_later_slice(run, mode):
    """`model.quantize` other than none on a tensor axis of 2 (parallel=tp
    over the two ranks) was refused as a later slice; rows 8-10 now have
    their tensor-split modes, so the trainer builds on both ranks without
    raising (its steps are held to one process's by
    tests/test_torch_port_tp_int8.py)."""
    for rank in run["ranks"]:
        assert rank[f"int8_{mode}"] == {"raised": None}


@pytest.mark.parametrize("tag", ["gspmd", "gr", "pallas"])
def test_w8a8_on_a_data_axis_is_refused_where_jax_takes_the_global_scale(run, tag):
    """`model.quantize=w8a8` (one activation scale per tensor) under dp on
    two processes: JAX's GSPMD step takes that scale over the global batch,
    which the port does not gather, so the trainer refuses it; JAX's
    shard_map step (`global_reduce`) takes each process's own, as the port
    does, and `w8a8_pallas` scales each row: both build."""
    for rank in run["ranks"]:
        raised = rank[f"int8_dp_{tag}"]
        if tag == "gspmd":
            assert raised["type"] == "NotImplementedError" and "A10" in raised["raised"]
        else:
            assert raised == {"raised": None}


# ------------------------------------------------------------ collectives


def test_collectives_match_jax(run, eight_devices):
    """The gather concatenates in rank order, the roll puts the local rows
    first, the gradient of a loss over the gathered rows equals dense
    autodiff (and JAX's shard_map gather), the gradient-free gather has no
    gradient, and a meter sums count and total over the ranks."""
    r0, r1 = (r["collectives"] for r in run["ranks"])
    x = [torch.arange(8, dtype=torch.float32).reshape(4, 2) + 100 * r for r in range(WORLD)]
    torch.testing.assert_close(r0["gather"], torch.cat(x))
    torch.testing.assert_close(r1["gather"], torch.cat(x))
    torch.testing.assert_close(r0["rolled"], torch.cat(x))
    torch.testing.assert_close(r1["rolled"], torch.cat(x[::-1]))
    torch.testing.assert_close(r1["const"], torch.cat(x))
    assert not bool(r0["const_requires_grad"])
    g = torch.Generator().manual_seed(0)
    full = torch.randn(4 * WORLD, 3, generator=g)
    w = torch.randn(4 * WORLD, 3, generator=g)
    dense = full.clone().requires_grad_()
    (torch.tanh(dense) * w).sum().backward()
    torch.testing.assert_close(torch.cat([r0["vjp"], r1["vjp"]]), dense.grad)
    mesh = jax_create_mesh(devices=eight_devices[:WORLD], data=WORLD)
    jw = jnp.asarray(w.numpy())

    def sharded(xs):
        def f(x_local):
            gathered = jax_gather(x_local, "data", roll_local_first=False)
            return jax.lax.pmean(jnp.sum(jnp.tanh(gathered) * jw), "data")
        P = jax.sharding.PartitionSpec
        return shard_map(f, mesh=mesh, in_specs=P("data", None), out_specs=P(),
                         check_vma=False)(xs)

    jgrad = jax.grad(sharded)(jnp.asarray(full.numpy()))
    # tanh in JAX and in torch: 1e-5 apart
    np.testing.assert_allclose(np.asarray(jgrad), dense.grad.numpy(), rtol=1e-5)
    # rank r took r, r + 1, r + 2 at weight r + 1: counts 3 + 6, totals 3 + 12
    for r in run["ranks"]:
        assert r["collectives"]["meter"].tolist() == [3.0 + 6.0, 3.0 + 2 * 6.0]


# ------------------------------------------------- rows 3 and 4: the mask


@pytest.mark.parametrize("runs", [1, 3])
def test_masks_under_a_ranks_row_index_are_the_global_batchs(runs):
    """The plain mask (and so rows 3 and 4, which hash the same key) under
    a rank's `row_index` is JAX's mask of that rank's rows of the global
    batch, bit for bit: one run of rows for a stream over the batch, three
    for ITM's [pos, img-neg, txt-neg] pair batch, whose global layout puts
    each rank's rows in three separate runs."""
    b_local, heads, n, seed = 2, 3, 17, -12345
    b_global = WORLD * b_local * runs
    want = np.asarray(jfa.dropout_keep_mask(np.asarray([seed], np.int32), b_global, heads,
                                            n, 0.1)).reshape(b_global, heads, n, n)
    seen = set()
    for rank in range(WORLD):
        rng = StepRng(torch.Generator(), torch.Generator(), torch.device("cpu"),
                      rank=rank, world=WORLD)
        with rng.runs(runs):
            rows = rng.row_index(b_local * runs, torch.device("cpu"))
        got = pfa.dropout_keep_mask_plain(torch.tensor([seed], dtype=torch.int32),
                                          b_local * runs * heads, n, 0.1, rows)
        np.testing.assert_array_equal(got.numpy().reshape(-1, heads, n, n),
                                      want[rows.numpy()])
        want_rows = [k * WORLD * b_local + rank * b_local + j for k in range(runs)
                     for j in range(b_local)]
        assert rows.tolist() == want_rows
        seen |= set(want_rows)
    assert seen == set(range(b_global))
    # one process: no index, today's masks
    rng = StepRng(torch.Generator(), torch.Generator(), torch.device("cpu"))
    assert rng.row_index(4, torch.device("cpu")) is None


def test_plain_dropout_forward_with_a_row_index_matches_jax_kernel():
    """Row 3's plain version at rank 1's rows of ITM's pair batch against
    JAX's `_fwd_drop_call` (interpret mode) over the whole global batch,
    fp32 (the existing forward tolerance of 1e-5)."""
    b_local, heads, n, d = 2, 2, 24, 8
    rng = StepRng(torch.Generator(), torch.Generator(), torch.device("cpu"),
                  rank=1, world=WORLD)
    with rng.runs(3):
        rows = rng.row_index(3 * b_local, torch.device("cpu"))
    b_global = 3 * WORLD * b_local
    r = np.random.default_rng(5)
    q, k, v = (r.standard_normal((b_global * heads, n, d)).astype(np.float32)
               for _ in range(3))
    pad = 128 - n
    jq, jk, jv = (jnp.asarray(np.pad(t, ((0, 0), (0, pad), (0, 0)))) for t in (q, k, v))
    jbias = jnp.asarray(np.pad(np.zeros((b_global, 1, n), np.float32),
                               ((0, 0), (0, 0), (0, pad)), constant_values=-1e30))
    seed = np.asarray([777], np.int32)
    want, _ = jfa._fwd_drop_call(jnp.asarray(seed), jq, jk, jv, jbias, d ** -0.5, 0.1)
    want = np.asarray(want)[:, :n].reshape(b_global, heads, n, d)[rows.numpy()]
    sel = (rows.numpy()[:, None] * heads + np.arange(heads)).reshape(-1)
    got, _ = pfa.flash_attention_fwd_drop(
        *(torch.from_numpy(t[sel]) for t in (q, k, v)),
        torch.zeros((3 * b_local, n)), torch.from_numpy(seed), d ** -0.5, 0.1, rows)
    np.testing.assert_allclose(got.numpy().reshape(-1, heads, n, d), want,
                               rtol=1e-5, atol=1e-5)


# ----------------------------------------------------- the presets' step


def test_two_ranks_take_different_masked_counts(run):
    """The masked MLM positions differ between the two halves of the batch,
    so a mean of the ranks' means would not be the batch's mean."""
    labels = run["batch"]["text_labels_mlm"]
    counts = [(labels[r * PER:(r + 1) * PER] != -100).sum() for r in range(WORLD)]
    assert counts[0] != counts[1]


@pytest.mark.parametrize("preset", PRESETS)
def test_each_preset_steps_as_one_process_on_the_global_batch(run, preset):
    """One step of two ranks x 4 rows under the preset equals the one
    process's step on the 8 rows: the losses and metrics (the same on both
    ranks), the gradient norm and the updated parameters, at attention
    dropout 0.1 through the hash keyed by each row's global index."""
    want = run["one"]["step"]
    for rank in run["ranks"]:
        got = rank[preset]["metrics_0"]
        for k in STEP_METRICS:
            _close(got[k], want["metrics"][k], what=k)
        _close(got["grad_norm"], want["metrics"]["grad_norm"], rtol=1e-4, what="grad_norm")
    params = run["ranks"][0][preset]["params"]
    if preset == "fsdp_offload":  # two steps: its second against fsdp's
        params = run["ranks"][0]["fsdp_offload"]["metrics_1"]
        for k, v in run["ranks"][0]["fsdp_two"]["metrics_1"].items():
            _close(params[k], v, rtol=0, atol=0, what=k)
        return
    for k in PARAMS:
        _close(params[k], want["params"][k], what=k)


def test_recipe_queue_holds_every_ranks_rows_in_rank_order(run):
    """The momentum recipe under dp: the step and the queues after it
    equal the one process's on the 8 rows (its queue took the rows in the
    order rank 0's, then rank 1's), on both ranks."""
    want = run["one"]["recipe"]
    for rank in run["ranks"]:
        got = rank["recipe"]
        for k in ("total_loss", "itc_task_loss", "i2i_Loss", "t2t_l_Loss"):
            _close(got["metrics_0"][k], want["metrics"][k], what=k)
        _close(got["queue"], want["queue"], what="queue")
        assert int(got["queue_ptr"]) == want["ptr"] == ROWS


@pytest.mark.parametrize("flag", ["true", "false"])
def test_global_reduce_matches_jaxs_paths(run, flag):
    """ITC only: `global_reduce=false` on two ranks is JAX's GSPMD step on
    the 8 rows; `true` is JAX's `shard_map` step over a data axis of 2
    (each rank's own loss against the gathered features, averaged)."""
    want_params, want = run["jax"][f"gr_{flag}"]
    for rank in run["ranks"]:
        got = rank[f"gr_{flag}"]["metrics_0"]
        _close(got["total_loss"], want["total_loss"], what="total_loss")
        _close(got["grad_norm"], want["grad_norm"], rtol=1e-4, what="grad_norm")
    params = run["ranks"][0][f"gr_{flag}"]["params"]
    for k in ITC_PARAMS:
        _close(params[k], want_params[k], rtol=1e-4, atol=1e-6, what=k)


def test_accumulation_on_two_ranks_takes_jaxs_microbatches(run):
    """The recipe at accumulation_steps=2 on two ranks of 4 rows equals
    JAX's step over the 8 rows, whose scan slices the global batch: rank p's
    rows of microbatch i are global rows 4 i + 2 p + j, its positives at
    that offset in the momentum features, the ITM negatives drawn among the
    microbatch's 4 rows. The losses, the gradient norm, the updated
    parameters and both EMA trees' queues, from JAX's initial state."""
    want_parts, want = run["jax"]["accum"]
    want_params = from_flax_params(want_parts["params"])
    for rank in run["ranks"]:
        got = rank["accum"]["metrics_0"]
        for k in ACCUM_METRICS:
            _close(got[k], want[k], what=k)
        _close(got["grad_norm"], want["grad_norm"], rtol=1e-4, what="grad_norm")
        _close(rank["accum"]["queue"], want_parts["img_queue"], rtol=1e-4, atol=1e-6,
               what="queue")
        assert int(rank["accum"]["queue_ptr"]) == int(want_parts["queue_ptr"]) == ROWS
    params = run["ranks"][0]["accum"]["params"]
    for k in PARAMS:
        _close(params[k], want_params[k], rtol=1e-4, atol=1e-6, what=k)


def test_global_reduce_is_refused_under_fsdp(run):
    """As JAX's `test_global_reduce_rejected_under_fsdp`: the shard_map
    path needs the parameters whole on the data axis."""
    for rank in run["ranks"]:
        assert "global_reduce" in (rank["fsdp_gr"]["raised"] or "")


# ---------------------------------------------------------------- remat


@pytest.mark.parametrize("remat", ["true", "dots"])
def test_remat_gives_the_gradients_without_it(remat, monkeypatch):
    """`parallel.remat` true and 'dots' with every dropout on (hidden,
    attention through the hash, DropPath): the loss, every gradient and
    the generators' states after the step equal the step without remat,
    and the dropout forward runs again in the backward (twice its calls)."""
    calls = []
    plain = pfa.flash_attention_fwd_drop_plain

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(pfa, "flash_attention_fwd_drop_plain", counted)
    base = TINY + ["train.loss_names=[itc,itm,mlm]", "attn_impl=pallas",
                   "model.drop_rate=0.1", "model.drop_path_rate=0.1",
                   "model.attn_drop_rate=0.1", "data.batch_size=4"]
    out = {}
    for r in ("false", remat):
        calls.clear()
        tr = Trainer(load_config(base + [f"parallel.remat={r}"]), device="cpu")
        m = tr.step(next(tr.loader.epoch(0)))
        out[r] = (float(m["total_loss"]), {n: p.grad.clone() for n, p in
                                           tr.task.named_parameters() if p.grad is not None},
                  tr.state.generator.get_state(), len(calls))
    loss0, grads0, gen0, calls0 = out["false"]
    loss1, grads1, gen1, calls1 = out[remat]
    assert loss1 == loss0 and grads1.keys() == grads0.keys()
    for name, g in grads0.items():
        torch.testing.assert_close(grads1[name], g, rtol=0, atol=0, msg=name)
    assert torch.equal(gen1, gen0)
    assert calls0 > 0 and calls1 == 2 * calls0
    assert VlmoConfig.from_config(load_config(base + [f"parallel.remat={remat}"])).remat \
        == (remat if remat == "dots" else True)


# ----------------------------------------------------------- checkpoints


def test_checkpoint_of_two_fsdp_ranks_loads_in_one_process(run):
    """The file rank 0 wrote from the two fsdp ranks' shards loads into one
    process whole: its parameters are the ranks' after their step, and its
    AdamW moments the one process's own step's."""
    path = run["ranks"][0]["fsdp"]["saved"]
    tr = Trainer(load_config(STEP + ["data.batch_size=8", f"exp_dir={path}/.."]),
                 device="cpu")
    restored = ckpt_lib.auto_load(os.path.dirname(path), tr.state, tr.cfg)
    assert restored is not None and restored[1] == 1 and tr.state.step == 1
    sd = tr.task.state_dict()
    for k in PARAMS:
        _close(sd[k], run["ranks"][0]["fsdp"]["params"][k], rtol=0, atol=0, what=k)
    got = tr.state.optimizer.full_state_dict()["state"][0]["exp_avg"]
    _close(got, run["one"]["step"]["moments"]["state"][0]["exp_avg"], what="exp_avg")


def test_checkpoint_of_one_process_loads_into_two_fsdp_ranks(run):
    """The one process's checkpoint, read by two fsdp ranks, each taking its
    shards: the whole parameters and moments are the file's."""
    sd, _ = ckpt_lib.read_checkpoint(os.path.join(run["saved_one"], "checkpoint-0"))
    got = run["ranks"][0]["load_fsdp"]
    assert int(got["loaded_epoch"]) == 1 and int(got["loaded_step"]) == 1
    for k in PARAMS:
        _close(got["loaded"][k], sd["model"][k], rtol=0, atol=0, what=k)
    _close(got["loaded_moments"], sd["optimizer"]["state"][0]["exp_avg"], rtol=0, atol=0)


# ----------------------------------------------------- the VQA submission


def test_two_ranks_merge_the_submission_in_rank_order(run):
    """Each rank writes its stride of the test split; rank 0 merges the
    parts in rank order. The answers are the one process's (which
    `test_write_vqa_submission_matches_jax` holds to JAX's), question by
    question, and the order is JAX's multi-process one: process 0's part,
    then process 1's."""
    path = run["ranks"][0]["vqa"]["submission"]
    assert path.endswith("vqa_submit.json")
    assert run["ranks"][1]["vqa"]["submission"].endswith("vqa_submit_1.json")
    merged = json.load(open(path))
    parts = [json.load(open(os.path.join(os.path.dirname(path), f"vqa_submit_{r}.json")))
             for r in range(WORLD)]
    assert merged == parts[0] + parts[1] and len(parts[0]) == len(parts[1]) > 0
    one = {r["question_id"]: r["answer"] for r in run["one"]["submission"]}
    assert {r["question_id"]: r["answer"] for r in merged} == one


# --------------------------------------------------------- mesh serving


def test_mesh_serving_matches_one_device_and_jax(run, eight_devices):
    """`Predictor(devices=["cpu", "cpu"])` keeps a replica on each device,
    rounds the bucket up to a multiple of them and runs an equal shard on
    each: the same ITC embeddings as one device and as JAX's `Predictor`
    over a data mesh of 2, at 5 rows (a bucket of 8, shards of 4), from
    JAX's initial weights of the ITC case."""
    r = np.random.default_rng(0)
    img = r.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    mesh = jax_create_mesh(devices=eight_devices[:2], data=2)
    jpred = JaxPredictor(jax_load_config(ITC), run["jax_params"], max_batch=8, mesh=mesh)
    want = jpred.encode_image(img)
    two = Predictor(load_config(ITC), run["weights"]["itc"], max_batch=8, device="cpu",
                    devices=["cpu", "cpu"])
    single = Predictor(load_config(ITC), run["weights"]["itc"], max_batch=8, device="cpu")
    assert len(two.replicas) == 2 and two.replicas[0][1] is not two.replicas[1][1]
    shards = []
    fn = two._encode_image_fn
    two._encode_image_fn = lambda x: (shards.append(x.shape[0]), fn(x))[1]
    got = two.encode_image(img)
    assert shards == [4, 4]
    np.testing.assert_allclose(got, single.encode_image(img), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- timing


def test_timing_fences_on_a_read_of_the_output():
    """`timeit` calls the step warm-up plus timed times, fences each phase
    with a host read of one element, and returns seconds an iteration."""
    calls = []

    def step():
        calls.append(1)
        time.sleep(0.002)
        return {"loss": torch.ones(3)}

    secs = timing.timeit(step, 2, 5)
    assert len(calls) == 7 and 0.002 <= secs < 0.5
    timing.sync({"a": [torch.zeros(2)]})
    timing.sync(None)
    timing.sync({"n": 1})


def test_the_module_runs_its_ranks_within_budget(run):
    assert run["child_s"] < 120
