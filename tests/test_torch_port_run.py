"""The PyTorch port's run around the step against the JAX package, on the CPU.

`Trainer.train` (epochs, the val split's count-weighted evaluation after
each, the best-metric policy, `log_stats.json` and the checkpoints it saves)
of both packages from the same initial weights (JAX's init, carried into
the port through `from_flax_params`), at `tests/test_trainer_e2e.py`'s tiny
shapes with dropout 0, for pretrain_txt and finetune_vqa; `evaluate` with a
val split that does not fill its last batch; the command line's
`eval_mode`, `throughput_mode` and directories; the presets of the model
widths the kernels lack; `check_finite_and_dump`. fp32 on the CPU: losses
and metrics within 1e-5 relative, unless a test says otherwise.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.train.trainer import Trainer as JaxTrainer
from exploremultimodal_torch.config import load_config
from exploremultimodal_torch.main import main as port_main
from exploremultimodal_torch.models.convert import from_flax_params
from exploremultimodal_torch.ops import mlp_fused
from exploremultimodal_torch.train.trainer import Trainer
from exploremultimodal_torch.utils.profiling import NonFiniteLossError, check_finite_and_dump

# the port's copy of tests/test_trainer_e2e.py's TINY_OVERRIDES, with a val
# batch of 6 over the 16 synthetic samples: three batches, the last one
# filled up with the first two samples
TINY_OVERRIDES = [
    "model=vlmo_debug", "train.datasets=[synthetic]", "data.batch_size=8",
    "data.synthetic_size=16", "data.num_workers=2", "model.img_size=32",
    "model.embed_dim=32", "model.num_heads=2", "model.max_text_len=12",
    "model.drop_rate=0.0", "model.attn_drop_rate=0.0", "model.drop_path_rate=0.0",
    "data.num_mask_patches=2", "data.min_mask_patches_per_block=1",
    "train.warmup_steps=1", "train.epochs=2", "compute_dtype=float32",
    "attn_impl=xla",
]
EVAL_BATCH = ["data.eval_batch_size=6"]
RTOL = 1e-5
# the global gradient norm sums every gradient, which the step tests hold to
# 1e-4 of their largest magnitude; it is held to 1e-4 relative here
GRAD_RTOL = 1e-4
PHASES = ("pretrain_txt", "finetune_vqa")


def _close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), atol=1e-7, err_msg=k,
                                   rtol=GRAD_RTOL if "grad_norm" in k else RTOL)


def _jitted_init(init):
    """flax's `Module.init` under one jit: JAX's trainer initializes its
    parameters eagerly, op by op, which costs the test seconds of compiles;
    the parameters it makes are the port's initial ones either way."""
    def jinit(self, rngs, *args, method=None, **kw):
        return jax.jit(lambda r, a: init(self, r, *a, method=method, **kw))(rngs, args)

    return jinit


def _run_both(tmp, phase):
    """Trainer.train of both packages from JAX's initial weights, each in
    its own experiment dir; returns (jax trainer, its result, port trainer,
    its result, the two run dirs)."""
    overrides = TINY_OVERRIDES + EVAL_BATCH + [f"train={phase}"]
    jdir, pdir = str(tmp / "jax"), str(tmp / "port")
    jtrainer = JaxTrainer(jax_load_config(overrides + [f"exp_dir={jdir}"]))
    init = {}
    build = jtrainer.init_state

    def init_state(batch):
        state = build(batch)
        init["params"] = jax.device_get(state.params)  # the step donates the state
        return state

    jtrainer.init_state = init_state
    jresult = jtrainer.train()

    trainer = Trainer(load_config(overrides + [f"exp_dir={pdir}"]), device="cpu")
    trainer.task.load_state_dict(from_flax_params(init["params"]), strict=True)
    result = trainer.train()
    return jtrainer, jresult, trainer, result, jdir, pdir


@pytest.fixture(scope="module", params=PHASES)
def runs(request, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTask, "init", _jitted_init(JaxTask.init))
        return request.param, _run_both(tmp_path_factory.mktemp(request.param),
                                        request.param)


def test_train_matches_jax(runs):
    """Two epochs: each epoch's means and `val_` metrics, the
    `log_stats.json` lines, `best_metric`, the checkpoint directories
    retention keeps and their `meta.json`, and the final step, against
    JAX's."""
    phase, (_, jresult, _, result, jdir, pdir) = runs
    assert len(result["history"]) == len(jresult["history"]) == 2
    for got, want in zip(result["history"], jresult["history"]):
        assert got["epoch"] == want["epoch"]
        _close(got, want)
        assert any(k.startswith("val_") for k in got)
        assert ("val_vqa_mean_score" in got) == (phase == "finetune_vqa")
    np.testing.assert_allclose(result["best_metric"], jresult["best_metric"], rtol=RTOL)
    lines = [[json.loads(x) for x in open(os.path.join(d, "log_stats.json"))]
             for d in (pdir, jdir)]
    for got, want in zip(*lines):
        _close(got, want)
    metas = []
    for d in (pdir, jdir):
        names = sorted(n for n in os.listdir(d) if n.startswith("checkpoint-"))
        metas.append({n: json.load(open(os.path.join(d, n, "meta.json"))) for n in names})
    assert metas[0] == metas[1] and sorted(metas[0]) == ["checkpoint-0", "checkpoint-1"]
    assert result["state"].step == int(jresult["state"].step) == 4
    assert os.path.isfile(os.path.join(pdir, "checkpoint-1", "state.pt"))


def test_evaluate_weighs_a_ragged_val_split_like_jax(runs, monkeypatch):
    """`evaluate` on the trained state: 16 samples in batches of 6, the last
    one filled with samples 0 and 1, each `*_mean_*` weighed by its count;
    and a metric without its count raises KeyError in both packages."""
    _, (jtrainer, jresult, trainer, _, _, _) = runs
    loader = jtrainer.data.val_loader()
    assert len(loader) == len(trainer.val_loader) == 3
    last = list(trainer.val_loader.epoch(0))[-1]["index"]
    assert last.tolist() == [12, 13, 14, 15, 0, 1]
    want = jtrainer.evaluate(jresult["state"], loader)
    got = trainer.evaluate()
    _close(got, want)

    jstep = jtrainer.make_eval_step()
    monkeypatch.setattr(jtrainer, "_eval_step",
                        lambda *a: (lambda out: (out[0], {}, out[2]))(jstep(*a)))
    with pytest.raises(KeyError, match="_count"):
        jtrainer.evaluate(jresult["state"], loader)
    forward = trainer.task.forward

    def drop_counts(*a, **k):
        return {key: v for key, v in forward(*a, **k).items()
                if not key.endswith("_count")}

    monkeypatch.setattr(trainer.task, "forward", drop_counts)
    with pytest.raises(KeyError, match="_count"):
        trainer.evaluate()


def test_main_eval_throughput_and_dirs(tmp_path):
    """`main` with `device=cpu`: a run makes exp_dir/<timestamp> with the
    config and code snapshots, the log and the checkpoints; `eval_mode`
    restores the newest checkpoint and evaluates it (the logged values are
    those of `evaluate` on the restored trainer); `throughput_mode` takes
    steps and saves nothing."""
    base = TINY_OVERRIDES + ["train=finetune_vqa", "device=cpu",
                             f"output_dir={tmp_path}", "train.epochs=1"]
    assert port_main(base) == 0
    exp = tmp_path / "finetune_vqa" / "vlmo_debug" / "default"
    (run,) = os.listdir(exp)
    files = set(os.listdir(exp / run))
    assert {"config.json", "code_snapshot.tar.gz", "log_p0.txt", "log_stats.json",
            "checkpoint-0"} <= files
    cfg = json.load(open(exp / run / "config.json"))
    assert cfg["exp_dir"] == str(exp) and cfg["run_dir"] == str(exp / run)

    assert port_main(base + ["eval_mode=true", f"run_dir={tmp_path / 'eval'}"]) == 0
    log = open(tmp_path / "eval" / "log_p0.txt").read()
    assert "resumed full state" in log and "eval: {" in log
    assert not any(n.startswith("checkpoint-") for n in os.listdir(tmp_path / "eval"))

    assert port_main(base + ["throughput_mode=true", "train=pretrain_txt",
                             "throughput_warmup=1", "throughput_iters=8",
                             f"run_dir={tmp_path / 'tp'}"]) == 0
    assert "samples/s" in open(tmp_path / "tp" / "log_p0.txt").read()
    assert not (tmp_path / "pretrain_txt").exists()
    with pytest.raises(NotImplementedError, match="the port trains"):
        port_main(base + ["train.phase=finetune_unknown"])


def test_throughput_returns_samples_per_second():
    """The warm-up and timed step counts come from the config."""
    trainer = Trainer(load_config(TINY_OVERRIDES + [
        "train=pretrain_txt", "throughput_warmup=1", "throughput_iters=4"]), device="cpu")
    sps = trainer.throughput()
    assert sps > 0 and trainer.state.step == 5


def _meta_mlp(width: int):
    """Meta-device bf16 x (64, width), w1, w2 at a 4x hidden and fp32 biases."""
    x = torch.empty(64, width, dtype=torch.bfloat16, device="meta")
    w1 = torch.empty(4 * width, width, dtype=torch.bfloat16, device="meta")
    w2 = torch.empty(width, 4 * width, dtype=torch.bfloat16, device="meta")
    b1, b2 = (torch.empty(n, device="meta") for n in (4 * width, width))
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("model", ["vlmo_tiny", "vlmo_small", "vlmo_debug"])
def test_fused_mlp_takes_the_presets_widths(model):
    """Rows 6 and 7 take vlmo_tiny's, vlmo_small's and vlmo_debug's widths
    (K = N = 192, 384 and 96, hidden 4x) as JAX's `fits_vmem` sends them to
    its kernel: the sm90 shape check passes there, with and without the
    dropout bits, and raises ValueError at 112, a width no preset has and
    no kernel is built for."""
    width = load_config([f"model={model}"])["model"]["embed_dim"]
    assert width in mlp_fused.WIDTHS and mlp_fused.fits_vmem(width, 4 * width, width)
    args = _meta_mlp(width)
    bits = torch.empty(64, 4 * width, dtype=torch.int16, device="meta")
    assert mlp_fused._sm90_shapes("fused_mlp_fwd", *args) == (64, 4 * width, width)
    assert mlp_fused._sm90_shapes("fused_mlp_fwd_drop", *args, bits) == (64, 4 * width, width)
    with pytest.raises(ValueError, match="N in"):
        mlp_fused.fused_mlp_fwd(*_meta_mlp(112))


def test_profile_steps_writes_a_trace(tmp_path):
    """`profile_steps=2`: the first epoch's fourth and fifth steps run under
    torch.profiler, whose trace lands in `<run dir>/profile`."""
    cfg = load_config(TINY_OVERRIDES + [
        "train=pretrain_txt", "data.synthetic_size=48", "train.epochs=1",
        "profile_steps=2", f"exp_dir={tmp_path}"])
    result = Trainer(cfg, device="cpu").train()
    assert result["state"].step == 6
    trace = json.load(open(tmp_path / "profile" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "step/forward" in names and "step/optimizer" in names


def test_check_finite_and_dump(tmp_path):
    """A finite total loss passes; a NaN one writes nan_dump_step{N}.npz with
    every metric and raises."""
    check_finite_and_dump({"total_loss": torch.tensor(1.5)}, 3, str(tmp_path))
    assert not os.listdir(tmp_path)
    metrics = {"total_loss": torch.tensor(float("nan")), "grad_norm": torch.tensor(2.0),
               "lr": 1e-4}
    with pytest.raises(NonFiniteLossError, match="step 7"):
        check_finite_and_dump(metrics, 7, str(tmp_path))
    dump = np.load(tmp_path / "nan_dump_step7.npz")
    assert set(dump.files) == {"total_loss", "grad_norm", "lr"}
    assert np.isnan(dump["total_loss"]) and float(dump["grad_norm"]) == 2.0
