"""The PyTorch port's checkpoints, weight import and serving from a
checkpoint, on the CPU.

`train/checkpoints.py`: the round trip and the resume policy of
`tests/test_trainer_e2e.py` (retention of the best and the latest, a full
resume bit for bit, a tag mismatch that keeps only the parameters), the
restarts across timestamped runs and the subrun scan, a resumed run that
ends where an uninterrupted one ends with dropout on, and `file://`
resumes with the sha256 checks. `models/import_torch.py` against JAX's
importer on synthetic BEiT and VLMo state dicts. `Predictor.from_checkpoint`
against JAX's `Predictor` on the same `.pth`, and on a checkpoint directory
of the port's trainer.
"""

import glob
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.infer import _vqa_fn
from exploremultimodal_tpu.models import import_torch as jimport
from exploremultimodal_tpu.models.task import VlmoConfig as JaxVlmoConfig
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.models.task import build_model as jax_build_model
from exploremultimodal_torch.config import VlmoConfig, load_config
from exploremultimodal_torch.infer import Predictor
from exploremultimodal_torch.models import import_torch as pimport
from exploremultimodal_torch.models.convert import from_flax_params
from exploremultimodal_torch.models.task import VlmoTask
from exploremultimodal_torch.train import checkpoints as ckpt_lib
from exploremultimodal_torch.train.trainer import Trainer

# tests/test_trainer_e2e.py's TINY_OVERRIDES (the port's copy)
TINY_OVERRIDES = [
    "model=vlmo_debug", "train.datasets=[synthetic]", "data.batch_size=8",
    "data.synthetic_size=16", "data.num_workers=2", "model.img_size=32",
    "model.embed_dim=32", "model.num_heads=2", "model.max_text_len=12",
    "model.drop_rate=0.0", "model.attn_drop_rate=0.0", "model.drop_path_rate=0.0",
    "data.num_mask_patches=2", "data.min_mask_patches_per_block=1",
    "train.warmup_steps=1", "train.epochs=2", "compute_dtype=float32",
    "attn_impl=xla",
]
# finetune_vqa with ISDA, so that the checkpoint carries its statistics
VQA_ISDA = TINY_OVERRIDES + ["train=finetune_vqa", "train.isda_lambda=0.5"]
DROPOUT_ON = ["model.drop_rate=0.1", "model.attn_drop_rate=0.1",
              "model.drop_path_rate=0.1"]


def _trainer(overrides, exp_dir, *extra):
    return Trainer(load_config(overrides + [f"exp_dir={exp_dir}", *extra]), device="cpu")


def _assert_same_state(a, b):
    """Parameters, AdamW moments and step counts, the step, the ISDA
    statistics and both generators' states, bit for bit."""
    sa, sb = ckpt_lib.state_dict(a), ckpt_lib.state_dict(b)
    assert sa["step"] == sb["step"]
    assert sa["model"].keys() == sb["model"].keys()
    for k in sa["model"]:
        assert torch.equal(sa["model"][k], sb["model"][k]), k
    oa, ob = sa["optimizer"]["state"], sb["optimizer"]["state"]
    assert oa.keys() == ob.keys() and oa
    for i in oa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
    for k in ("generator", "seed_generator"):
        assert torch.equal(sa[k], sb[k]), k
    assert (sa["isda"] is None) == (sb["isda"] is None)
    for k in (sa["isda"] or {}):
        assert torch.equal(sa["isda"][k], sb["isda"][k]), k


# ------------------------------------------------------------- checkpoints


def test_checkpoint_roundtrip_and_policy(tmp_path):
    """As `test_trainer_e2e.py::test_checkpoint_roundtrip_and_policy`:
    retention keeps the best (0) and the latest (1); a full resume (same
    phase and tag) restores everything bit for bit and gives epoch 2; a tag
    mismatch keeps the parameters, resets the optimizer and takes the epoch
    from the config."""
    out = str(tmp_path / "ck")
    trainer = _trainer(VQA_ISDA, out)
    trainer.step()
    ckpt_lib.save(out, trainer.state, trainer.cfg, epoch=0, is_best=True)
    trainer.step()
    ckpt_lib.save(out, trainer.state, trainer.cfg, epoch=1)
    assert [os.path.basename(p) for _, p in ckpt_lib._scan(out)] == \
        ["checkpoint-0", "checkpoint-1"]
    assert float(trainer.state.isda.count.sum()) == 16

    fresh = _trainer(VQA_ISDA, out)
    restored, next_epoch = ckpt_lib.auto_load(out, fresh.state, fresh.cfg)
    assert next_epoch == 2 and restored is fresh.state
    _assert_same_state(restored, trainer.state)

    other = _trainer(VQA_ISDA, out, "tag=other")
    init = {k: v.clone() for k, v in ckpt_lib.state_dict(other.state)["model"].items()}
    restored2, next_epoch2 = ckpt_lib.auto_load(out, other.state, other.cfg)
    assert next_epoch2 == 0 and restored2.step == 0
    assert not restored2.optimizer.torch.state
    want = trainer.task.state_dict()
    for k, v in restored2.task.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert any(not torch.equal(init[k], want[k]) for k in want)
    assert float(restored2.isda.count.sum()) == 0


def test_an_interrupted_save_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    """A save killed while it writes `state.pt` leaves only
    `checkpoint-1.tmp/`, a truncated file and no meta: the scan skips it, a
    relaunch resumes from checkpoint-0, and the next save of epoch 1
    replaces the leftover."""
    out = str(tmp_path / "ck")
    trainer = _trainer(VQA_ISDA, out)
    trainer.step()
    ckpt_lib.save(out, trainer.state, trainer.cfg, epoch=0)
    trainer.step()

    def killed(obj, path):
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 truncated")
        raise RuntimeError("killed during the save")

    with monkeypatch.context() as m:
        m.setattr(ckpt_lib.torch, "save", killed)
        with pytest.raises(RuntimeError, match="killed"):
            ckpt_lib.save(out, trainer.state, trainer.cfg, epoch=1)
    leftover = os.path.join(out, "checkpoint-1.tmp")
    assert os.listdir(leftover) == [ckpt_lib.STATE_FILE]
    assert [e for e, _ in ckpt_lib._scan(out)] == [0]

    fresh = _trainer(VQA_ISDA, out)
    _, next_epoch = ckpt_lib.auto_load(out, fresh.state, fresh.cfg)
    assert next_epoch == 1 and fresh.state.step == 1

    ckpt_lib.save(out, trainer.state, trainer.cfg, epoch=1)
    assert not os.path.exists(leftover)
    assert [os.path.basename(p) for _, p in ckpt_lib._scan(out)] == ["checkpoint-1"]
    sd, meta = ckpt_lib.read_checkpoint(os.path.join(out, "checkpoint-1"))
    assert sd["step"] == meta["step"] == 2


def test_restart_resumes_across_new_timestamp(tmp_path):
    """As `test_trainer_e2e.py::test_restart_resumes_across_new_timestamp`:
    a relaunch under the same exp_dir with a new run_dir resumes from the
    previous run's checkpoint; with no epoch left it trains nothing; one
    more epoch continues from the restored state."""
    exp = str(tmp_path / "exp")
    base = TINY_OVERRIDES + ["train=pretrain_txt", f"exp_dir={exp}"]

    def run(stamp, epochs):
        cfg = load_config(base + [f"run_dir={exp}/{stamp}", f"train.epochs={epochs}"])
        return Trainer(cfg, device="cpu").train()

    result1 = run("20260101-000000", 1)
    steps_run1 = result1["state"].step
    assert steps_run1 > 0
    assert os.path.isdir(os.path.join(exp, "20260101-000000", "checkpoint-0"))
    result2 = run("20260102-000000", 1)
    assert result2["history"] == [] and result2["state"].step == steps_run1
    assert result2["times"]["load_s"] is not None
    result3 = run("20260103-000000", 2)
    assert len(result3["history"]) == 1 and result3["history"][0]["epoch"] == 1
    assert result3["state"].step == 2 * steps_run1
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(exp, "*", "checkpoint-*")))
    assert "checkpoint-1" in names


def test_checkpoint_scan_across_timestamped_subruns(tmp_path):
    exp = tmp_path / "exp"
    (exp / "20260101-000000" / "checkpoint-3").mkdir(parents=True)
    (exp / "20260102-000000" / "checkpoint-5").mkdir(parents=True)
    (exp / "checkpoint-1").mkdir()
    hits = ckpt_lib._scan(str(exp))
    assert [e for e, _ in hits] == [1, 3, 5]
    assert hits[-1][1].endswith("20260102-000000/checkpoint-5")


def test_resumed_run_ends_where_an_uninterrupted_one_ends(tmp_path):
    """With every dropout on (hidden, attention, DropPath) and ISDA, two
    epochs in one run, and one epoch then a relaunch that resumes for the
    second, end in the same state bit for bit: the generators' states carry
    the dropout draws across the restart."""
    overrides = VQA_ISDA + DROPOUT_ON
    whole = _trainer(overrides, tmp_path / "whole").train()
    split = tmp_path / "split"
    _trainer(overrides, split, f"run_dir={split}/a", "train.epochs=1").train()
    resumed = _trainer(overrides, split, f"run_dir={split}/b").train()
    assert [h["epoch"] for h in resumed["history"]] == [1]
    _assert_same_state(resumed["state"], whole["state"])
    assert resumed["history"][0] == whole["history"][1]


def test_url_checkpoint_resume_via_file_url(tmp_path, monkeypatch):
    """`train.resume` as a file:// URL of a `.pth` is fetched into
    EMM_CKPT_CACHE and imported: q_bias + 1.25 arrives in the parameters;
    a second fetch resolves to the cached file."""
    monkeypatch.setenv("EMM_CKPT_CACHE", str(tmp_path / "ckpt_cache"))
    trainer = _trainer(TINY_OVERRIDES + ["train=pretrain_txt"], tmp_path / "run")
    key = "transformer.blocks.0.attn.q_bias"
    q_bias = trainer.task.state_dict()[key].clone()
    pth = tmp_path / "remote_ckpt.pth"
    torch.save({"model": {"blocks.0.attn.q_bias": q_bias + 1.25}}, str(pth))
    trainer.cfg["train"]["resume"] = f"file://{pth}"
    out = ckpt_lib.auto_load(str(tmp_path / "run"), trainer.state, trainer.cfg)
    assert out is not None and out[1] == 0
    torch.testing.assert_close(trainer.task.state_dict()[key], q_bias + 1.25,
                               rtol=1e-6, atol=0)
    cached = ckpt_lib._fetch_url_checkpoint(f"file://{pth}")
    assert cached.startswith(str(tmp_path / "ckpt_cache"))


def test_url_checkpoint_integrity(tmp_path, monkeypatch):
    """As `test_trainer_e2e.py::test_url_checkpoint_integrity`: plain http
    refused; a sha256 mismatch discards the download; an explicit digest
    and a torch.hub-style name prefix pass; torch files are told by
    content."""
    monkeypatch.setenv("EMM_CKPT_CACHE", str(tmp_path / "cache"))
    with pytest.raises(ValueError, match="http"):
        ckpt_lib._fetch_url_checkpoint("http://example.com/ckpt.pth")

    payload = tmp_path / "weights.pth"
    torch.save({"model": {}}, str(payload))
    digest = hashlib.sha256(payload.read_bytes()).hexdigest()
    with pytest.raises(ValueError, match="sha256"):
        ckpt_lib._fetch_url_checkpoint(f"file://{payload}", sha256="0" * 64)
    assert not any((tmp_path / "cache").glob("*weights.pth"))
    assert os.path.exists(ckpt_lib._fetch_url_checkpoint(f"file://{payload}",
                                                         sha256=digest))
    named = tmp_path / f"weights-{digest[:8]}.pth"
    named.write_bytes(payload.read_bytes())
    assert os.path.exists(ckpt_lib._fetch_url_checkpoint(f"file://{named}"))
    bad = tmp_path / "weights-deadbeef.pth"
    bad.write_bytes(payload.read_bytes())
    with pytest.raises(ValueError, match="sha256"):
        ckpt_lib._fetch_url_checkpoint(f"file://{bad}")

    noext = tmp_path / "download_no_ext"
    noext.write_bytes(payload.read_bytes())
    assert ckpt_lib._is_torch_file(str(noext))
    legacy = tmp_path / "legacy"
    with open(legacy, "wb") as f:
        torch.save({"model": {}}, f, _use_new_zipfile_serialization=False)
    assert ckpt_lib._is_torch_file(str(legacy))
    text = tmp_path / "plain.txt"
    text.write_text("hello")
    assert not ckpt_lib._is_torch_file(str(text))
    assert not ckpt_lib._is_torch_file(str(tmp_path))


# ------------------------------------------------------------- weight import

IMPORT_CFG = dict(
    img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
    max_text_len=12, vocab_size=64, fusion_layer=1, init_values=0.1,
    drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0,
    loss_names=("mim",), phase="pretrain_mum", img_vocab_size=24)


@pytest.fixture(scope="module")
def import_params():
    task = JaxTask(JaxVlmoConfig(**IMPORT_CFG))
    batch = {
        "image": jnp.zeros((1, 32, 32, 3)),
        "text_ids": jnp.zeros((1, 12), jnp.int32),
        "text_mask": jnp.ones((1, 12), jnp.int32),
        "image_bool_masked_pos": jnp.zeros((1, 4), jnp.int32),
        "mim_labels": jnp.zeros((1, 4), jnp.int32),
    }
    init = jax.jit(lambda k: task.init({"params": k, "sample": jax.random.key(1)},
                                       batch, method=JaxTask.init_streams))
    return jax.device_get(init(jax.random.key(0))["params"])


def _beit_sd(rng):
    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32))

    return {
        "cls_token": t(1, 1, 32), "mask_token": t(1, 1, 32),
        "pos_embed": t(1, 65, 32),  # an 8 x 8 grid, resized to 2 x 2
        "patch_embed.proj.weight": t(32, 3, 16, 16), "patch_embed.proj.bias": t(32),
        "blocks.0.mlp.fc1.weight": t(128, 32), "blocks.0.mlp.fc1.bias": t(128),
        "blocks.0.attn.qkv.weight": t(96, 32), "blocks.1.norm1.weight": t(32),
        "lm_head.weight": t(24, 32), "lm_head.bias": t(24),
        "head.weight": t(10, 32),  # no counterpart: skipped
    }


def _vlmo_sd(rng):
    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32))

    return {
        "module.transformer.pos_embed": t(1, 2, 32),  # a 1 x 1 grid, resized up
        "module.transformer.txt_embeddings.position_embeddings.weight": t(40, 32),
        "module.transformer.txt_embeddings.position_ids": torch.arange(40)[None],
        "module.transformer.txt_embeddings.word_embeddings.weight": t(64, 32),
        "module.transformer.blocks.0.mlp.v_mlp.fc2.weight": t(32, 128),
        "module.transformer.blocks.1.mlp.vl_mlp.fc1.bias": t(128),
        "module.transformer.blocks.1.mlp.l.fc1.weight": t(128, 32),
        "module.transformer.blocks.0.gamma_1": t(32),
        "module.transformer.norm.bias": t(32),
        "module.mim_head.fc.weight": t(24, 32),
        "module.vqa_classifier.0.weight": t(64, 32),  # no such head: skipped
        "module.transformer.blocks.0.attn.proj.weight": t(16, 16),  # wrong shape
    }


@pytest.mark.parametrize("kind", ["beit", "vlmo"])
def test_import_torch_state_matches_jax(import_params, kind):
    """The port's `import_torch_state` on the port's state_dict of the same
    initial weights gives `from_flax_params` of JAX's result: the loaded
    keys and missing paths equal, the imported tensors equal, the
    interpolated position table within 1e-6 (both resize with the same
    antialiased Keys-cubic weights in fp32, summed in other orders) and
    the text position table cut to max_text_len."""
    rng = np.random.default_rng(0 if kind == "beit" else 1)
    sd = _beit_sd(rng) if kind == "beit" else _vlmo_sd(rng)
    assert pimport.detect_beit(sd) == jimport.detect_beit(sd) == (kind == "beit")
    jparams, jloaded, jmissing = jimport.import_torch_state(sd, import_params,
                                                            max_text_len=12)
    target = from_flax_params(import_params)
    task = VlmoTask(VlmoConfig(**IMPORT_CFG))
    task.load_state_dict(target, strict=True)
    got, loaded, missing = pimport.import_torch_state(sd, task.state_dict(),
                                                      max_text_len=12)
    assert loaded == jloaded and missing == jmissing
    assert len(loaded) >= (8 if kind == "beit" else 9)
    want = from_flax_params(jparams)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k == "transformer.pos_embed":
            assert got[k].shape == w.shape == (1, 5, 32)
            torch.testing.assert_close(got[k], w, rtol=0, atol=1e-6)
        else:
            assert torch.equal(got[k], w), k
    assert not torch.equal(got["transformer.pos_embed"], target["transformer.pos_embed"])
    task.load_state_dict(got, strict=True)


# --------------------------------------------------------- serving from one

SERVE = ["model=vlmo_debug", "train=finetune_vqa", "model.img_size=32",
         "model.max_text_len=10", "data.vqav2_label_size=12", "compute_dtype=float32",
         "attn_impl=recompute"]


def _requests(n=4, seed=7):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    mask = np.ones((n, 10), np.int32)
    mask[:, 7:] = 0
    ids = rng.integers(1000, 30522, (n, 10)).astype(np.int32)
    return img, ids, mask


def test_predictor_from_pth_matches_jax(tmp_path):
    """A full VQA state dict in the reference's names (JAX's
    `export_reference_state` of seeded, jittered flax weights) as a `.pth`:
    the port's `Predictor.from_checkpoint` (from the path and from a file://
    URL) against JAX's `Predictor` on JAX's import of the same file, VQA
    logits within 1e-4. (JAX's own `from_checkpoint` passes the config
    where its importer takes `max_text_len` and raises TypeError on a
    `.pth`, so its import is called here as `from_checkpoint` means to.)"""
    jcfg = jax_load_config(SERVE)
    task = jax_build_model(jcfg)
    dummy = {"image": jnp.zeros((1, 32, 32, 3)), "text_ids": jnp.zeros((1, 10), jnp.int32),
             "text_mask": jnp.ones((1, 10), jnp.int32)}
    init = jax.jit(lambda k: task.init({"params": k, "sample": jax.random.key(1)},
                                       dummy, method=JaxTask.init_inference))
    params = jax.device_get(init(jax.random.key(0))["params"])
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + rng.normal(0, 0.02, np.shape(x)).astype(np.float32),
        params)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in jimport.export_reference_state(params).items()}
    pth = tmp_path / "vqa.pth"
    torch.save({"model": sd}, str(pth))

    jparams, _, jmissing = jimport.import_torch_state(
        jimport.load_torch_checkpoint(str(pth)), params, max_text_len=10)
    assert jmissing == []
    vqa = jax.jit(lambda p, *a: task.apply({"params": p}, *a, method=_vqa_fn))
    want = np.asarray(vqa(jparams, *(jnp.asarray(a) for a in _requests())))
    got = Predictor.from_checkpoint(str(pth), SERVE, device="cpu").vqa_logits(*_requests())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EMM_CKPT_CACHE", str(tmp_path / "cache"))
        url = Predictor.from_checkpoint(f"file://{pth}", SERVE, device="cpu")
    np.testing.assert_array_equal(url.vqa_logits(*_requests()), got)


def test_predictor_from_checkpoint_dir_serves_the_trained_weights(tmp_path):
    """A checkpoint directory the port's trainer saved serves exactly the
    logits of `Predictor(cfg, state_dict)` on the trainer's weights."""
    overrides = TINY_OVERRIDES + ["train=finetune_vqa", "train.epochs=1"]
    trainer = _trainer(overrides, tmp_path)
    result = trainer.train()
    (path,) = glob.glob(str(tmp_path / "checkpoint-*"))
    img, ids, mask = _requests()
    ids, mask = np.concatenate([ids, ids[:, :2]], 1), np.ones((4, 12), np.int32)
    want = Predictor(trainer.cfg, result["state"].task.state_dict(),
                     device="cpu").vqa_logits(img, ids, mask)
    got = Predictor.from_checkpoint(path, overrides, device="cpu").vqa_logits(img, ids, mask)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="neither"):
        Predictor.from_checkpoint(str(tmp_path / "log_stats.json"), overrides,
                                  device="cpu")
