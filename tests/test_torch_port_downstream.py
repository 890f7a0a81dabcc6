"""The PyTorch port's pretrain_vis, finetune_nlvr2 and finetune_retrieval
training against the JAX package, on the CPU.

At a small width (vlmo_debug: depth 2, width 96, 3 heads; 48^2 images, 12
tokens, batch 2) in fp32, with attention dropout and DropPath off (JAX's
`deterministic=True`, the port's `rng=None`): the same synthetic batches from
both packages' loaders and the same seeded flax parameters (JAX's init,
through `from_flax_params`) give the port's MIM (pretrain_vis), MAE, NLVR2
and ITC + IRTR (finetune_retrieval) losses within 1e-5 relative and every
gradient within 1e-4 relative L2 of `jax.value_and_grad` (a bias against its
layer's weight gradient); the trainable,
frozen and learning-rate groups of each phase match JAX's optimizer;
`adjust_downstream_params`, the importer on NLVR2 and rank-head names, the
NLVR2 dev/test buckets of the evaluation, and each phase through `main`.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.data.datamodule import MultiTaskData
from exploremultimodal_tpu.models import import_torch as jimport
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.models.task import adjust_downstream_params as jax_adjust
from exploremultimodal_tpu.models.task import build_model as jax_build_model
from exploremultimodal_tpu.models.task import total_loss as jax_total_loss
from exploremultimodal_tpu.ops.preprocess import preprocess_batch as jax_preprocess_batch
from exploremultimodal_tpu.train import optim as joptim
from exploremultimodal_torch.config import VlmoConfig, load_config
from exploremultimodal_torch.data.datasets import build_dataset
from exploremultimodal_torch.data.pipeline import Loader
from exploremultimodal_torch.main import main as port_main
from exploremultimodal_torch.models import dvae as pdvae
from exploremultimodal_torch.models import import_torch as pimport
from exploremultimodal_torch.models.convert import from_flax_params
from exploremultimodal_torch.models.task import (
    VlmoTask,
    adjust_downstream_params,
    total_loss,
)
from exploremultimodal_torch.objectives.losses import patchify
from exploremultimodal_torch.ops.preprocess import preprocess_batch
from exploremultimodal_torch.train import optim as poptim
from exploremultimodal_torch.train.trainer import Trainer

BATCH, IMG, TEXT_LEN = 2, 48, 12
TINY = [
    "model=vlmo_debug", f"model.img_size={IMG}", f"model.max_text_len={TEXT_LEN}",
    "compute_dtype=float32", "train.datasets=[synthetic]", f"data.batch_size={BATCH}",
    "data.synthetic_size=6", "data.num_mask_patches=3", "data.min_mask_patches_per_block=1",
    "train.discrete_vae_type=random", "model.attn_drop_rate=0.0",
    "model.drop_path_rate=0.0", "model.drop_rate=0.0", "attn_impl=recompute",
]
DROPOUT_OFF = ("model.attn_drop_rate", "model.drop_path_rate", "model.drop_rate", "attn_impl")
# (phase, extra overrides): pretrain_vis trains MIM by default and MAE
# under train.loss_names=[mae]
VARIANTS = {
    "mim": ["train=pretrain_vis"],
    "mae": ["train=pretrain_vis", "train.loss_names=[mae]"],
    "nlvr2": ["train=finetune_nlvr2"],
    "retrieval": ["train=finetune_retrieval"],
}
LOSSES = {"mim": {"mim_task_loss"}, "mae": {"mae_task_loss"},
          "nlvr2": {"nlvr2_task_loss"}, "retrieval": {"itc_task_loss", "irtr_task_loss"}}


def _overrides(variant):
    return TINY + VARIANTS[variant]


@pytest.fixture
def narrow_dvae(monkeypatch):
    """The trainer's random dVAE at n_hid 16 (its labels are not compared
    here; the full width costs seconds to initialise)."""
    monkeypatch.setattr(pdvae, "DalleEncoder", functools.partial(pdvae.DalleEncoder, n_hid=16))


def _host_batch(variant):
    """The first batch of the port's training loader, with MIM labels (the
    dVAE's codes, drawn here from a seeded generator) for pretrain_vis."""
    cfg = load_config(_overrides(variant))
    loader = Loader(build_dataset(cfg), BATCH, seed=int(cfg["seed"]))
    batch = {k: v for k, v in next(loader.epoch(0)).items() if k != "index"}
    if variant == "mim":
        grid = (IMG // 16) ** 2
        batch["mim_labels"] = np.random.default_rng(7).integers(
            0, 8192, (BATCH, grid)).astype(np.int32)
    return batch


def _jitter(params):
    """Non-zero biases and LayerNorm affines, so every leaf's conversion
    shows."""
    rng = np.random.default_rng(3)

    def jitter(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x, np.float32)
        if "bias" in name or "mask_token" in name:
            return x + rng.normal(0.0, 0.02, x.shape).astype(np.float32)
        if "scale" in name:
            return x + rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(jitter, jax.device_get(params))


@pytest.fixture(scope="module")
def setups():
    """Per variant: the host batch, its preprocessed model batch (numpy) and
    JAX's jitted init of the phase's task on it."""
    out = {}
    for variant in VARIANTS:
        host = _host_batch(variant)
        mb = {k: v.numpy() for k, v in preprocess_batch(
            {k: torch.from_numpy(v) for k, v in host.items()}).items()}
        task = jax_build_model(jax_load_config(_overrides(variant)))
        jb = {k: jnp.asarray(v) for k, v in mb.items()}
        init = jax.jit(lambda key, b, t=task: t.init(
            {"params": key, "sample": jax.random.key(1)}, b, method=JaxTask.init_streams))
        out[variant] = (host, mb, task, _jitter(init(jax.random.key(0), jb)["params"]))
    return out


@pytest.mark.parametrize("variant", ["mim", "nlvr2", "retrieval"])
def test_synthetic_batches_match_jax(variant, narrow_dvae):
    """The port's loader gives the batches of JAX's
    `MultiTaskData(...).train_loader()`: the same keys (NLVR2's image pair
    and answers, retrieval's false captions), dtypes and values, two
    epochs; and the preprocessing of one batch equals JAX's."""
    cfg = _overrides(variant)
    loader = MultiTaskData(jax_load_config(cfg)).train_loader()
    loader.num_workers = 1
    trainer = Trainer(load_config(cfg), device="cpu")
    assert len(loader) == trainer.steps_per_epoch == 3
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        for want, got in zip(loader, trainer.loader.epoch(epoch)):
            assert set(got) == set(want)
            for key, w in want.items():
                assert got[key].dtype == w.dtype, key
                np.testing.assert_array_equal(got[key], w, err_msg=key)
    keys = {"nlvr2": {"image_0_u8", "image_1_u8", "answers"},
            "retrieval": {"false_text_ids", "false_text_mask"},
            "mim": {"image4dalle_u8", "image_bool_masked_pos"}}[variant]
    assert keys <= set(got)
    if variant == "retrieval":
        assert got["false_text_ids"].shape == (BATCH, 3, TEXT_LEN)
    raw = {k: v for k, v in got.items() if k != "index"}
    want = jax_preprocess_batch({k: jnp.asarray(v) for k, v in raw.items()})
    mine = preprocess_batch({k: torch.from_numpy(v) for k, v in raw.items()})
    assert set(mine) == set(want)
    for key in mine:
        np.testing.assert_array_equal(mine[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_losses_and_gradients_match_jax(setups, variant):
    """The phase's losses, accuracies and counts, and every parameter's
    gradient, from the port's plain path against `jax.value_and_grad` of
    JAX's `VlmoTask.__call__` and `total_loss`, fp32: losses within 1e-5
    relative, each gradient within 1e-4 relative L2 (a bias's against its
    layer's weight gradient). The parameters the
    phase never reaches (pretrain_vis's frozen set) have no
    gradient in the port and a zero one in JAX; both trees hold the same
    parameters (no fused expert below the fusion layer)."""
    _, mb, jtask, params = setups[variant]
    jbatch = {k: jnp.asarray(v) for k, v in mb.items()}

    def loss_fn(p):
        out = jtask.apply({"params": p}, jbatch, deterministic=True,
                          rngs={"sample": jax.random.key(2)})
        return jax_total_loss(out), out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    task = VlmoTask(VlmoConfig.from_config(load_config(_overrides(variant))))
    task.load_state_dict(from_flax_params(params), strict=True)
    out = task({k: torch.from_numpy(v) for k, v in mb.items()})
    loss = total_loss(out)
    loss.backward()
    assert {k for k in out if k.endswith("_task_loss")} == LOSSES[variant]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for key in jout:
        if key.endswith(("_task_loss", "_Loss")):
            np.testing.assert_allclose(float(out[key]), float(jout[key]), rtol=1e-5,
                                       err_msg=key)
        elif key.endswith(("_mean_acc", "_count")):
            assert float(out[key]) == float(jout[key]), key
    if variant == "nlvr2":
        np.testing.assert_allclose(out["nlvr2_logits"].detach().numpy(),
                                   np.asarray(jout["nlvr2_logits"]), rtol=1e-5, atol=1e-6)

    want = from_flax_params(jgrads)
    got = {k: p.grad for k, p in task.named_parameters()}
    assert set(got) == set(want)
    unreached = {k for k, g in got.items() if g is None}
    assert len(unreached) < len(got)
    for name, g in got.items():
        w = want[name].numpy()
        if g is None:
            assert not w.any(), name
            continue
        # a bias's gradient sums its layer's output gradient over the rows,
        # which cancels where the loss ignores a shift (IRTR's rank bias
        # under the softmax over a row's scores is zero, ITC's projection
        # biases nearly so): held against its layer's weight gradient
        scale = np.linalg.norm(w)
        weight = name[: -len("bias")] + "weight"
        if name.endswith(".bias") and weight in want:
            scale = max(scale, np.linalg.norm(want[weight].numpy()))
        err = np.linalg.norm(g.numpy() - w) / max(scale, 1e-30)
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_trainable_frozen_and_lr_groups_match_jax(setups, variant, narrow_dvae):
    """The trainer's optimizer takes exactly the parameters JAX's
    `split_frozen` leaves trainable for the phase, each with JAX's
    learning-rate multiplier; pretrain_vis freezes the text side, the fused
    experts and the pooler, the finetune phases the image mask token
    alone."""
    params = setups[variant][3]
    jcfg = jax_load_config(_overrides(variant))
    frozen = joptim.phase_frozen_predicate(tuple(jcfg.train.loss_names), jcfg.train.phase,
                                           jcfg.train.get("mim_head_pos", "img"))
    pfrozen = poptim.phase_frozen_predicate(tuple(jcfg.train.loss_names), jcfg.train.phase,
                                            jcfg.train.get("mim_head_pos", "img"))
    jtrain, jfrozen = joptim.split_frozen(params, frozen)
    jm = joptim.lr_multipliers(jtrain, jcfg.model.fusion_layer, jcfg.model.depth,
                               lr_mult_head=jcfg.train.lr_mult_head,
                               lr_mult_fusion=jcfg.train.lr_mult_fusion)
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}

    def torch_path(path):
        *mods, name = joptim._path_str(path).split("/")
        return "/".join(mods + [leaf.get(name, name)])

    jmults = {torch_path(p): float(m) for p, m in jax.tree_util.tree_flatten_with_path(jm)[0]}
    jfrozen_paths = set() if jfrozen is None else {
        torch_path(p) for p, _ in jax.tree_util.tree_flatten_with_path(jfrozen)[0]}

    trainer = Trainer(load_config(_overrides(variant)), device="cpu")
    named = dict(trainer.task.named_parameters())
    assert {poptim.flax_path(n) for n, p in named.items() if not p.requires_grad} \
        == jfrozen_paths
    by_param = {id(p): g["lr_mult"] for g in trainer.state.optimizer.torch.param_groups
                for p in g["params"]}
    got = {poptim.flax_path(n): by_param[id(p)] for n, p in named.items() if p.requires_grad}
    assert got == jmults
    for path in set(jmults) | jfrozen_paths:
        assert (pfrozen is not None and pfrozen(path)) == (frozen is not None and frozen(path))
    if variant in ("mim", "mae"):
        assert {"transformer/txt_embeddings/word_embeddings/weight",
                "transformer/blocks_0/mlp_l/fc1/weight", "transformer/blocks_1/mlp_vl/fc1/weight",
                "transformer/pooler/dense/weight"} <= jfrozen_paths
        assert not any("mlp_v/" in p or "patch_embed" in p for p in jfrozen_paths)
    else:
        assert jfrozen_paths == {"transformer/img_mask_token"}


def test_token_types_and_image_keys(setups):
    """NLVR2's task has 3 token-type rows (2 elsewhere), and `infer` reads
    `image_<idx - 1>` at token type idx, falling back to `image`; MAE's
    patchify follows the patch embedding's order."""
    task = VlmoTask(VlmoConfig.from_config(load_config(_overrides("nlvr2"))))
    assert task.transformer.token_type_embeddings.weight.shape[0] == 3
    vis = VlmoTask(VlmoConfig.from_config(load_config(_overrides("mim"))))
    assert vis.transformer.token_type_embeddings.weight.shape[0] == 2
    _, mb, _, _ = setups["nlvr2"]
    batch = {k: torch.from_numpy(v) for k, v in mb.items()}
    a = task.infer(batch, image_token_type_idx=2)["co_feats"]
    pair = {**batch, "image_1": batch["image"]}
    b = task.infer({k: v for k, v in pair.items() if k != "image_0"},
                   image_token_type_idx=2)["co_feats"]
    assert not torch.equal(a, b)
    no_pair = {k: v for k, v in batch.items() if k not in ("image_0", "image_1")}
    c = task.infer(no_pair, image_token_type_idx=1)["co_feats"]
    d = task.infer({**no_pair, "image_0": batch["image"]}, image_token_type_idx=1)["co_feats"]
    assert torch.equal(c, d)
    img = torch.arange(2 * 32 * 32 * 3, dtype=torch.float32).reshape(2, 32, 32, 3)
    p = patchify(img, 16)
    assert p.shape == (2, 4, 768)
    assert torch.equal(p[1, 2], img[1, 16:32, 0:16].reshape(-1))


def test_adjust_downstream_params_matches_jax(setups):
    """The rank head takes the ITM head's match row where the task has both
    (as JAX's function does on its tree); without the ITM head, or without
    IRTR among the losses, the state dict is returned as it is."""
    overrides = _overrides("retrieval") + ["train.loss_names=[itc,itm,irtr]"]
    jtask = jax_build_model(jax_load_config(overrides))
    _, mb, _, _ = setups["retrieval"]
    params = _jitter(jax.jit(lambda k: jtask.init(
        {"params": k, "sample": jax.random.key(1)},
        {k2: jnp.asarray(v) for k2, v in mb.items()}, method=JaxTask.init_streams))(
            jax.random.key(4))["params"])
    want = from_flax_params(jax_adjust(dict(params), ("itc", "itm", "irtr")))
    sd = from_flax_params(params)
    got = adjust_downstream_params(sd, ("itc", "itm", "irtr"))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(got["rank_output.fc.weight"].numpy(),
                                  sd["itm_head.fc.weight"][1:2].numpy())
    assert not torch.equal(got["rank_output.fc.weight"], sd["rank_output.fc.weight"])
    assert adjust_downstream_params(sd, ("itc", "itm")) is sd
    plain = {k: v for k, v in sd.items() if not k.startswith("itm_head")}
    assert adjust_downstream_params(plain, ("itc", "irtr")) is plain


def _pth_state(rng, hs, rows):
    """A VLMo-named torch state dict with NLVR2's and IRTR's heads."""
    def t(*shape):
        return torch.from_numpy(rng.normal(0, 0.02, shape).astype(np.float32))

    return {
        "transformer.nlvr2_embedding.weight": t(rows, hs),
        "transformer.pos_embed": t(1, (IMG // 16) ** 2 + 1, hs),
        "nlvr2_classifier.0.weight": t(2 * hs, 2 * hs),
        "nlvr2_classifier.0.bias": t(2 * hs),
        "nlvr2_classifier.1.weight": t(2 * hs),
        "nlvr2_classifier.1.bias": t(2 * hs),
        "nlvr2_classifier.3.weight": t(2, 2 * hs),
        "nlvr2_classifier.3.bias": t(2),
        "rank_output.weight": t(1, hs),
        "rank_output.bias": t(1),
        "transformer.blocks.0.mlp.vl.fc1.weight": t(4 * hs, hs),
    }


@pytest.mark.parametrize("variant,rows", [("nlvr2", 3), ("nlvr2", 2), ("retrieval", 2)])
def test_import_torch_matches_jax(setups, variant, rows):
    """`import_torch_state` of a `.pth` state dict with `nlvr2_embedding`,
    `nlvr2_classifier.*` and `rank_output.*` against JAX's importer on the
    same task: the same loaded keys, missing paths and values. The alias
    loads where its rows fit the task's table (3 into NLVR2's, 2 into
    retrieval's); a 2-row table does not fit NLVR2's 3-row one and stays at
    its init in both (JAX skips a shape mismatch; the original VLMo copies
    rows)."""
    params = setups[variant][3]
    hs = 96
    state = _pth_state(np.random.default_rng(rows), hs, rows)
    jnew, jloaded, jmissing = jimport.import_torch_state(
        {k: v.numpy() for k, v in state.items()}, params, max_text_len=TEXT_LEN)
    target = from_flax_params(params)
    new, loaded, missing = pimport.import_torch_state(state, target, max_text_len=TEXT_LEN)
    assert sorted(loaded) == sorted(jloaded) and missing == jmissing
    want = from_flax_params(jnew)
    assert set(new) == set(want)
    for k in new:
        np.testing.assert_array_equal(new[k].numpy(), want[k].numpy(), err_msg=k)
    tt = "transformer.token_type_embeddings.weight"
    if rows == target[tt].shape[0]:  # the alias loads at its own shape
        assert "transformer.nlvr2_embedding.weight" in loaded
        np.testing.assert_array_equal(new[tt].numpy(),
                                      state["transformer.nlvr2_embedding.weight"].numpy())
    else:
        assert "transformer.nlvr2_embedding.weight" not in loaded
        assert torch.equal(new[tt], target[tt])
    if variant == "nlvr2":
        np.testing.assert_array_equal(new["nlvr2_classifier.fc1.weight"].numpy(),
                                      state["nlvr2_classifier.0.weight"].numpy())
    if variant == "retrieval":
        np.testing.assert_array_equal(new["rank_output.fc.weight"].numpy(),
                                      state["rank_output.weight"].numpy())


def test_nlvr2_eval_buckets_by_table_name(monkeypatch):
    """`evaluate` of finetune_nlvr2: where a batch carries `table_name`s, the
    accuracy of its dev and of its test rows, weighed by their number, as
    JAX's evaluation adds them; without them, no bucket."""
    trainer = Trainer(load_config(_overrides("nlvr2")), device="cpu")
    plain = trainer.evaluate()
    assert "nlvr2_mean_acc" in plain and not any("_dev_" in k for k in plain)
    dataset = trainer.val_loader.dataset
    getitem = type(dataset).__getitem__
    names = ["nlvr2_dev", "nlvr2_test1", "nlvr2_dev", "nlvr2_test1", "nlvr2_test1", "nlvr2_dev"]

    def with_table(self, index):
        return {**getitem(self, index), "table_name": names[index]}

    monkeypatch.setattr(type(dataset), "__getitem__", with_table)
    got = trainer.evaluate()
    preds, answers, tables = [], [], []
    generator = torch.Generator().manual_seed(0)
    for batch in trainer.val_loader.epoch(0):
        _, _, extra = trainer.eval_step(batch, generator)
        preds += extra["nlvr2_logits"].argmax(-1).tolist()
        answers += batch["answers"].tolist()
        tables += batch["table_name"]
    for bucket in ("dev", "test"):
        sel = [i for i, t in enumerate(tables) if bucket in t]
        want = np.mean([preds[i] == answers[i] for i in sel])
        np.testing.assert_allclose(got[f"nlvr2_{bucket}_acc"], want, rtol=1e-12)
    np.testing.assert_allclose(got["nlvr2_mean_acc"], plain["nlvr2_mean_acc"], rtol=1e-12)


@pytest.mark.parametrize("variant", ["mim", "nlvr2", "retrieval"])
def test_main_trains_each_phase(tmp_path, variant, monkeypatch, narrow_dvae):
    """`main` with `device=cpu` trains the phase for one epoch with its
    evaluation and checkpoint, with dropout on; finetune_retrieval then
    logs recall@{1,5,10} on the val split."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    overrides = [x for x in _overrides(variant) if x.split("=")[0] not in DROPOUT_OFF] + [
        "train.epochs=1", "device=cpu", f"output_dir={tmp_path}"]
    assert port_main(overrides) == 0
    phase = VARIANTS[variant][0].split("=")[1]
    exp = tmp_path / phase / "vlmo_debug" / "default"
    (run,) = os.listdir(exp)
    assert os.path.isdir(exp / run / "checkpoint-0")
    (line,) = [json.loads(x) for x in open(exp / run / "log_stats.json")]
    assert all(np.isfinite(v) for v in line.values())
    log = open(exp / run / "log_p0.txt").read()
    assert ("retrieval recall: {'i2t_recall@1'" in log) == (variant == "retrieval")
