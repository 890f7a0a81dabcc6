"""The PyTorch port's pretrain_txt step against the JAX package, on the CPU.

pretrain_txt is the text-only MLM phase (BERT length on the card,
`model.max_text_len=512`). Here at a small width (vlmo_debug: depth 2,
width 96, 3 heads; 48 tokens, batch 2) in fp32: the same synthetic
text-only batches from both packages' loaders, the same seeded flax
parameters through `from_flax_params` into the port, the MLM loss and every
gradient against `jax.value_and_grad` with dropout off (JAX's
`deterministic=True`, the port's `rng=None`), the phase's frozen and fixed
sets against JAX's optimizer, and the command line.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.data.datamodule import MultiTaskData
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.models.task import build_model as jax_build_model
from exploremultimodal_tpu.models.task import total_loss as jax_total_loss
from exploremultimodal_tpu.ops.preprocess import preprocess_batch as jax_preprocess_batch
from exploremultimodal_tpu.train import optim as joptim
from exploremultimodal_torch.config import VlmoConfig, load_config
from exploremultimodal_torch.main import main as port_main
from exploremultimodal_torch.models.convert import from_flax_params
from exploremultimodal_torch.models.task import VlmoTask, total_loss
from exploremultimodal_torch.ops.preprocess import preprocess_batch
from exploremultimodal_torch.train import optim as poptim
from exploremultimodal_torch.train.trainer import Trainer

BATCH, TEXT_LEN = 2, 48
TINY = [
    "model=vlmo_debug", "train=pretrain_txt", f"model.max_text_len={TEXT_LEN}",
    "compute_dtype=float32", "train.datasets=[synthetic]",
    f"data.batch_size={BATCH}", "data.synthetic_size=6",
]
TEXT_KEYS = {"index", "text_ids", "text_mask", "text_ids_mlm", "text_labels_mlm"}


def _impl(attn):
    return TINY + [f"attn_impl={attn}"]


@pytest.fixture(scope="module")
def host_batch():
    """One loader batch of the text-only synthetic data, as the port's
    trainer draws it."""
    return Trainer(load_config(TINY), device="cpu").next_batch()


@pytest.fixture(scope="module")
def flax_params(host_batch):
    """JAX's init of the pretrain_txt model on a text-only batch (the vision
    side included, as JAX's trainer builds it), with non-zero biases and
    LayerNorm affines."""
    task = jax_build_model(jax_load_config(_impl("recompute")))
    batch = {k: jnp.asarray(v) for k, v in host_batch.items() if k != "index"}
    init = jax.jit(lambda key: task.init({"params": key, "sample": jax.random.key(1)},
                                         batch, method=JaxTask.init_streams))
    params = init(jax.random.key(0))["params"]
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


def _port_task(overrides, flax_params) -> VlmoTask:
    task = VlmoTask(VlmoConfig.from_config(load_config(overrides)))
    task.load_state_dict(from_flax_params(flax_params), strict=True)
    return task


def test_text_only_batches_match_jax():
    """The port's loader gives the batches of JAX's
    `MultiTaskData(...).train_loader()` for pretrain_txt: text fields only
    (no image is drawn), same dtypes and values, two epochs."""
    loader = MultiTaskData(jax_load_config(TINY)).train_loader()
    loader.num_workers = 1
    trainer = Trainer(load_config(TINY), device="cpu")
    assert trainer.loader.dataset.text_only
    assert len(loader) == trainer.steps_per_epoch == 6 // BATCH
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        for want, got in zip(loader, trainer.loader.epoch(epoch)):
            assert set(got) == set(want) == TEXT_KEYS
            for key, w in want.items():
                assert got[key].dtype == w.dtype, key
                np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert got["text_ids"].shape == (BATCH, TEXT_LEN)


def test_text_only_preprocess_passes_the_batch_through(host_batch):
    """With no image the preprocessing adds nothing, in both packages."""
    raw = {k: v for k, v in host_batch.items() if k != "index"}
    want = jax_preprocess_batch({k: jnp.asarray(v) for k, v in raw.items()})
    got = preprocess_batch({k: torch.from_numpy(v) for k, v in raw.items()})
    assert set(got) == set(want) == TEXT_KEYS - {"index"}
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("attn", ["recompute", "pallas"])
def test_losses_and_gradients_match_jax(flax_params, host_batch, attn):
    """The MLM loss, its accuracy and count, and the gradient of every
    parameter, from the port's plain path (the recompute chain, or the
    flash kernels' plain versions under `pallas`, JAX's in interpret mode)
    against `jax.value_and_grad` of JAX's `VlmoTask.__call__` and
    `total_loss`, in fp32: the loss within rtol 1e-5, every gradient within
    1e-4 of its largest magnitude (the frameworks sum in other orders
    through two blocks and the 30522-way tied MLM head). The parameters the
    text-only graph never reaches (the phase's frozen set) have no gradient
    in the port and a zero one in JAX."""
    jtask = jax_build_model(jax_load_config(_impl(attn)))
    batch = {k: v for k, v in host_batch.items() if k != "index"}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out = jtask.apply({"params": p}, jbatch, deterministic=True,
                          rngs={"sample": jax.random.key(2)})
        return jax_total_loss(out), out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        flax_params)

    task = _port_task(_impl(attn), flax_params)
    out = task({k: torch.from_numpy(v) for k, v in batch.items()})
    loss = total_loss(out)
    loss.backward()
    assert set(k for k in out if k.endswith("_task_loss")) == {"mlm_task_loss"}
    np.testing.assert_allclose(float(out["mlm_task_loss"]), float(jout["mlm_task_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for key in ("mlm_mean_acc", "mlm_count"):
        assert float(out[key]) == float(jout[key]), key

    want = from_flax_params(jgrads)
    frozen = joptim.phase_frozen_predicate(("mlm",), "pretrain_txt")
    got = {k: p.grad for k, p in task.named_parameters()}
    assert set(got) == set(want)
    unreached = {k for k, g in got.items() if g is None}
    assert unreached == {k for k in got if frozen(poptim.flax_path(k))}
    assert unreached and len(unreached) < len(got)
    for name, g in got.items():
        w = want[name].numpy()
        if g is None:
            assert not w.any(), name
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-6), err_msg=name)


def test_trainable_frozen_and_fixed_sets_match_jax(flax_params):
    """The trainer's optimizer takes the parameters JAX's `split_frozen`
    leaves trainable for pretrain_txt (no patch embedding, image position
    and tokens, vision experts or pooler), and of those gives exactly the
    ones JAX's `fixed_attn` multipliers zero (shared attention, block
    norms, gammas, the final norm) a learning-rate multiplier of 0."""
    jcfg = jax_load_config(TINY)
    frozen = joptim.phase_frozen_predicate(tuple(jcfg.train.loss_names), jcfg.train.phase,
                                           jcfg.train.get("mim_head_pos", "img"))
    jtrain, jfrozen = joptim.split_frozen(flax_params, frozen)
    jm = joptim.lr_multipliers(jtrain, jcfg.model.fusion_layer, jcfg.model.depth,
                               lr_mult_head=jcfg.train.lr_mult_head,
                               lr_mult_fusion=jcfg.train.lr_mult_fusion,
                               freeze_predicate=joptim.fixed_attn_predicate)
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}

    def torch_path(path):  # flax leaf names as from_flax_params renames them
        *mods, name = joptim._path_str(path).split("/")
        return "/".join(mods + [leaf.get(name, name)])

    jmults = {torch_path(path): float(m)
              for path, m in jax.tree_util.tree_flatten_with_path(jm)[0]}
    jfrozen_paths = {torch_path(path) for path, _ in
                     jax.tree_util.tree_flatten_with_path(jfrozen)[0]}

    trainer = Trainer(load_config(TINY), device="cpu")
    task = _port_task(TINY, flax_params)
    assert set(dict(trainer.task.named_parameters())) == set(dict(task.named_parameters()))
    named = dict(trainer.task.named_parameters())
    trainable = {poptim.flax_path(n) for n, p in named.items() if p.requires_grad}
    assert {poptim.flax_path(n) for n, p in named.items() if not p.requires_grad} \
        == jfrozen_paths
    assert trainable == set(jmults)
    by_param = {id(p): g["lr_mult"] for g in trainer.state.optimizer.torch.param_groups
                for p in g["params"]}
    got = {poptim.flax_path(n): by_param[id(p)] for n, p in named.items() if p.requires_grad}
    assert got == jmults
    fixed = {k for k, m in got.items() if m == 0.0}
    assert fixed == {k for k in got if joptim.fixed_attn_predicate(k)}
    assert any("attn" in k for k in fixed) and "transformer/norm/weight" in fixed
    assert all("mlp_l" not in k for k in fixed)


def test_one_step_moves_only_the_text_side(monkeypatch):
    """Two CPU steps with every dropout live: finite metrics, the text
    experts move, the fixed shared attention and the frozen vision side do
    not; the command line takes `train=pretrain_txt` (and `device=cpu`)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trainer = Trainer(load_config(TINY), device="cpu")
    blk = trainer.task.transformer.blocks[0]
    watched = {"mlp_l": blk.mlp_l.fc1.weight, "qkv": blk.attn.qkv.weight,
               "mlp_v": blk.mlp_v.fc1.weight,
               "patch_embed": trainer.task.transformer.patch_embed.weight}
    before = {k: p.detach().clone() for k, p in watched.items()}
    metrics = trainer.train(2)
    for m in metrics:
        assert all(np.isfinite(v) for v in m.values()), m
        assert {"mlm_task_loss", "total_loss", "grad_norm", "lr"} <= set(m)
    moved = {k: not torch.equal(p.detach(), before[k]) for k, p in watched.items()}
    assert moved == {"mlp_l": True, "qkv": False, "mlp_v": False, "patch_embed": False}
    assert port_main(TINY + ["steps=1", "device=cpu"]) == 0
