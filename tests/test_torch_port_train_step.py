"""The PyTorch port's pretrain_mum step against the JAX package, on the CPU.

The same seeded flax parameters go through `from_flax_params` into the port,
and the same numpy batch through JAX's `VlmoTask.__call__` and the port's
`VlmoTask.forward`, at a small width (vlmo_debug: depth 2, width 96, image
64, text 10) in fp32, with dropout off (JAX's `deterministic=True`, the
port's `rng=None`) and the ITM negatives injected on both sides. Then the
optimizer, the schedules, the data and the dVAE tokenizer, each against its
JAX counterpart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.data.datamodule import MultiTaskData
from exploremultimodal_tpu.models.dvae import DalleVAE as JaxDalleVAE
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.models.task import build_model as jax_build_model
from exploremultimodal_tpu.models.task import total_loss as jax_total_loss
from exploremultimodal_tpu.ops.preprocess import preprocess_batch as jax_preprocess_batch
from exploremultimodal_tpu.train import optim as joptim
from exploremultimodal_torch.config import load_config
from exploremultimodal_torch.data.pipeline import collate
from exploremultimodal_torch.main import main as port_main
from exploremultimodal_torch.models.convert import from_flax_params
from exploremultimodal_torch.models.dvae import DalleEncoder
from exploremultimodal_torch.models.task import VlmoTask, total_loss
from exploremultimodal_torch.ops.preprocess import preprocess_batch
from exploremultimodal_torch.train import optim as poptim
from exploremultimodal_torch.train.trainer import Trainer

BATCH = 4
TINY = [
    "model=vlmo_debug", "train=pretrain_mum", "model.img_size=64",
    "model.max_text_len=10", "compute_dtype=float32",
    "train.datasets=[synthetic]", "train.discrete_vae_type=random",
    f"data.batch_size={BATCH}", "data.num_mask_patches=6",
    "data.min_mask_patches_per_block=2", "data.synthetic_size=12",
]
NEG_IMG, NEG_TXT = np.array([2, 0, 3, 1]), np.array([3, 2, 0, 1])
LOSSES = ("i2t_Loss", "t2i_Loss", "itc_task_loss", "mlm_task_loss",
          "mim_task_loss", "itm_task_loss")


def _impl(attn):
    return TINY + [f"attn_impl={attn}"]


@pytest.fixture(scope="module")
def host_batch():
    """One loader batch of the synthetic pretrain data, as the port's
    trainer draws it, with MIM labels from a seeded numpy draw."""
    trainer = Trainer(load_config(TINY), device="cpu")
    batch = trainer.next_batch()
    batch["mim_labels"] = np.random.default_rng(5).integers(
        0, 8192, batch["image_bool_masked_pos"].shape).astype(np.int32)
    return batch


@pytest.fixture(scope="module")
def model_batch(host_batch):
    """The JAX package's preprocessing of the batch, as numpy arrays."""
    raw = {k: v for k, v in host_batch.items() if k != "index"}
    return {k: np.asarray(v) for k, v in jax_preprocess_batch(
        {k: jnp.asarray(v) for k, v in raw.items()}).items()}


@pytest.fixture(scope="module")
def flax_params(model_batch):
    task = jax_build_model(jax_load_config(_impl("recompute")))
    batch = {k: jnp.asarray(v) for k, v in model_batch.items()}
    init = jax.jit(lambda key: task.init({"params": key, "sample": jax.random.key(1)},
                                         batch, method=JaxTask.init_streams))
    params = init(jax.random.key(0))["params"]
    rng = np.random.default_rng(3)

    def jitter(path, x):  # non-zero biases, mask token and LayerNorm affines
        name = jax.tree_util.keystr(path)
        x = np.asarray(x, np.float32)
        if "bias" in name or "mask_token" in name:
            return x + rng.normal(0.0, 0.02, x.shape).astype(np.float32)
        if "scale" in name:
            return x + rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(jitter, jax.device_get(params))


def _inject_negatives(monkeypatch):
    """JAX draws the ITM negatives with `jax.random.categorical`: images for
    each text first, then texts for each image. Replace the draws with the
    given indices, which the port takes as `negatives`."""
    given = iter([NEG_IMG, NEG_TXT])
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.asarray(next(given)))


def _port_task(overrides, flax_params) -> VlmoTask:
    from exploremultimodal_torch.config import VlmoConfig

    task = VlmoTask(VlmoConfig.from_config(load_config(overrides)))
    task.load_state_dict(from_flax_params(flax_params), strict=True)
    return task


@pytest.mark.parametrize("attn", ["recompute", "pallas"])
def test_losses_and_gradients_match_jax(monkeypatch, flax_params, model_batch, attn):
    """Every pretrain_mum loss and the gradient of every parameter, from the
    port's plain path (recompute chain, or the flash kernels' plain
    versions under `pallas`) against `jax.value_and_grad` of JAX's
    `VlmoTask.__call__` and `total_loss`. fp32; losses within rtol 1e-5,
    gradients within 2e-5 + 1e-3 of their magnitude: the frameworks sum in
    other orders through two blocks and the 30522-way tied MLM head."""
    _inject_negatives(monkeypatch)
    jtask = jax_build_model(jax_load_config(_impl(attn)))
    jbatch = {k: jnp.asarray(v) for k, v in model_batch.items()}

    def loss_fn(p):
        out = jtask.apply({"params": p}, jbatch, deterministic=True,
                          rngs={"sample": jax.random.key(2)})
        return jax_total_loss(out), out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        flax_params)

    task = _port_task(_impl(attn), flax_params)
    out = task({k: torch.from_numpy(v) for k, v in model_batch.items()},
               negatives=(NEG_IMG, NEG_TXT))
    loss = total_loss(out)
    loss.backward()
    for key in LOSSES:
        np.testing.assert_allclose(float(out[key]), float(jout[key]), rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for key in ("itm_mean_acc", "mlm_count", "mim_count"):
        assert float(out[key]) == float(jout[key]), key

    want = from_flax_params(jgrads)
    got = {k: p.grad for k, p in task.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=2e-5 + 1e-3 * np.abs(w).max(), err_msg=name)


def _optimizer_pair(overrides, flax_params, steps_per_epoch):
    jcfg = jax_load_config(overrides)
    tx, jsched = joptim.create_optimizer(jcfg, flax_params, steps_per_epoch)
    task = _port_task(overrides, flax_params)
    named = dict(task.named_parameters())
    opt, psched = poptim.create_optimizer(load_config(overrides), named,
                                          steps_per_epoch)
    return tx, jsched, task, opt, psched


@pytest.mark.parametrize("extra", [
    [],  # pretrain_mum as configured: linear schedule, wd 0.01, no clip
    ["train.lr_scheduler.name=cosine", "train.weight_decay_end=0.1",
     "train.clip_grad=0.5", "train.lr_mult_head=2.0", "train.lr_mult_fusion=3.0"],
])
def test_adamw_steps_match_create_optimizer(flax_params, extra):
    """Three AdamW steps from the same parameters and the same gradients
    (seeded normals, so the moments differ from step to step) through the
    port's `Optimizer` and JAX's `create_optimizer` chain: each step's
    parameter change within 1e-4 of the step's learning rate. The warm-up
    is cut to 2 steps and the base rate raised, so that every step moves the
    fp32 weights by far more than their rounding."""
    overrides = TINY + ["train.warmup_steps=2", "train.base_lr=1e-2",
                        "train.warmup_lr=1e-3", "train.epochs=2"] + extra
    tx, jsched, task, opt, psched = _optimizer_pair(overrides, flax_params, 5)
    jparams = jax.tree_util.tree_map(jnp.asarray, flax_params)
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(11)
    named = dict(task.named_parameters())
    for t in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)
                                  * 0.1), flax_params)
        before = {k: p.detach().clone() for k, p in named.items()}
        for name, g in from_flax_params(grads).items():
            named[name].grad = g
        opt.step(t)
        updates, jstate = update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        lr = psched(t)
        assert lr == pytest.approx(float(jsched(t)), rel=1e-4)
        want = from_flax_params(jax.device_get(jparams))
        for name, p in named.items():
            got_step = (p.detach() - before[name]).numpy()
            want_step = want[name].numpy() - before[name].numpy()
            np.testing.assert_allclose(got_step, want_step, rtol=0,
                                       atol=1e-4 * lr * 3, err_msg=f"{name} step {t}")


@pytest.mark.parametrize("name", ["linear", "cosine", "step"])
def test_schedules_match_jax(name):
    """`build_schedule` and `build_wd_schedule` against JAX's over a whole
    run of 5 epochs of 7 steps, warm-up included. The port evaluates in
    float64; optax in float32 as init + (end - init) * frac rearranged, which
    leaves up to ~2e-5 relative at the 5e-7 warm-up start: rtol 1e-4; the
    weight-decay cosine, also float32 in JAX, within rtol 1e-5."""
    overrides = TINY + [f"train.lr_scheduler.name={name}", "train.epochs=5",
                        "train.warmup_steps=4", "train.lr_scheduler.decay_epochs=2",
                        "train.weight_decay_end=0.2"]
    jt, pt = jax_load_config(overrides).train, load_config(overrides)["train"]
    js, ps = joptim.build_schedule(jt, 7), poptim.build_schedule(pt, 7)
    jw, pw = joptim.build_wd_schedule(jt, 7), poptim.build_wd_schedule(pt, 7)
    for t in range(0, 40):
        assert ps(t) == pytest.approx(float(js(t)), rel=1e-4), t
        assert pw(t) == pytest.approx(float(jw(t)), rel=1e-5), t


def test_param_groups_match_jax(flax_params):
    """LR multipliers, the weight-decay mask and the phase freeze sets of
    every parameter, matched by flax path."""
    cfg = load_config(TINY)
    task = _port_task(TINY, flax_params)
    names = {poptim.flax_path(n): p for n, p in task.named_parameters()}
    jm = joptim.lr_multipliers(flax_params, 1, 2, lr_mult_head=2.0, lr_mult_fusion=3.0)
    jd = joptim.no_decay_mask(flax_params)
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}

    def torch_path(path):  # flax leaf names as from_flax_params renames them
        *mods, name = joptim._path_str(path).split("/")
        return "/".join(mods + [leaf.get(name, name)])

    flat = {torch_path(path): (m, d) for (path, m), (_, d) in zip(
        jax.tree_util.tree_flatten_with_path(jm)[0],
        jax.tree_util.tree_flatten_with_path(jd)[0])}
    pm = poptim.lr_multipliers(names, 1, 2, lr_mult_head=2.0, lr_mult_fusion=3.0)
    pd = poptim.no_decay_mask(names)
    assert set(flat) == set(names)
    for path, (m, d) in flat.items():
        assert (pm[path], pd[path]) == (float(m), bool(d)), path
    assert cfg["model"]["fusion_layer"] == 1
    for losses, phase in ((("mlm", "itc", "itm", "mim"), "pretrain_mum"),
                          (("mlm",), "pretrain_txt"), (("mim",), "pretrain_vis"),
                          (("vqa",), "finetune_vqa")):
        jp = joptim.phase_frozen_predicate(losses, phase, "img")
        pp = poptim.phase_frozen_predicate(losses, phase, "img")
        assert (jp is None) == (pp is None), losses
        if jp is not None:
            assert all(jp(n) == pp(n) for n in names), losses


def test_synthetic_batches_match_jax():
    """The port's loader over its synthetic dataset gives the batches of
    JAX's `MultiTaskData(...).train_loader()` for the same config and
    epoch: same keys, dtypes and values."""
    jcfg = jax_load_config(TINY)
    loader = MultiTaskData(jcfg).train_loader()
    loader.num_workers = 1
    trainer = Trainer(load_config(TINY), device="cpu")
    assert len(loader) == trainer.steps_per_epoch == 12 // BATCH
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        for want, got in zip(loader, trainer.loader.epoch(epoch)):
            assert set(got) == set(want)
            for key, w in want.items():
                assert got[key].dtype == w.dtype, key
                np.testing.assert_array_equal(got[key], w, err_msg=key)
    one = collate([trainer.loader.dataset[i] for i in (3, 1)])
    assert one["image_u8"].shape == (2, 64, 64, 3) and one["index"].tolist() == [3, 1]


def test_preprocess_batch_matches_jax(host_batch):
    """Normalized images and the dVAE's logit-Laplace input in fp32, within
    1e-6 (the same fp32 formula in both)."""
    want = jax_preprocess_batch({k: jnp.asarray(v) for k, v in host_batch.items()
                                 if k != "index"})
    got = preprocess_batch({k: torch.from_numpy(v) for k, v in host_batch.items()
                            if k != "index"})
    assert set(got) == set(want)
    for key in ("image", "image4dalle"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


def test_dvae_tokens_match_jax():
    """Token ids of the random-weight dVAE encoder, converted from JAX's
    `init_random`, equal JAX's `get_codebook_indices` on 32x32 images.
    Bit-exact in fp32 (argmax of 8192 logits whose gaps are far above the
    fp32 summation differences); convolutions in full fp32 on both."""
    jvae = JaxDalleVAE(32)
    # `init_random`'s encoder weights (its first key of the split), jitted:
    # the eager init of the unused decoder alone takes ~20 s on the CPU
    r_enc, _ = jax.random.split(jax.random.key(0))
    dummy = jnp.zeros((1, 32, 32, 3))
    jvae.encoder_params = jax.jit(jvae.encoder.init)(r_enc, dummy)["params"]
    imgs = np.random.default_rng(4).uniform(0.1, 0.9, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jvae.get_codebook_indices(jnp.asarray(imgs)))
    enc = DalleEncoder()
    enc.load_state_dict(from_flax_params(jax.device_get(jvae.encoder_params)),
                        strict=True)
    from exploremultimodal_torch.models.dvae import DalleVAE

    vae = DalleVAE(32, device="cpu")
    vae.encoder = enc
    got = vae.get_codebook_indices(torch.from_numpy(imgs))
    assert got.shape == want.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_trainer_refuses_without_cuda_and_trains_on_the_cpu(monkeypatch):
    """Without a GPU the trainer raises unless device='cpu' is asked for;
    on the CPU two steps with every dropout live give finite metrics and
    move the weights; the command line takes the same overrides."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    trainer = Trainer(cfg, device="cpu")
    w = trainer.task.transformer.blocks[0].attn.qkv.weight
    before = w.detach().clone()
    metrics = trainer.train_steps(2)
    assert trainer.state.step == 2 and len(metrics) == 2
    for m in metrics:
        assert all(np.isfinite(v) for v in m.values()), m
        assert {"total_loss", "grad_norm", "lr", *LOSSES} <= set(m)
    assert not torch.equal(w.detach(), before)
    assert port_main(TINY + ["steps=1", "device=cpu"]) == 0
    with pytest.raises(NotImplementedError):
        Trainer(load_config(TINY + ["train.datasets=[coco]"]), device="cpu")
