"""The PyTorch port's finetune_vqa step against the JAX package, on the CPU.

The fused MLP's dropout forward (`_mlp_dropout_kernel`) and its backward
(`_vjp_bwd`, `_vjpd_bwd`), the `Mlp` module's hidden dropout, the ISDA
statistics, `compute_vqa` with ISDA and R-Drop, the synthetic VQA batches,
AdamW under finetune_vqa's parameter groups, and the trainer. Inputs are
made with numpy and go through both packages as numpy arrays; JAX's Pallas
kernels run in interpret mode, as the JAX package's own tests run them on
the CPU. The port's wrappers take their plain versions here because the
tensors lie on the CPU; `chip_smoke.py` holds the CUDA kernels against the
same plain versions on the card. Random bits JAX draws are captured with
monkeypatch and handed to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.data.datamodule import MultiTaskData
from exploremultimodal_tpu.models import heads as jheads
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.models.task import build_model as jax_build_model
from exploremultimodal_tpu.models.task import total_loss as jax_total_loss
from exploremultimodal_tpu.models.vlmo import Mlp as JaxMlp
from exploremultimodal_tpu.ops.mlp_pallas import fused_bf16_mlp, fused_bf16_mlp_dropout
from exploremultimodal_tpu.ops.preprocess import preprocess_batch as jax_preprocess_batch
from exploremultimodal_tpu.train import optim as joptim
from exploremultimodal_torch.config import VlmoConfig, load_config
from exploremultimodal_torch.main import main as port_main
from exploremultimodal_torch.models import heads as pheads
from exploremultimodal_torch.models import vlmo as pvlmo
from exploremultimodal_torch.models.convert import from_flax_params
from exploremultimodal_torch.models.task import VlmoTask, total_loss
from exploremultimodal_torch.ops import mlp_fused as pmlp
from exploremultimodal_torch.ops import stochastic as pst
from exploremultimodal_torch.train import optim as poptim
from exploremultimodal_torch.train.trainer import Trainer

BATCH = 4
LABELS = 12  # a small answer vocabulary, so that classes repeat in a batch
VQA_TINY = [
    "model=vlmo_debug", "train=finetune_vqa", "model.img_size=64",
    "model.max_text_len=10", "compute_dtype=float32",
    "train.datasets=[synthetic]", f"data.batch_size={BATCH}",
    "data.synthetic_size=12", f"data.vqav2_label_size={LABELS}",
]
ALL_RATES_0 = ["model.drop_rate=0.0", "model.attn_drop_rate=0.0",
               "model.drop_path_rate=0.0", "train.kl_alpha=1.0",
               "train.isda_lambda=0.5"]
NAMES = "x w1 b1 w2 b2".split()


def _mlp_inputs(lead=(2, 50), kdim=96, hdim=384, seed=7):
    """JAX's layout: w1 (K, H), w2 (H, N)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((*lead, kdim)).astype(np.float32),
            (rng.standard_normal((kdim, hdim)) * 0.05).astype(np.float32),
            (rng.standard_normal(hdim) * 0.01).astype(np.float32),
            (rng.standard_normal((hdim, kdim)) * 0.05).astype(np.float32),
            (rng.standard_normal(kdim) * 0.01).astype(np.float32))


def _bits(shape, seed=3):
    return np.random.default_rng(seed).integers(0, 65536, shape).astype(np.uint16)


def _as_port_bits(bits: np.ndarray) -> torch.Tensor:
    """uint16 draws u as the port stores them: the int16 u - 32768."""
    return torch.from_numpy((bits.astype(np.int32) - 32768).astype(np.int16))


def _port_args(arrays, requires_grad=False):
    """(x, w1, b1, w2, b2) as torch tensors in nn.Linear's layout."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a.copy()) for a in arrays)
    out = (x, w1.T.contiguous(), b1, w2.T.contiguous(), b2)
    return [t.requires_grad_(requires_grad) for t in out]


# ------------------------------------------------------- row 7, plain version


@pytest.mark.parametrize("threshold", [6554, 20000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row7_plain_matches_jax_kernel(threshold, dtype):
    """`fused_mlp_fwd_drop_plain` against JAX's `fused_bf16_mlp_dropout`
    (`_mlp_dropout_kernel` in interpret mode) with the same uint16 bits.
    fp32: rtol 2e-5, atol 2e-6, as the JAX package's own kernel test (the
    same math summed in another order). bf16: one bf16 ulp of |y| < 4
    (2**-6), for a hidden value whose fp32 sum rounds the other way."""
    arrays = _mlp_inputs(lead=(64,), seed=threshold)
    bits = _bits((64, 384), seed=threshold)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jx, jw1, jb1, jw2, jb2 = map(jnp.asarray, arrays)
    want = fused_bf16_mlp_dropout(jx.astype(jdt), jw1.astype(jdt), jb1,
                                  jw2.astype(jdt), jb2, jnp.asarray(bits),
                                  threshold, True)
    want = np.asarray(want.astype(jnp.float32))
    x, w1, b1, w2, b2 = _port_args(arrays)
    before = pmlp.fused_mlp_fwd_drop.launches
    got = pmlp.fused_mlp_fwd_drop(x.to(tdt), w1.to(tdt), b1, w2.to(tdt), b2,
                                  _as_port_bits(bits), threshold)
    assert pmlp.fused_mlp_fwd_drop.launches == before  # CPU: no kernel launch
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 ** -6)


def test_bits16_compare_unsigned():
    """The int16 storage keeps the unsigned order: values >= 32768 are kept
    above a threshold of 32768 and never read as small; the draws cover the
    whole 16-bit range."""
    bits = np.array([0, 6553, 6554, 32767, 32768, 40000, 65535], np.uint16)
    keep = pst.keep16(_as_port_bits(bits), 6554)
    assert keep.tolist() == [False, False, True, True, True, True, True]
    assert pst.keep16(_as_port_bits(bits), 32768).tolist() == [False] * 4 + [True] * 3
    rng = pst.StepRng(torch.Generator().manual_seed(0), torch.Generator(),
                      torch.device("cpu"))
    draws = pst.bits16(rng, (4096, 16), torch.device("cpu"))
    assert draws.dtype == torch.int16
    u = draws.to(torch.int32) + 32768
    assert int(u.min()) < 256 and int(u.max()) > 65280
    assert abs(pst.keep16(draws, 6554).float().mean().item() - 0.9) < 0.01


# ------------------------------------------------------------ fused backward


@pytest.mark.parametrize("threshold", [0, 6554, 20000])
def test_fused_mlp_grads_match_jax_vjp(threshold):
    """The port's `fused_mlp` (autograd over rows 6/7 and the recompute
    backward) against `jax.vjp` of `fused_bf16_mlp` (threshold 0) and
    `fused_bf16_mlp_dropout`, with the same bits and cotangent. fp32;
    rtol 1e-4, atol 1e-5, as `tests/test_mlp_pallas.py`'s VJP tests."""
    arrays = _mlp_inputs(seed=11 + threshold)
    bits = _bits((2, 50, 384), seed=threshold)
    g = np.random.default_rng(5).standard_normal((2, 50, 96)).astype(np.float32)
    if threshold:
        fn = lambda *a: fused_bf16_mlp_dropout(*a, jnp.asarray(bits), threshold, True)  # noqa: E731
    else:
        fn = lambda *a: fused_bf16_mlp(*a, True)  # noqa: E731
    want_y, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(g))

    leaves = _port_args(arrays, requires_grad=True)
    pbits = _as_port_bits(bits) if threshold else None
    before = (pmlp.fused_mlp_fwd.launches, pmlp.fused_mlp_fwd_drop.launches)
    y = pmlp.fused_mlp(*leaves, pbits, threshold)
    y.backward(torch.from_numpy(g))
    assert (pmlp.fused_mlp_fwd.launches, pmlp.fused_mlp_fwd_drop.launches) == before
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=2e-5, atol=2e-6)
    for name, leaf, w in zip(NAMES, leaves, want):
        w = np.asarray(w)
        got = leaf.grad.numpy()
        if name in ("w1", "w2"):
            got = got.T  # nn.Linear's layout back to JAX's kernel
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-5, err_msg=name)


# ------------------------------------------------------------- Mlp module


def _capture_bits(monkeypatch):
    drawn = []
    real = jax.random.bits

    def capture(key, shape=(), dtype=jnp.uint32):
        out = real(key, shape, dtype)
        drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bits", capture)
    return drawn


def _replay_bits(monkeypatch, drawn):
    """The port's draws, in order, become the bits JAX drew."""
    given = iter(list(drawn))

    def replay(rng, shape, device):
        b = next(given)
        assert b.shape == tuple(shape)
        return _as_port_bits(b)

    monkeypatch.setattr(pst, "bits16", replay, raising=False)
    monkeypatch.setattr(pvlmo, "bits16", replay, raising=False)


@pytest.mark.parametrize("grad", [True, False])
def test_mlp_hidden_dropout_matches_jax(monkeypatch, grad):
    """The `Mlp` expert at `mlp_impl='fused'` with a StepRng against JAX's
    `Mlp` at `deterministic=False`, fed the uint16 bits JAX drew: the hidden
    dropout inside the kernel, then the post-fc2 dropout. Under grad the
    gradients too (jax.vjp, rtol 1e-4, atol 1e-5); under no_grad the same
    output: the hidden dropout applies there as well. fp32; outputs within
    rtol 2e-5, atol 2e-6."""
    x, w1, b1, w2, b2 = _mlp_inputs(lead=(2, 30), seed=21)
    jmlp = JaxMlp(hidden_dim=384, out_dim=96, drop_rate=0.1, mlp_impl="fused")
    params = {"fc1": {"kernel": jnp.asarray(w1), "bias": jnp.asarray(b1)},
              "fc2": {"kernel": jnp.asarray(w2), "bias": jnp.asarray(b2)}}
    drawn = _capture_bits(monkeypatch)
    g = np.random.default_rng(6).standard_normal((2, 30, 96)).astype(np.float32)
    want_y, vjp = jax.vjp(
        lambda p, a: jmlp.apply({"params": p}, a, deterministic=False,
                                rngs={"dropout": jax.random.key(4)}),
        params, jnp.asarray(x))
    assert [d.shape for d in drawn] == [(2, 30, 384), (2, 30, 96)]
    assert all(d.dtype == np.uint16 for d in drawn)

    mlp = pvlmo.Mlp(96, 384, torch.float32, "fused", 0.1)
    with torch.no_grad():
        mlp.fc1.weight.copy_(torch.from_numpy(w1.T))
        mlp.fc1.bias.copy_(torch.from_numpy(b1))
        mlp.fc2.weight.copy_(torch.from_numpy(w2.T))
        mlp.fc2.bias.copy_(torch.from_numpy(b2))
    _replay_bits(monkeypatch, drawn)
    rng = pst.StepRng(torch.Generator(), torch.Generator(), torch.device("cpu"))
    tx = torch.from_numpy(x).requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        y = mlp(tx, rng)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=2e-5, atol=2e-6)
    if not grad:
        assert not y.requires_grad
        return
    y.backward(torch.from_numpy(g))
    jp, jx = vjp(jnp.asarray(g))
    pairs = [(tx.grad, jx), (mlp.fc1.weight.grad.T, jp["fc1"]["kernel"]),
             (mlp.fc1.bias.grad, jp["fc1"]["bias"]),
             (mlp.fc2.weight.grad.T, jp["fc2"]["kernel"]),
             (mlp.fc2.bias.grad, jp["fc2"]["bias"])]
    for name, (got, w) in zip(NAMES, pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


# ------------------------------------------------------------------- ISDA


def _isda_state(rng, classes=LABELS, dim=8):
    return (rng.integers(0, 5, classes).astype(np.float32),
            rng.standard_normal((classes, dim)).astype(np.float32),
            rng.uniform(0.1, 1.0, (classes, dim)).astype(np.float32))


def test_isda_update_and_logits_match_jax():
    """`isda_update` and `isda_logits` (the sum expanded into products)
    against JAX's on the same statistics, features and weights, with
    classes seen twice, once and never, and one empty running class.
    fp32; rtol 1e-5, atol 1e-5 (the expansion sums in another order), and
    the fc weight's gradient through the augmentation within rtol 1e-4."""
    rng = np.random.default_rng(8)
    count, mean, cov = _isda_state(rng)
    count[3] = 0.0
    feats = rng.standard_normal((6, 8)).astype(np.float32)
    onehot = np.zeros((6, LABELS), np.float32)
    onehot[np.arange(6), [1, 1, 3, 5, 7, 7]] = 1.0
    jstate = jheads.isda_update(jheads.ISDAState(*map(jnp.asarray, (count, mean, cov))),
                                jnp.asarray(feats), jnp.asarray(onehot))
    pstate = pheads.isda_update(pheads.ISDAState(*map(torch.from_numpy, (count, mean, cov))),
                                torch.from_numpy(feats), torch.from_numpy(onehot))
    for name in ("count", "mean", "cov"):
        np.testing.assert_allclose(getattr(pstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)

    logits = rng.standard_normal((6, LABELS)).astype(np.float32)
    kernel = rng.standard_normal((8, LABELS)).astype(np.float32)  # (A, C)
    labels = np.array([1, 1, 3, 5, 7, 7])
    gl = rng.standard_normal((6, LABELS)).astype(np.float32)
    want, vjp = jax.vjp(lambda w: jheads.isda_logits(
        jnp.asarray(logits), None, w, jnp.asarray(labels), jstate.cov, 0.7),
        jnp.asarray(kernel))
    pkernel = torch.from_numpy(kernel).requires_grad_()
    got = pheads.isda_logits(torch.from_numpy(logits), pkernel,
                             torch.from_numpy(labels), pstate.cov, 0.7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(gl))
    np.testing.assert_allclose(pkernel.grad.numpy(), np.asarray(vjp(jnp.asarray(gl))[0]),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- compute_vqa


@pytest.fixture(scope="module")
def host_batch():
    """One loader batch of the synthetic finetune_vqa data."""
    return Trainer(load_config(VQA_TINY), device="cpu").next_batch()


@pytest.fixture(scope="module")
def model_batch(host_batch):
    raw = {k: v for k, v in host_batch.items() if k != "index"}
    return {k: np.asarray(v) for k, v in jax_preprocess_batch(
        {k: jnp.asarray(v) for k, v in raw.items()}).items()}


@pytest.fixture(scope="module")
def flax_params(model_batch):
    task = jax_build_model(jax_load_config(VQA_TINY))
    batch = {k: jnp.asarray(v) for k, v in model_batch.items()}
    init = jax.jit(lambda key: task.init({"params": key, "sample": jax.random.key(1)},
                                         batch, method=JaxTask.init_streams))
    params = init(jax.random.key(0))["params"]
    rng = np.random.default_rng(3)

    def jitter(path, x):  # non-zero biases and LayerNorm affines
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


def _compare_grads(task, jgrads):
    """Every parameter's gradient, matched by name; a parameter the losses
    never reach has no gradient in the port and a zero one in JAX. fp32;
    within 2e-5 + 1e-3 of the largest magnitude, as the pretrain step's
    test (other summation orders through two blocks)."""
    want = from_flax_params(jgrads)
    got = dict(task.named_parameters())
    assert set(got) == set(want)
    reached = 0
    for name, p in got.items():
        w = want[name].numpy()
        if p.grad is None:
            assert not w.any(), name
            continue
        reached += 1
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=2e-5 + 1e-3 * np.abs(w).max(), err_msg=name)
    return reached


@pytest.mark.parametrize("mlp_impl", ["fused", "xla"])
def test_compute_vqa_losses_and_gradients_match_jax(flax_params, model_batch, mlp_impl):
    """The VQA BCE, the soft score and every gradient of one deterministic
    finetune_vqa forward against `jax.value_and_grad` of JAX's
    `VlmoTask.__call__` and `total_loss`, under both FFN routes (the fused
    kernel's plain version with its recompute backward, or two Linears).
    fp32; loss within rtol 1e-5, the score exactly."""
    overrides = VQA_TINY + [f"model.mlp_impl={mlp_impl}"]
    jtask = jax_build_model(jax_load_config(overrides))
    jbatch = {k: jnp.asarray(v) for k, v in model_batch.items()}

    def loss_fn(p):
        out = jtask.apply({"params": p}, jbatch, deterministic=True)
        return jax_total_loss(out), out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        flax_params)
    task = _port_task(overrides, flax_params)
    out = task({k: torch.from_numpy(v) for k, v in model_batch.items()})
    loss = total_loss(out)
    loss.backward()
    np.testing.assert_allclose(float(out["vqa_task_loss"]), float(jout["vqa_task_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(out["vqa_logits"].detach().numpy(),
                               np.asarray(jout["vqa_logits"]), rtol=1e-4, atol=1e-5)
    assert float(out["vqa_mean_score"]) == float(jout["vqa_mean_score"])
    assert float(out["vqa_count"]) == float(jout["vqa_count"]) == BATCH
    assert out["isda_state"] is None
    assert _compare_grads(task, jgrads) > 0


@pytest.mark.parametrize("mlp_impl", ["fused", "xla"])
def test_isda_and_rdrop_match_jax(flax_params, model_batch, mlp_impl):
    """ISDA and R-Drop live (`deterministic=False` and a StepRng) with every
    dropout rate 0, so both sides are deterministic: the two forwards agree,
    the symmetric KL is 0, and the ISDA update and augmented BCE, the total
    loss and every gradient match JAX's from the same running statistics
    and ratio. fp32; tolerances as the deterministic test, the statistics
    within rtol 1e-5, atol 1e-5."""
    overrides = VQA_TINY + ALL_RATES_0 + [f"model.mlp_impl={mlp_impl}"]
    count, mean, cov = _isda_state(np.random.default_rng(9), dim=192)
    ratio = 0.3
    jtask = jax_build_model(jax_load_config(overrides))
    jbatch = {k: jnp.asarray(v) for k, v in model_batch.items()}
    jstate = jheads.ISDAState(*map(jnp.asarray, (count, mean, cov)))

    def loss_fn(p):
        out = jtask.apply({"params": p}, jbatch, deterministic=False,
                          isda_state=jstate, isda_ratio=ratio,
                          rngs={"dropout": jax.random.key(1),
                                "droppath": jax.random.key(2)})
        return jax_total_loss(out), out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        flax_params)
    task = _port_task(overrides, flax_params)
    assert task.config.kl_alpha == 1.0 and task.config.isda_lambda == 0.5
    rng = pst.StepRng(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1),
                      torch.device("cpu"))
    state = pheads.ISDAState(*map(torch.from_numpy, (count, mean, cov)))
    out = task({k: torch.from_numpy(v) for k, v in model_batch.items()}, rng=rng,
               isda_state=state, isda_ratio=ratio)
    loss = total_loss(out)
    loss.backward()
    assert float(out["vqa_kl_task_loss"]) == pytest.approx(0.0, abs=1e-6)
    assert float(jout["vqa_kl_task_loss"]) == pytest.approx(0.0, abs=1e-6)
    np.testing.assert_allclose(float(out["vqa_task_loss"]), float(jout["vqa_task_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for name in ("count", "mean", "cov"):
        np.testing.assert_allclose(getattr(out["isda_state"], name).numpy(),
                                   np.asarray(getattr(jout["isda_state"], name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert float(out["isda_state"].count.sum()) == count.sum() + BATCH
    assert _compare_grads(task, jgrads) > 0


# ------------------------------------------------------- data and optimizer


def test_synthetic_vqa_batches_match_jax():
    """The port's finetune_vqa loader gives JAX's
    `MultiTaskData(...).train_loader()` batches: the one-hot VQA targets
    drawn after the patch mask, and no dVAE image (no masked-image
    objective); same keys, dtypes and values over two epochs."""
    jcfg = jax_load_config(VQA_TINY)
    loader = MultiTaskData(jcfg).train_loader()
    loader.num_workers = 1
    trainer = Trainer(load_config(VQA_TINY), device="cpu")
    assert trainer.dvae is None
    assert len(loader) == trainer.steps_per_epoch == 12 // BATCH
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        for want, got in zip(loader, trainer.loader.epoch(epoch)):
            assert set(got) == set(want)
            assert "vqa_targets" in got and "image4dalle_u8" not in got
            for key, w in want.items():
                assert got[key].dtype == w.dtype, key
                np.testing.assert_array_equal(got[key], w, err_msg=key)
            np.testing.assert_array_equal(got["vqa_targets"].sum(1), np.ones(BATCH))


def test_adamw_steps_match_jax_under_finetune_vqa_groups(flax_params):
    """Three AdamW steps under finetune_vqa's groups (head x50, fusion
    blocks and pooler x5, betas (0.9, 0.98), the image mask token frozen)
    from the same parameters and seeded gradients, through the port's
    `Optimizer` and JAX's `create_optimizer` over the trainable subtree.
    The image and text experts above the fusion layer, which the VQA loss
    never reaches, have no gradient in the port and a zero one in JAX: both
    still decay them. Each step's change within 1e-4 of the step's rate."""
    overrides = VQA_TINY + ["train.warmup_steps=2", "train.base_lr=1e-2",
                            "train.warmup_lr=1e-3", "train.epochs=2",
                            "train.weight_decay=0.1"]
    jcfg, cfg = jax_load_config(overrides), load_config(overrides)
    assert cfg["train"]["opt"]["betas"] == [0.9, 0.98]
    frozen = joptim.phase_frozen_predicate(("vqa",), "finetune_vqa", "img")
    pfrozen = poptim.phase_frozen_predicate(("vqa",), "finetune_vqa", "img")
    jtrain, _ = joptim.split_frozen(flax_params, frozen)
    tx, jsched = joptim.create_optimizer(jcfg, jtrain, 5)
    task = _port_task(overrides, flax_params)
    named = {n: p for n, p in task.named_parameters()
             if not pfrozen(poptim.flax_path(n))}
    assert len(named) < len(list(task.parameters()))  # the mask token is out
    opt, psched = poptim.create_optimizer(cfg, named, 5)
    mults = {g["lr_mult"] for g in opt.torch.param_groups}
    assert mults == {1.0, 5.0, 50.0}

    def unreached(name):  # the above-fusion v/l experts (fusion_layer 1)
        return "blocks_1/mlp_v" in name or "blocks_1/mlp_l" in name

    jparams = jax.tree_util.tree_map(jnp.asarray, jtrain)
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(12)
    for t in range(3):
        grads = jax.tree_util.tree_map_with_path(
            lambda path, x: jnp.zeros_like(x) if unreached(joptim._path_str(path))
            else jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.1),
            jtrain)
        before = {k: p.detach().clone() for k, p in named.items()}
        pgrads = from_flax_params(grads)
        for name, p in named.items():
            p.grad = None if unreached(poptim.flax_path(name)) else pgrads[name]
        opt.step(t)
        updates, jstate = update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        lr = psched(t)
        assert lr == pytest.approx(float(jsched(t)), rel=1e-4)
        want = from_flax_params(jax.device_get(jparams))
        moved = 0
        for name, p in named.items():
            got_step = (p.detach() - before[name]).numpy()
            want_step = want[name].numpy() - before[name].numpy()
            np.testing.assert_allclose(got_step, want_step, rtol=0,
                                       atol=1e-4 * lr * 50, err_msg=f"{name} step {t}")
            if unreached(poptim.flax_path(name)) and p.ndim == 2:
                moved += int(np.abs(got_step).max() > 0)
        assert moved > 0  # weight decay reached the unreached experts


# ------------------------------------------------------------------ trainer


def test_trainer_trains_finetune_vqa_on_the_cpu(monkeypatch):
    """Two finetune_vqa steps on the CPU with every dropout live, the fused
    MLP (plain versions here), R-Drop and ISDA: finite metrics, moved
    weights, a grown ISDA count; no dVAE. The command line takes
    `train=finetune_vqa steps=1 device=cpu`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(VQA_TINY + ["model.mlp_impl=fused", "train.kl_alpha=1.0",
                                  "train.isda_lambda=0.5"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    trainer = Trainer(cfg, device="cpu")
    assert trainer.dvae is None and trainer.state.isda is not None
    w = trainer.task.transformer.blocks[1].mlp_vl.fc1.weight
    before = w.detach().clone()
    launches = pmlp.fused_mlp_fwd_drop.launches
    metrics = trainer.train_steps(2)
    assert pmlp.fused_mlp_fwd_drop.launches == launches
    assert trainer.state.step == 2 and len(metrics) == 2
    for m in metrics:
        assert all(np.isfinite(v) for v in m.values()), m
        assert {"total_loss", "grad_norm", "lr", "vqa_task_loss", "vqa_mean_score",
                "vqa_kl_task_loss"} <= set(m)
    assert not torch.equal(w.detach(), before)
    assert float(trainer.state.isda.count.sum()) == 2 * BATCH
    assert port_main(VQA_TINY + ["model.mlp_impl=fused", "steps=1", "device=cpu"]) == 0
