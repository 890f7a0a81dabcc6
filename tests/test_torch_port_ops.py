"""The PyTorch port's ops and config against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages as numpy arrays.
The port's kernel wrappers take their plain PyTorch versions here, because
the tensors lie on the CPU; the CUDA kernels are held against those plain
versions on the card by `chip_smoke.py`. The JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.models.task import VlmoConfig as JaxVlmoConfig
from exploremultimodal_tpu.ops import flash_attention as jfa
from exploremultimodal_tpu.ops.attention import key_padding_bias as jax_key_padding_bias
from exploremultimodal_tpu.ops.attention import multi_head_attention as jax_mha
from exploremultimodal_tpu.ops.mlp_pallas import fits_vmem as jax_fits_vmem
from exploremultimodal_tpu.ops.mlp_pallas import fused_bf16_mlp
from exploremultimodal_tpu.ops.preprocess import normalize_image as jax_normalize_image
from exploremultimodal_torch import config as port_config
from exploremultimodal_torch.ops.attention import (
    NEG_INF,
    key_padding_bias,
    multi_head_attention,
)
from exploremultimodal_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_fwd,
)
from exploremultimodal_torch.ops.mlp_fused import fits_vmem, fused_mlp, fused_mlp_fwd
from exploremultimodal_torch.ops.preprocess import normalize_image
from exploremultimodal_torch.ops.stochastic import StepRng


def _attn_inputs(n, b=2, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, n), np.int32)
    mask[1, n - n // 3:] = 0  # a padded row: the last third of its keys
    return q, k, v, mask


# ------------------------------------------------------------------ attention


@pytest.mark.parametrize("n", [40, 197, 237, 333, 512])
def test_flash_attention_plain_matches_jax_kernel(n):
    """The port's flash forward (plain version on the CPU) against JAX's
    `flash_attention`, which runs `_attn_kernel` in interpret mode, and its
    lse against `_fwd_call`'s. Both fp32 throughout; tolerance 1e-5 covers
    the different summation orders (observed ~1e-7)."""
    q, k, v, mask = _attn_inputs(n)
    scale = 64 ** -0.5
    jbias = jax_key_padding_bias(jnp.asarray(mask))
    want = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)),
                                          bias=jbias, scale=scale))
    before = flash_attention_fwd.launches
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_attention(tq, tk, tv, bias=key_padding_bias(torch.from_numpy(mask)),
                          scale=scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert flash_attention_fwd.launches == before  # CPU: no kernel launch

    # lse, which the training slice's backward will read
    n_pad = jfa._round_up(n, jfa.BLOCK_Q)
    pad = [(0, 0), (0, 0), (0, n_pad - n), (0, 0)]
    flat = [jnp.asarray(np.pad(a, pad)).reshape(4, n_pad, 64) for a in (q, k, v)]
    key_bias = jnp.pad(jbias.reshape(2, 1, n), [(0, 0), (0, 0), (0, n_pad - n)],
                       constant_values=NEG_INF)
    _, want_lse = jfa._fwd_call(*flat, key_bias, scale)
    _, got_lse = flash_attention_fwd(
        tq.reshape(4, n, 64), tk.reshape(4, n, 64), tv.reshape(4, n, 64),
        key_padding_bias(torch.from_numpy(mask)).reshape(2, n), scale)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[:, :n, 0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["recompute", "xla", "auto", "saveprobs", "jax_flash"])
def test_plain_attention_chain_matches_jax(impl):
    """The plain chain in bf16, where rounding the scores to the compute
    dtype matters. Tolerance: one bf16 ulp at |out| < 2 (2**-7), for a
    different rounding of an fp32 value near a bf16 boundary."""
    q, k, v, mask = _attn_inputs(40, seed=1)
    want = np.asarray(jax_mha(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                              bias=jax_key_padding_bias(jnp.asarray(mask)),
                              impl=impl).astype(jnp.float32))
    got = multi_head_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        bias=key_padding_bias(torch.from_numpy(mask)), impl=impl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 ** -7)


def test_key_padding_bias_matches_jax():
    mask = np.array([[1, 1, 0], [1, 0, 0]], np.int32)
    want = np.asarray(jax_key_padding_bias(jnp.asarray(mask)))
    got = key_padding_bias(torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (2, 1, 1, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert NEG_INF == -1e30 and np.isfinite(want).all()


def test_attention_refuses_dropout_beyond_the_fused_backward():
    """In-kernel dropout needs the fused backward, N <= 512, as in JAX; the
    multi-head wrapper then takes the plain chain, as JAX falls through to
    its recompute path."""
    w = torch.zeros(1, 1, 513, 64, requires_grad=True)
    with pytest.raises(ValueError, match="N <= 512"):
        flash_attention(w, w, w, scale=0.125, dropout_rate=0.1,
                        dropout_seed=torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError):
        jfa.flash_attention(*(jnp.zeros((1, 1, 513, 64)),) * 3, scale=0.125,
                            dropout_rate=0.1, dropout_seed=jnp.asarray([1]))
    rng = StepRng(torch.Generator(), torch.Generator(), torch.device("cpu"))
    out = multi_head_attention(w, w, w, dropout_rate=0.1, dropout_rng=rng,
                               impl="pallas")
    assert out.shape == w.shape and rng.attention_calls == 0


def test_fused_mlp_refuses_training_calls():
    """A call that needs a gradient is refused no longer: on the CPU it
    trains through the plain version and the recompute backward, whose
    gradients are `jax.vjp`'s of `fused_bf16_mlp` (fp32; rtol 1e-4, atol
    1e-5, as the JAX package's own VJP test), and it launches no kernel.
    Under no_grad it gives the same output."""
    arrays = _mlp_inputs(lead=(4,), seed=9)
    g = np.random.default_rng(10).standard_normal((4, 96)).astype(np.float32)
    want_y, vjp = jax.vjp(lambda *a: fused_bf16_mlp(*a, True), *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(g))
    x, w1, b1, w2, b2 = (torch.from_numpy(a.copy()) for a in arrays)
    leaves = [t.requires_grad_() for t in (x, w1.T.contiguous(), b1, w2.T.contiguous(), b2)]
    before = fused_mlp_fwd.launches
    y = fused_mlp(*leaves)
    y.backward(torch.from_numpy(g))
    assert fused_mlp_fwd.launches == before
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=2e-5, atol=2e-6)
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        got = leaf.grad.numpy().T if i in (1, 3) else leaf.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        torch.testing.assert_close(fused_mlp(*leaves), y.detach(), rtol=0, atol=0)


# ------------------------------------------------------------------ fused MLP


def _mlp_inputs(kdim=96, hdim=384, odim=96, lead=(2, 50), seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, kdim)).astype(np.float32)
    w1 = (rng.standard_normal((kdim, hdim)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(hdim) * 0.01).astype(np.float32)
    w2 = (rng.standard_normal((hdim, odim)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(odim) * 0.01).astype(np.float32)
    return x, w1, b1, w2, b2


def test_fused_mlp_plain_matches_jax_kernel():
    """fp32: the port's plain version against JAX's `fused_bf16_mlp` in
    interpret mode. Tolerance as the JAX package's own kernel test
    (rtol 2e-5, atol 2e-6): the same tanh-gelu math, summed in another
    order."""
    x, w1, b1, w2, b2 = _mlp_inputs()
    want = np.asarray(fused_bf16_mlp(*map(jnp.asarray, (x, w1, b1, w2, b2)), True))
    before = fused_mlp_fwd.launches
    t = {n: torch.from_numpy(a) for n, a in zip("x w1 b1 w2 b2".split(),
                                               (x, w1, b1, w2, b2))}
    # the port takes nn.Linear's layout: w1 (hidden, in), w2 (out, hidden)
    got = fused_mlp(t["x"], t["w1"].T, t["b1"], t["w2"].T, t["b2"])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)
    assert fused_mlp_fwd.launches == before  # CPU: no kernel launch


def test_fused_mlp_rounds_hidden_like_jax_in_bf16():
    """bf16: the hidden is rounded to bf16 before the second product, as
    `_mlp_kernel` does. Tolerance: one bf16 ulp of |y| < 4 (2**-6)."""
    x, w1, b1, w2, b2 = _mlp_inputs(lead=(64,), seed=8)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = np.asarray(fused_bf16_mlp(bf(x), bf(w1), jnp.asarray(b1), bf(w2),
                                     jnp.asarray(b2), True).astype(jnp.float32))
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = fused_mlp(tb(x), tb(w1).T, torch.from_numpy(b1), tb(w2).T,
                    torch.from_numpy(b2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 ** -6)


@pytest.mark.parametrize("model", ["vlmo_debug", "vlmo_tiny", "vlmo_small",
                                   "vlmo_base", "vlmo_large", "vlmo_huge"])
def test_fits_vmem_selects_like_jax(model):
    """The port picks the fused (tanh) function exactly where JAX does, and
    the erf path elsewhere (vlmo_large/huge)."""
    m = jax_load_config([f"model={model}"]).model
    dims = (m.embed_dim, int(m.embed_dim * m.mlp_ratio), m.embed_dim)
    assert fits_vmem(*dims) == jax_fits_vmem(*dims)


# --------------------------------------------------------------- preprocess


def test_normalize_image_matches_jax():
    img = np.random.default_rng(2).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    want = np.asarray(jax_normalize_image(jnp.asarray(img)))
    got = normalize_image(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------- config


@pytest.mark.parametrize("group,name", [
    ("model", n) for n in ("vlmo_tiny", "vlmo_small", "vlmo_base", "vlmo_large",
                           "vlmo_huge", "vlmo_debug")] + [
    ("train", n) for n in ("pretrain_mum", "pretrain_txt", "pretrain_vis",
                           "finetune_vqa", "finetune_nlvr2", "finetune_retrieval",
                           "finetune_caption", "finetune_ref", "finetune_inpainting",
                           "finetune_vis")])
def test_presets_equal_the_jax_yaml(group, name):
    """Every preset is a whole copy of what the JAX loader reads from the
    YAML."""
    want = jax_load_config([f"{group}={name}"])[group].to_dict()
    got = port_config.load_config([f"{group}={name}"])[group]
    assert got == {k: want[k] for k in got}
    assert got == want


@pytest.mark.parametrize("overrides", [[], ["tag=run7"],
                                       ["vlmo_ema_decay=0.99", "model_ema_decay=0.999"]])
def test_base_keys_equal_the_jax_yaml(overrides):
    """The base keys the port reads (the run's directories, modes, logging
    and wandb among them, `wandb.name` resolved from `tag`) as JAX loads
    them; every train preset carries the run keys the loop reads."""
    want = jax_load_config(overrides).to_dict()
    got = port_config.load_config(overrides)
    assert set(port_config.BASE) <= set(got)
    assert got["data"] == {k: want["data"][k] for k in got["data"]}
    for key in set(port_config.BASE) - {"data"}:
        assert got[key] == want[key], key
    assert {"exp_dir", "run_dir", "output_dir", "tag", "eval_mode", "throughput_mode",
            "minimize_metric", "profile_steps", "log_level", "wandb"} <= set(got)
    assert "eval_batch_size" in got["data"]
    assert {"vlmo_ema", "vlmo_ema_decay", "model_ema", "model_ema_decay"} <= set(
        port_config.BASE)
    for name in port_config.TRAIN_PRESETS:
        t = port_config.load_config([f"train={name}"])["train"]
        assert {"save_freq", "print_freq", "auto_resume", "resume", "start_epoch"} <= set(t)


@pytest.mark.parametrize("overrides", [
    ["model=vlmo_base", "train=finetune_vqa"],
    ["model=vlmo_base", "train=finetune_vqa", "compute_dtype=bfloat16",
     "attn_impl=pallas", "model.mlp_impl=fused", "model.drop_rate=0.0"],
    ["model=vlmo_debug", "train=finetune_vqa", "model.img_size=32",
     "model.max_text_len=10", "model.init_values=null",
     "data.vqav2_label_size=12", "compute_dtype=float32"],
    ["model=vlmo_base", "train=pretrain_mum", "compute_dtype=bfloat16",
     "train.datasets=[synthetic]", "train.discrete_vae_type=random",
     "data.batch_size=32"],
])
def test_vlmo_config_matches_jax(overrides):
    """Same overrides, same parsed values, same VlmoConfig fields."""
    want = JaxVlmoConfig.from_config(jax_load_config(overrides))
    got = port_config.VlmoConfig.from_config(port_config.load_config(overrides))
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_load_config_rejects_unknown_presets_and_bad_overrides():
    with pytest.raises(ValueError):
        port_config.load_config(["model=vlmo_nonexistent"])
    with pytest.raises(ValueError):
        port_config.load_config(["model.depth"])
    assert port_config.parse_value("[vqa, itm]") == ["vqa", "itm"]
    assert port_config.parse_value("1.0e-12") == 1e-12
    assert port_config.parse_value("~") is None
