"""The PyTorch port's dVAE tokenizer path and long-sequence attention
against the JAX package, on the CPU.

`ops/dvae_conv.py` (the fused encoder block, row 11, and JAX's fuse
selector), `ops/quant_conv.py` (the int8 trunk convs, both emitters),
`models/dvae.py` under `fused` (JAX's `encoder_apply_fused`) and
`quantize`, the trainer's `train.discrete_vae_quantize`, and the long
flash forward (row 5) with its route. Inputs are seeded numpy arrays, weights
go from a flax tree to the port with `convert.from_flax_params`; JAX's Pallas
kernels run in interpret mode, as `tests/test_dvae.py` and
`tests/test_ops.py` run them. The port's wrappers take their plain versions
here because the tensors lie on the CPU; `chip_smoke.py` holds the CUDA
kernels against the same plain versions on the card.

Tolerances. fp32 paths agree to 1e-5 (both packages sum the same fp32
products in other orders; observed differences ~1e-6). The int8 trunk is
exact on both sides (integer sums, the same fp32 dequantization), so the
only difference in the int8 encoder's logits comes from the fp32 output
conv: 1e-5 again, and token ids must be equal.
"""

import functools
import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exploremultimodal_tpu.ops.dvae_conv as jdc
import exploremultimodal_tpu.ops.flash_attention as jfa
from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.infer import Predictor as JaxPredictor
from exploremultimodal_tpu.infer import _vqa_fn
from exploremultimodal_tpu.models.dvae import DalleEncoder as JaxDalleEncoder
from exploremultimodal_tpu.models.dvae import DalleVAE as JaxDalleVAE
from exploremultimodal_tpu.models.dvae import create_d_vae as jax_create_d_vae
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.models.task import build_model as jax_build_model
from exploremultimodal_tpu.ops.preprocess import preprocess_batch as jax_preprocess_batch
from exploremultimodal_tpu.ops.quant_conv import quant_conv as jax_quant_conv
from exploremultimodal_tpu.train.trainer import Trainer as JaxTrainer
import exploremultimodal_tpu.models.dvae as jdvae
import exploremultimodal_torch.models.dvae as pdvae
import exploremultimodal_torch.ops.dvae_conv as pdc
import exploremultimodal_torch.ops.flash_attention as pfa
from exploremultimodal_torch.config import load_config
from exploremultimodal_torch.infer import Predictor
from exploremultimodal_torch.models.convert import from_flax_params
from exploremultimodal_torch.ops.quant_conv import quant_conv
import exploremultimodal_torch.train.trainer as ptrainer
from exploremultimodal_torch.train.trainer import Trainer, dvae_type

ATOL = RTOL = 1e-5
NARROW = dict(n_hid=16)  # the int8 encoder's width here: n_blk 2, vocab 8192
TRAIN_TINY = [
    "model=vlmo_debug", "train=pretrain_mum", "model.img_size=64",
    "model.max_text_len=10", "compute_dtype=float32",
    "train.datasets=[synthetic]", "train.discrete_vae_type=random",
    "data.batch_size=2", "data.num_mask_patches=6",
    "data.min_mask_patches_per_block=2", "data.synthetic_size=12",
]
HIRES_TINY = [
    "model=vlmo_debug", "train=finetune_vqa", "model.img_size=384",
    "model.max_text_len=10", "compute_dtype=float32", "attn_impl=pallas",
    "model.mlp_impl=fused",
]


def _random_tree(shapes, seed: int):
    """Seeded numpy leaves for a flax shape tree: kernels normal with
    variance 1 / fan_in, LayerNorm scales near 1, everything else (biases,
    embeddings) small normals, so every leaf shows in the outputs."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0.0, fan_in ** -0.5, s.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + rng.normal(0.0, 0.1, s.shape)).astype(np.float32)
        return rng.normal(0.0, 0.05, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _encoder_params(enc, size: int, seed: int):
    img = jnp.zeros((1, size, size, 3), jnp.float32)
    return _random_tree(jax.eval_shape(enc.init, jax.random.key(0), img)["params"], seed)


def _counting(monkeypatch, module, name: str, calls: list | None = None) -> list:
    """Replace module.name with a pass-through that records each call in
    `calls` (a new list by default), which it returns."""
    calls = [] if calls is None else calls
    orig = getattr(module, name)

    def wrapper(*a, **kw):
        calls.append(name)
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return calls


# ------------------------------------------------------------- row 11


@pytest.mark.parametrize("has_id,pool", [(True, True), (False, False)])
def test_fused_block_plain_matches_jax_kernel(has_id, pool):
    """`fused_encoder_block` (the plain version on the CPU) against JAX's
    Pallas `_block_kernel` in interpret mode on one block in fp32: 8x8
    images in two row strips (row_tile 4), so the strips' halos and the
    zeroed image border both matter; post_gain 0.25 keeps the residual path
    visible. Tolerance 1e-5."""
    cin, cout = (16, 32) if has_id else (32, 32)
    enc_blk = pdvae.EncoderBlock(cin, cout, 0.25, torch.float32)
    rng = np.random.default_rng(20 + has_id)
    tree = {}
    for name, (a, b, k) in {"conv_1": (cin, cout // 4, 3), "conv_2": (cout // 4, cout // 4, 3),
                            "conv_3": (cout // 4, cout // 4, 3),
                            "conv_4": (cout // 4, cout, 1)}.items():
        tree[name] = {"conv": {
            "kernel": rng.normal(0, (a * k * k) ** -0.5, (k, k, a, b)).astype(np.float32),
            "bias": rng.normal(0, 0.1, b).astype(np.float32)}}
    if has_id:
        tree["id_conv"] = {"conv": {
            "kernel": rng.normal(0, cin ** -0.5, (1, 1, cin, cout)).astype(np.float32),
            "bias": rng.normal(0, 0.1, cout).astype(np.float32)}}
    enc_blk.load_state_dict(from_flax_params(tree), strict=True)
    x = rng.normal(size=(2, 8, 8, cin)).astype(np.float32)
    want = jdc.fused_encoder_block(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, tree),
                                   0.25, pool=pool, row_tile=4)
    got = pdc.fused_encoder_block(torch.from_numpy(x), enc_blk, 0.25, pool)
    assert got.shape == want.shape == ((2, 4, 4, cout) if pool else (2, 8, 8, cout))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert pdc.fused_encoder_block.launches == 0  # CPU tensors: the plain version


def test_kernel_weights_are_built_once_per_block():
    """The kernel's weight layouts are kept on the frozen block: a second
    call returns the same tensors; a weight changed in place or another
    dtype builds them again, from the new values."""
    blk = pdvae.EncoderBlock(16, 32, 0.25, torch.float32)
    first = pdc._kernel_weights(blk, torch.bfloat16)
    assert pdc._kernel_weights(blk, torch.bfloat16) is first
    assert first["w1"].shape == (3, 3, 8, 16) and first["wid"].shape == (32, 16)
    with torch.no_grad():
        blk.conv_1.conv.weight.add_(1.0)
    again = pdc._kernel_weights(blk, torch.bfloat16)
    assert again is not first
    torch.testing.assert_close(
        again["w1"], blk.conv_1.conv.weight.to(torch.bfloat16).permute(2, 3, 0, 1))
    assert pdc._kernel_weights(blk, torch.float32)["w1"].dtype == torch.float32


def test_encoder_apply_fused_matches_jax(monkeypatch):
    """JAX's `encoder_apply_fused` against the port's
    `DalleEncoder.forward(fused=True)` at 16^2, n_hid 128, one block per
    group, vocab 16, in fp32: both selectors fuse groups 1-3 (3 fused
    blocks) and send group 4 (2x2, no row tile) to the library path (JAX's
    `_xla_block`, the port's `EncoderBlock`); logits within 1e-5, token ids
    equal, and the port's fused ids equal its unfused ones."""
    kw = dict(n_hid=128, n_blk_per_group=1, vocab_size=16)
    params = _encoder_params(JaxDalleEncoder(**kw), 16, seed=30)
    img = np.random.default_rng(31).random((1, 16, 16, 3)).astype(np.float32)
    jcalls = _counting(monkeypatch, jdc, "fused_encoder_block")
    _counting(monkeypatch, jdc, "_xla_block", jcalls)
    fused = jax.jit(functools.partial(jdc.encoder_apply_fused, n_blk_per_group=1))
    want = np.asarray(fused(params, jnp.asarray(img)))  # the calls count at trace time

    enc = pdvae.DalleEncoder(**kw)
    enc.load_state_dict(from_flax_params(params), strict=True)
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    with torch.no_grad():
        unfused = enc(x).permute(0, 2, 3, 1)
        pcalls = _counting(monkeypatch, pdvae, "fused_encoder_block")
        _counting(monkeypatch, pdvae.EncoderBlock, "forward", pcalls)
        got = enc(x, fused=True).permute(0, 2, 3, 1)
    assert sorted(jcalls) == ["_xla_block"] + ["fused_encoder_block"] * 3
    assert sorted(pcalls) == ["forward"] + ["fused_encoder_block"] * 3
    assert got.shape == want.shape == (1, 2, 2, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    np.testing.assert_array_equal(got.argmax(-1).numpy(), unfused.argmax(-1).numpy())


def test_dalle_vae_fused_facade_and_exclusive_modes(monkeypatch):
    """`DalleVAE(fused=True)` gives the unfused ids and probabilities that
    sum to 1; `fused` together with `quantize` raises, as in JAX; without a
    GPU the tokenizer raises unless device='cpu' is asked for."""
    monkeypatch.setattr(pdvae, "DalleEncoder", functools.partial(
        pdvae.DalleEncoder, n_hid=128, n_blk_per_group=1, vocab_size=32))
    torch.manual_seed(0)
    img = pdvae.map_pixels(torch.rand(2, 16, 16, 3))
    vae = pdvae.DalleVAE(16, fused=True, device="cpu")  # nn.Conv2d's init: non-zero biases
    assert vae.encoder.input_conv.conv.weight.device.type == "cpu"
    ids = vae.get_codebook_indices(img)
    with torch.no_grad():
        unfused = vae.encoder(img.permute(0, 3, 1, 2)).argmax(1).flatten(1)
    assert ids.shape == (2, 4)
    assert torch.equal(ids, unfused)
    probs = vae.get_codebook_probs(img)
    assert probs.shape == (2, 2, 2, 32)
    torch.testing.assert_close(probs.sum(-1), torch.ones(2, 2, 2))
    with pytest.raises(ValueError, match="exclusive"):
        pdvae.DalleVAE(16, fused=True, quantize="w8a8")
    with pytest.raises(ValueError, match="exclusive"):
        JaxDalleVAE(16, fused=True, quantize="w8a8")
    with pytest.raises(ValueError, match="exclusive"):
        pdvae.DalleEncoder(n_hid=128, n_blk_per_group=1, vocab_size=32,
                           quantize="w8a8")(img.permute(0, 3, 1, 2), fused=True)
    with pytest.raises(ValueError, match="quantize"):
        pdvae.DalleVAE(16, quantize="int4", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdvae.DalleVAE(16, fused=True)


# ------------------------------------------------------------ int8 convs


@pytest.mark.parametrize("k,cin,cout", [(7, 3, 16), (3, 16, 8)])
def test_quant_conv_matches_jax_and_emitters_agree(k, cin, cout):
    """`quant_conv` equals JAX's `quant_conv` exactly (the codes, the
    integer sums and the fp32 dequantization are the same operations), and
    its two impls are bit-identical, as `tests/test_dvae.py` asserts for
    JAX's. k 7 is the input conv (K = 147); the 1x1 convs are in the
    encoder test below."""
    rng = np.random.default_rng(40 + k)
    x = rng.normal(size=(2, 12, 12, cin)).astype(np.float32)
    w = rng.normal(0, (k * k * cin) ** -0.5, (k, k, cin, cout)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    pad = (k - 1) // 2
    got = {impl: quant_conv(xt, wt, pad, impl) for impl in ("direct", "shifted")}
    assert torch.equal(got["direct"], got["shifted"])
    want = np.asarray(jax_quant_conv(jnp.asarray(x), jnp.asarray(w), pad, "direct"))
    np.testing.assert_array_equal(got["direct"].permute(0, 2, 3, 1).numpy(), want)
    with pytest.raises(ValueError, match="impl"):
        quant_conv(xt, wt, pad, "winograd")


@functools.cache
def _jax_encoder_logits(quantize: str):
    """JAX's encoder at the narrow width under `quantize`, jitted once per
    mode for the whole file (both tests below use 2 images at 32^2)."""
    enc = JaxDalleEncoder(**NARROW, quantize=quantize)
    return jax.jit(lambda p, x: enc.apply({"params": p}, x))


@functools.cache
def _narrow_params():
    return _encoder_params(JaxDalleEncoder(**NARROW), 32, seed=50)


def test_int8_encoder_matches_jax():
    """`DalleEncoder(quantize='w8a8')` against JAX's on the same weights at
    n_hid 16 and 32^2 (2 images): logits within 1e-5, token ids equal; the
    'w8a8_shifted' encoder's logits equal the direct one's bit for bit."""
    params = _narrow_params()
    img = np.random.default_rng(51).random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(_jax_encoder_logits("w8a8")(params, jnp.asarray(img)))
    got = {}
    for q in ("w8a8", "w8a8_shifted"):
        enc = pdvae.DalleEncoder(**NARROW, quantize=q)
        enc.load_state_dict(from_flax_params(params), strict=True)
        with torch.no_grad():
            got[q] = enc(torch.from_numpy(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert torch.equal(got["w8a8"], got["w8a8_shifted"])
    assert got["w8a8"].shape == want.shape == (2, 4, 4, 8192)
    np.testing.assert_allclose(got["w8a8"].numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got["w8a8"].argmax(-1).numpy(), want.argmax(-1))


@pytest.mark.parametrize("value", ["w8a8", "w8a8_shifted"])
def test_trainer_int8_dvae_gives_jax_mim_labels(monkeypatch, value):
    """The trainer passes `train.discrete_vae_quantize` to its dVAE as JAX's
    does (`create_d_vae(..., quantize=...)`), and its MIM labels on one
    vlmo_debug batch equal those of JAX's int8 encoder on the same weights
    and JAX's preprocessing of the batch. The dVAE is
    narrowed to n_hid 16 in both packages to keep JAX's int8 convs cheap,
    and JAX's labels are taken with its direct emitter for both values:
    `tests/test_dvae.py` holds JAX's two emitters bit-identical."""
    monkeypatch.setattr(pdvae, "DalleEncoder",
                        functools.partial(pdvae.DalleEncoder, **NARROW))
    trainer = Trainer(load_config(TRAIN_TINY + [f"train.discrete_vae_quantize={value}"]),
                      device="cpu")
    assert trainer.dvae.encoder.quantize == value
    params = _narrow_params()
    trainer.dvae.encoder.load_state_dict(from_flax_params(params), strict=True)
    batch = trainer.next_batch()
    got = trainer.model_batch(batch)["mim_labels"]

    raw = {k: jnp.asarray(v) for k, v in batch.items() if k != "index"}
    image = jax_preprocess_batch(raw)["image4dalle"]
    want = np.asarray(_jax_encoder_logits("w8a8")(params, image)).argmax(-1)
    want = want.reshape(want.shape[0], -1)
    assert got.shape == want.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def _preset_without_dvae_override():
    return [o for o in TRAIN_TINY if not o.startswith("train.discrete_vae_type")]


def test_trainer_falls_back_to_random_dvae_like_jax(monkeypatch, tmp_path, caplog):
    """The unmodified pretrain_mum preset ('dall-e' at weight/dalle/, with
    no encoder.pkl there) builds the random tokenizer, as JAX's
    `Trainer._dvae_type` resolves it, with JAX's warning; its MIM labels on
    one vlmo_debug batch equal those of JAX's `create_d_vae(path,
    _dvae_type(), ...)` on the same weights. The dVAE is narrowed to n_hid
    16 in both packages, and JAX's `init_random` (whose weights both
    sides replace) is skipped."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pdvae, "DalleEncoder",
                        functools.partial(pdvae.DalleEncoder, **NARROW))
    monkeypatch.setattr(jdvae, "DalleEncoder",
                        functools.partial(jdvae.DalleEncoder, **NARROW))
    monkeypatch.setattr(jdvae.DalleVAE, "init_random", lambda self, rng: None)
    overrides = _preset_without_dvae_override()
    kinds = []
    monkeypatch.setattr(ptrainer, "create_d_vae", lambda kind, *a, **kw: (
        kinds.append(kind) or pdvae.create_d_vae(kind, *a, **kw)))
    with caplog.at_level(logging.WARNING):
        trainer = Trainer(load_config(overrides), device="cpu")
    assert "dVAE weights not found at 'weight/dalle/'" in caplog.text
    assert kinds == ["random"] and trainer.dvae is not None

    jcfg = jax_load_config(overrides)
    assert jcfg.train.discrete_vae_type == "dall-e"
    kind = JaxTrainer._dvae_type(SimpleNamespace(cfg=jcfg, logger=logging.getLogger()))
    assert kind == "random"
    jvae = jax_create_d_vae(jcfg.train.discrete_vae_weight_path, kind, 32,
                            dtype=jnp.float32)
    params = _narrow_params()
    jvae.encoder_params = params
    trainer.dvae.encoder.load_state_dict(from_flax_params(params), strict=True)
    batch = trainer.next_batch()
    got = trainer.model_batch(batch)["mim_labels"]

    raw = {k: jnp.asarray(v) for k, v in batch.items() if k != "index"}
    image = jax_preprocess_batch(raw)["image4dalle"]
    want = np.asarray(jax.jit(jvae.get_codebook_indices)(image))
    assert got.shape == want.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_trainer_refuses_dalle_weights_it_cannot_load(monkeypatch, tmp_path):
    """With an encoder.pkl at the preset's weight path the type stays
    'dall-e', and the port raises instead of training on random codes
    where JAX would load the weights; other types pass through."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "weight" / "dalle").mkdir(parents=True)
    (tmp_path / "weight" / "dalle" / "encoder.pkl").write_bytes(b"")
    cfg = load_config(_preset_without_dvae_override())
    assert dvae_type(cfg["train"]) == "dall-e"
    with pytest.raises(NotImplementedError, match="DALL-E weights"):
        Trainer(cfg, device="cpu")
    assert dvae_type({"discrete_vae_type": "random"}) == "random"


# --------------------------------------------------------------- row 5


def _qkv(n: int, bh: tuple = (1, 2), d: int = 32, seed: int = 60):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(*bh, n, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((bh[0], n), np.float32)
    mask[:, n - 37:] = 0  # padded keys
    bias = ((1.0 - mask) * -1e30)[:, None, None, :].astype(np.float32)
    return q, k, v, bias


def _route(monkeypatch, n: int, full_row_max: int):
    """Which forward each package's `flash_attention` runs at length n
    (BH = 1), with FULL_ROW_FWD_MAX set to `full_row_max` in both; the
    kernels are replaced by recorders returning zeros."""
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jfa, "FULL_ROW_FWD_MAX", full_row_max)
    monkeypatch.setattr(pfa, "FULL_ROW_FWD_MAX", full_row_max)
    monkeypatch.setattr(jfa, "_fwd_call", lambda qf, *a: (
        seen["jax"].append("full_row") or (jnp.zeros_like(qf), jnp.zeros(qf.shape[:2]))))
    monkeypatch.setattr(jfa, "_long_fwd_call", lambda qf, *a: (
        seen["jax"].append("long") or jnp.zeros_like(qf)))
    monkeypatch.setattr(pfa, "flash_attention_fwd", lambda qf, *a: (
        seen["port"].append("full_row") or (torch.zeros_like(qf), torch.zeros(qf.shape[:2]))))
    monkeypatch.setattr(pfa, "flash_attention_fwd_long", lambda qf, *a: (
        seen["port"].append("long") or torch.zeros_like(qf)))
    q, k, v, _ = _qkv(n, bh=(1, 1), d=16)
    jfa.flash_attention(*map(jnp.asarray, (q, k, v)), scale=0.25)
    pfa.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0.25)
    return seen


@pytest.mark.parametrize("n,full_row_max,route", [
    (577, 512, "long"),      # padded 640 > 512: row 5 under the patch
    (577, 4096, "full_row"),  # 512 < 640 <= 4096: the full-row kernel (row 1)
    (4097, 4096, "long"),     # padded 4224 > 4096: row 5 unpatched
])
def test_long_route_matches_jax(monkeypatch, n, full_row_max, route):
    """`_FlashLong` picks what `_long_primal` picks, both on the padded N
    and on FULL_ROW_FWD_MAX read at call time."""
    seen = _route(monkeypatch, n, full_row_max)
    assert seen["jax"] == seen["port"] == [route]


def test_long_forward_and_grads_match_jax(monkeypatch):
    """At N = 577 with FULL_ROW_FWD_MAX = 512 in both packages, JAX's
    `_attn_long_kernel` (interpret mode) and the port's row 5 (its plain
    version) give the same output, and the plain-recompute backward the
    same gradients, in fp32 with padded keys. Tolerance 1e-5."""
    monkeypatch.setattr(jfa, "FULL_ROW_FWD_MAX", 512)
    monkeypatch.setattr(pfa, "FULL_ROW_FWD_MAX", 512)
    jlong = _counting(monkeypatch, jfa, "_long_fwd_call")
    plong = _counting(monkeypatch, pfa, "flash_attention_fwd_long")
    q, k, v, bias = _qkv(577)
    g = np.random.default_rng(61).normal(size=q.shape).astype(np.float32)
    scale = 32 ** -0.5
    def fwd_bwd(a, b, c, cot):
        out, vjp = jax.vjp(lambda a_, b_, c_: jfa.flash_attention(
            a_, b_, c_, bias=jnp.asarray(bias), scale=scale), a, b, c)
        return out, vjp(cot)

    want, want_grads = jax.jit(fwd_bwd)(*map(jnp.asarray, (q, k, v, g)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    got = pfa.flash_attention(*leaves, bias=torch.from_numpy(bias), scale=scale)
    got_grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    assert jlong and plong
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for name, a, b in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{name}")


def test_hires_vqa_logits_match_jax_through_row5(monkeypatch):
    """`Predictor.vqa_logits` at vlmo_debug, image 384 (577 image and 587
    fused tokens), attn_impl=pallas, with FULL_ROW_FWD_MAX = 512 in both
    packages, against JAX's `Predictor` on the same weights: both run the
    long forward on the image and fused streams (one layer each) and the
    full-row one on the text stream. fp32 logits within 1e-4, as the
    serving tests allow over a 3129-way head."""
    monkeypatch.setattr(jfa, "FULL_ROW_FWD_MAX", 512)
    monkeypatch.setattr(pfa, "FULL_ROW_FWD_MAX", 512)
    task = jax_build_model(jax_load_config(HIRES_TINY))
    dummy = {"image": jnp.zeros((1, 384, 384, 3)), "text_ids": jnp.zeros((1, 10), jnp.int32),
             "text_mask": jnp.ones((1, 10), jnp.int32)}
    shapes = jax.eval_shape(lambda key: task.init(
        {"params": key}, dummy, method=JaxTask.init_inference), jax.random.key(0))["params"]
    params = _random_tree(shapes, seed=70)
    rng = np.random.default_rng(71)
    img = rng.integers(0, 256, (1, 384, 384, 3), dtype=np.uint8)
    ids = rng.integers(1000, 30522, (1, 10)).astype(np.int32)
    mask = np.ones((1, 10), np.int32)
    ids[0, 7:], mask[0, 7:] = 0, 0
    jlong = _counting(monkeypatch, jfa, "_long_fwd_call")
    plong = _counting(monkeypatch, pfa, "flash_attention_fwd_long")
    want = JaxPredictor(jax_load_config(HIRES_TINY), params, max_batch=1)._run(
        "vqa", _vqa_fn, 1, img, ids, mask)
    got = Predictor(load_config(HIRES_TINY), from_flax_params(params), max_batch=1,
                    device="cpu").vqa_logits(img, ids, mask)
    assert len(jlong) == len(plong) == 2
    assert got.shape == want.shape == (1, 3129)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
