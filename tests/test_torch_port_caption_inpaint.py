"""The PyTorch port's caption and inpaint endpoints, the DALL-E decoder, the
trainable `DiscreteVAE` and finetune_vqa's test-split submission against
the JAX package, on the CPU.

At vlmo_debug 32 wide (2 heads, 32^2 images, 10 tokens) in fp32 with the
same seeded flax parameters (`convert.from_flax_params`): `caption_ids`
equal to JAX's `_caption_fn` and the `caption` strings equal through the
repository's `resource/bert-base-uncased`; `inpaint` images within 1e-5
and the merged codes equal, the dVAE narrowed to n_hid 16 in both
packages (as `tests/test_torch_port_dvae.py` narrows it); the antialiased
resize against `jax.image.resize`; `DalleDecoder` and `decode` within 1e-4;
`load_dalle_vae` on a written `decoder.pkl`, and raising as JAX's where it
is missing; `write_vqa_submission`'s JSON equal to JAX's; `DiscreteVAE`
(reconstruction, loss, ids and gradients) through the ConvTranspose rule,
which a control shows is wrong without its flip.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import exploremultimodal_tpu.data.datasets as jdatasets
import exploremultimodal_tpu.models.dvae as jdvae
from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.infer import Predictor as JaxPredictor
from exploremultimodal_tpu.infer import _caption_fn
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.models.task import build_model as jax_build_model
from exploremultimodal_tpu.train.phases import write_vqa_submission as jax_write_submission
from exploremultimodal_tpu.train.trainer import Trainer as JaxTrainer
import exploremultimodal_torch.infer as pinfer
import exploremultimodal_torch.models.dvae as pdvae
from exploremultimodal_torch.config import load_config
from exploremultimodal_torch.data.datasets import build_dataset
from exploremultimodal_torch.data.masking import RegionMaskingGenerator
from exploremultimodal_torch.data.pipeline import Loader
from exploremultimodal_torch.infer import Predictor
from exploremultimodal_torch.models.convert import from_flax_params, load_flax_train_state
from exploremultimodal_torch.ops.preprocess import preprocess_batch
from exploremultimodal_torch.train.phases import write_vqa_submission
from exploremultimodal_torch.train.trainer import Trainer

IMG, TEXT_LEN, WIDTH, MASK_ID = 32, 10, 32, 103
TINY = [
    "model=vlmo_debug", f"model.img_size={IMG}", f"model.embed_dim={WIDTH}",
    "model.num_heads=2", f"model.max_text_len={TEXT_LEN}", "compute_dtype=float32",
    "train.datasets=[synthetic]", "data.batch_size=2", "data.synthetic_size=4",
    "data.num_mask_patches=2", "data.min_mask_patches_per_block=1",
    "model.drop_rate=0.0", "model.attn_drop_rate=0.0", "model.drop_path_rate=0.0",
    "attn_impl=recompute",
]
NARROW = dict(n_hid=16)
NARROW_DEC = dict(n_hid=16, n_init=8)


def _jitted_dvae_init(self, rng):
    """JAX's `DalleVAE.init_random` with each module's init under jit (the
    same draws; eagerly, the decoder's 8192-channel input costs seconds)."""
    r1, r2 = jax.random.split(rng)
    self.encoder_params = jax.jit(self.encoder.init)(
        r1, jnp.zeros((1, self.image_size, self.image_size, 3)))["params"]
    grid = self.image_size // 8
    self.decoder_params = jax.jit(self.decoder.init)(
        r2, jnp.zeros((1, grid, grid, self.encoder.vocab_size)))["params"]


def _jitted_init(init):
    """flax's `Module.init` under one jit (JAX's trainer initializes
    eagerly, op by op, which costs seconds of compiles)."""
    jitted = jax.jit(lambda self, r, a, method: init(self, r, *a, method=method),
                     static_argnums=(0, 3))
    return lambda self, rngs, *args, method=None: jitted(self, rngs, args, method)


@pytest.fixture(autouse=True, scope="module")
def _setting():
    """The dVAE narrowed in both packages, JAX's inits jitted, and two
    torch threads (beside the other test processes), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdvae, "DalleEncoder", functools.partial(pdvae.DalleEncoder, **NARROW))
        mp.setattr(pdvae, "DalleDecoder", functools.partial(pdvae.DalleDecoder, **NARROW_DEC))
        mp.setattr(jdvae, "DalleEncoder", functools.partial(jdvae.DalleEncoder, **NARROW))
        mp.setattr(jdvae, "DalleDecoder", functools.partial(jdvae.DalleDecoder, **NARROW_DEC))
        mp.setattr(jdvae.DalleVAE, "init_random", _jitted_dvae_init)
        mp.setattr(JaxTask, "init", _jitted_init(JaxTask.init))
        yield
    torch.set_num_threads(n)


def _jittered(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + rng.normal(0, 0.05, x.shape).astype(np.float32),
        jax.device_get(tree))


@functools.cache
def _weights(phase: str):
    """JAX's initial parameters of the phase's task at TINY, every leaf
    jittered, and its config in both packages."""
    overrides = TINY + [f"train={phase}"]
    cfg = load_config(overrides)
    host = next(Loader(build_dataset(cfg), 2, seed=0).epoch(0))
    mb = preprocess_batch({k: torch.from_numpy(v) for k, v in host.items() if k != "index"})
    jb = {k: jnp.asarray(v.numpy()) for k, v in mb.items()}
    if "image4dalle" in jb:
        jb["mim_labels"] = jnp.zeros(jb["image_bool_masked_pos"].shape, jnp.int32)
    jcfg = jax_load_config(overrides)
    jtask = jax_build_model(jcfg)
    init = jax.jit(lambda key: jtask.init({"params": key, "sample": jax.random.key(1)},
                                          jb, method=JaxTask.init_streams))
    return jcfg, cfg, _jittered(init(jax.random.key(0))["params"], 3)


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)


# ---------------------------------------------------------------- caption


def _caption_rows(lengths):
    rows, masks = [], []
    for t in lengths:
        row = [101] + [MASK_ID] * t + [102] + [0] * (TEXT_LEN - 2 - t)
        rows.append(row)
        masks.append([1] * (t + 2) + [0] * (TEXT_LEN - 2 - t))
    return np.asarray(rows, np.int32), np.asarray(masks, np.int32)


@pytest.mark.parametrize("n_iter", [1, 3, 8])
def test_caption_ids_match_jax(n_iter):
    """`caption_ids` on rows with 8, 5, 1 and 3 generated tokens equals
    JAX's `_caption_fn` (one jitted program) exactly, int32; every [MASK]
    is filled and the other positions keep their ids."""
    jcfg, cfg, params = _weights("finetune_caption")
    img = _images(4)
    ids, mask = _caption_rows([8, 5, 1, 3])
    jtask = jax_build_model(jcfg)
    fn = functools.partial(_caption_fn, n_iter=n_iter, mask_id=MASK_ID)
    want = np.asarray(jax.jit(lambda v, *xs: jtask.apply(v, *xs, method=fn))(
        {"params": params}, img, ids, mask))
    pred = Predictor(cfg, from_flax_params(params), device="cpu")
    got = pred.caption_ids(img, ids, mask, n_iter, MASK_ID)
    assert got.dtype == np.int32 == want.dtype
    np.testing.assert_array_equal(got, want)
    assert not (got == MASK_ID).any()
    np.testing.assert_array_equal(got[ids != MASK_ID], ids[ids != MASK_ID])


def test_mask_predict_step_keeps_the_most_confident():
    """`mask_predict_step` with 4 generated positions of 6 whose
    confidences are 9, 3, 3 and 7: at iteration 0 of 2 the 2 most confident
    keep their argmax and the others are re-masked; at 1 of 3 (3 kept) the
    tie goes to the earlier position (stable sorts); at the last every
    position is filled; positions not generated keep their ids whatever
    their logits."""
    logits = torch.full((1, 6, 5), -5.0)
    for pos, (tok, val) in enumerate([(0, 1.0), (1, 9.0), (2, 3.0), (3, 3.0), (4, 7.0),
                                      (0, 9.0)]):
        logits[0, pos, tok] = val
    ids = torch.tensor([[101, MASK_ID, MASK_ID, MASK_ID, MASK_ID, 102]], dtype=torch.int32)
    gen = ids == MASK_ID
    n_gen = gen.sum(1, dtype=torch.int32)
    for it, n_iter, want in ((0, 2, [101, 1, MASK_ID, MASK_ID, 4, 102]),
                             (1, 3, [101, 1, 2, MASK_ID, 4, 102]),
                             (1, 2, [101, 1, 2, 3, 4, 102])):
        out = pinfer.mask_predict_step(logits, ids, gen, n_gen, it, n_iter, MASK_ID)
        assert out.tolist() == [want] and out.dtype == torch.int32


def test_caption_strings_match_jax():
    """`caption` through the repository's BERT tokenizer equals JAX's
    `Predictor.caption` on the same weights, at two budgets."""
    jcfg, cfg, params = _weights("finetune_caption")
    img = _images(3, seed=1)
    jpred = JaxPredictor(jcfg, params)
    pred = Predictor(cfg, from_flax_params(params), device="cpu")
    for max_tokens, n_iter in ((4, 2), (16, 3)):
        want = jpred.caption(img, max_tokens=max_tokens, n_iter=n_iter)
        got = pred.caption(img, max_tokens=max_tokens, n_iter=n_iter)
        assert got == want and len(got) == 3 and all(isinstance(c, str) for c in got)


# ---------------------------------------------------------------- inpaint


def test_resize_matches_jax_antialiased_bilinear():
    """The dVAE input's 2x downscale: `F.interpolate(..., antialias=True)`
    equals `jax.image.resize(..., 'bilinear')` (a 4-tap triangle filter)
    within 1e-6 at 32 -> 16 and 224 -> 112; without antialiasing (2 taps)
    it is far off."""
    for size in (32, 224):
        x = np.random.default_rng(size).random((2, size, size, 3), np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, size // 2, size // 2, 3),
                                           "bilinear"))
        t = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = F.interpolate(t, size=(size // 2, size // 2), mode="bilinear",
                            align_corners=False, antialias=True).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        plain = F.interpolate(t, size=(size // 2, size // 2), mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1)
        assert np.abs(plain.numpy() - want).max() > 0.05


def _port_dvae(jvae, size):
    vae = pdvae.DalleVAE(size, device="cpu", decoder=True)
    vae.encoder.load_state_dict(from_flax_params(jax.device_get(jvae.encoder_params)),
                                strict=True)
    vae.decoder.load_state_dict(from_flax_params(jax.device_get(jvae.decoder_params)),
                                strict=True)
    return vae.eval().requires_grad_(False)


def test_inpaint_matches_jax():
    """`inpaint` with one region mask a row and captions: the repainted
    images within 1e-5 of JAX's `Predictor.inpaint` and the merged codes
    equal; outside the mask the image is the resized input and the codes
    the dVAE encoder's own; `inpaint_ids` is what `inpaint` tokenizes to."""
    jcfg, cfg, params = _weights("finetune_inpainting")
    img = _images(3, seed=2)
    region = RegionMaskingGenerator(2, 2)
    rng = np.random.default_rng(0)
    pm = np.stack([region(rng).reshape(-1) for _ in range(3)])
    pm[0] = [1, 0, 0, 0]
    texts = ["a red square", "", "two cats on a sofa"]
    jpred = JaxPredictor(jcfg, params)
    want_img, want_codes = jpred.inpaint(img, pm, texts)
    pred = Predictor(cfg, from_flax_params(params), device="cpu")
    pred._dvae = _port_dvae(jpred.dvae, IMG // 2)
    got_img, got_codes = pred.inpaint(img, pm, texts)
    assert got_img.shape == want_img.shape == (3, IMG // 2, IMG // 2, 3)
    np.testing.assert_allclose(got_img, np.asarray(want_img), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_codes, np.asarray(want_codes))
    assert got_codes.dtype == np.int32
    ids, mask = pred.tokenize(texts)
    again = pred.inpaint_ids(img, pm.reshape(3, 2, 2), ids, mask)
    np.testing.assert_array_equal(again[1], got_codes)
    small = F.interpolate(torch.from_numpy(img).float().permute(0, 3, 1, 2) / 255.0,
                          size=(IMG // 2, IMG // 2), mode="bilinear", antialias=True)
    small = small.permute(0, 2, 3, 1)
    codes = pred.dvae.get_codebook_indices(pdvae.map_pixels(small)).numpy()
    keep = pm == 0
    np.testing.assert_array_equal(got_codes[keep], codes[keep])
    pix = np.repeat(np.repeat(pm.reshape(3, 2, 2), 8, 1), 8, 2) == 0
    np.testing.assert_allclose(got_img[pix], small.numpy()[pix], rtol=0, atol=1e-6)


def test_inpaint_needs_patch_16():
    """At another patch size the dVAE's grid is not the patch grid: the
    port raises (ROADMAP C4; JAX's endpoint would paste at the wrong
    cells)."""
    cfg = load_config(TINY + ["train=finetune_inpainting", "model.patch_size=8"])
    from exploremultimodal_torch.models.task import build_model

    pred = Predictor(cfg, build_model(cfg, device="cpu").state_dict(), device="cpu")
    with pytest.raises(ValueError, match="patch_size 16"):
        pred.inpaint_ids(_images(1), np.zeros((1, 16), np.int32),
                         np.zeros((1, TEXT_LEN), np.int32), np.ones((1, TEXT_LEN), np.int32))


# ------------------------------------------------------------ the decoder


def test_decoder_and_decode_match_jax():
    """`DalleDecoder` (narrowed) on one-hot codes and `DalleVAE.decode` on
    ids within 1e-4 of JAX's; the 2x upsampling between groups equals
    `jax.image.resize(..., 'nearest')`; `unmap_pixels` equals JAX's."""
    jvae = jdvae.DalleVAE(32)
    jvae.init_random(jax.random.key(0))
    vae = _port_dvae(jvae, 32)
    ids = np.random.default_rng(5).integers(0, 8192, (2, 16)).astype(np.int32)
    want = np.asarray(jax.jit(jvae.decode)(jnp.asarray(ids)))
    got = vae.decode(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    x = np.random.default_rng(6).normal(size=(2, 3, 5, 4)).astype(np.float32)
    up = torch.from_numpy(x).permute(0, 3, 1, 2).repeat_interleave(2, 2).repeat_interleave(2, 3)
    np.testing.assert_array_equal(up.permute(0, 2, 3, 1).numpy(), np.asarray(
        jax.image.resize(jnp.asarray(x), (2, 6, 10, 4), "nearest")))
    np.testing.assert_array_equal(pdvae.unmap_pixels(torch.from_numpy(x)).numpy(),
                                  np.asarray(jdvae.unmap_pixels(jnp.asarray(x))))


def _dall_e_state(params):
    """A flax dVAE tree under OpenAI's `dall_e` names, OIHW kernels."""
    out = {}
    for mod, leaf in params.items():
        if mod in ("input_conv", "output_conv"):
            base = "blocks.input" if mod == "input_conv" else "blocks.output.conv"
            convs = {base: leaf["conv"]}
        else:
            g, b = mod.split("_")[1], mod.split("_")[3]
            convs = {(f"blocks.group_{g}.block_{b}.id_path" if k == "id_conv" else
                      f"blocks.group_{g}.block_{b}.res_path.{k}"): v["conv"]
                     for k, v in leaf.items()}
        for name, conv in convs.items():
            out[f"{name}.w"] = torch.from_numpy(
                np.asarray(conv["kernel"]).transpose(3, 2, 0, 1).copy())
            out[f"{name}.b"] = torch.from_numpy(np.asarray(conv["bias"]).copy())
    return out


def test_load_dalle_vae_reads_the_decoder_like_jax(tmp_path):
    """`load_dalle_vae` reads `decoder.pkl` through the encoder's name map:
    its `decode` equals that of JAX's `load_dalle_vae` on the same files;
    without `decoder.pkl` both raise FileNotFoundError (ROADMAP C8); an
    empty one leaves the port's tokenizer without a decoder, whose decode
    raises."""
    jvae = jdvae.DalleVAE(32)
    jvae.init_random(jax.random.key(1))
    torch.save(_dall_e_state(jax.device_get(jvae.encoder_params)), tmp_path / "encoder.pkl")
    torch.save(_dall_e_state(jax.device_get(jvae.decoder_params)), tmp_path / "decoder.pkl")
    ids = np.random.default_rng(7).integers(0, 8192, (2, 16)).astype(np.int32)
    jl = jdvae.load_dalle_vae(str(tmp_path), 32)
    want = np.asarray(jax.jit(jl.decode)(jnp.asarray(ids)))
    vae = pdvae.load_dalle_vae(str(tmp_path), 32, device="cpu")
    got = vae.decode(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    img = np.random.default_rng(8).random((1, 32, 32, 3), np.float32)
    np.testing.assert_array_equal(
        vae.get_codebook_indices(torch.from_numpy(img)).numpy(),
        np.asarray(jax.jit(jl.get_codebook_indices)(jnp.asarray(img))))
    torch.save({}, tmp_path / "decoder.pkl")
    with pytest.raises(RuntimeError, match="no decoder"):
        pdvae.load_dalle_vae(str(tmp_path), 32, device="cpu").decode(torch.from_numpy(ids))
    (tmp_path / "decoder.pkl").unlink()
    with pytest.raises(FileNotFoundError):
        jdvae.load_dalle_vae(str(tmp_path), 32)
    with pytest.raises(FileNotFoundError):
        pdvae.load_dalle_vae(str(tmp_path), 32, device="cpu")


def test_random_tokenizer_draws_its_decoder_after_the_encoder():
    """`create_d_vae('random', decoder=True)` keeps the encoder of the
    tokenizer without a decoder (the decoder's draws come after it), and
    `customized` still raises, as JAX's `create_d_vae` does."""
    a = pdvae.create_d_vae("random", 16, torch.float32, device="cpu")
    b = pdvae.create_d_vae("random", 16, torch.float32, device="cpu", decoder=True)
    assert a.decoder is None and b.decoder is not None
    for (k, v), w in zip(a.encoder.state_dict().items(), b.encoder.state_dict().values()):
        assert torch.equal(v, w), k
    assert b.decoder.input_conv.conv.weight.abs().sum() > 0
    with pytest.raises(NotImplementedError):
        pdvae.create_d_vae("customized", 16, torch.float32, device="cpu")
    with pytest.raises(NotImplementedError):
        jdvae.create_d_vae("", "customized", 16)


# ----------------------------------------------------------- DiscreteVAE

DVAE_ARGS = dict(image_size=32, num_tokens=64, codebook_dim=16, num_layers=2, hidden_dim=8)


@functools.cache
def _discrete_vae(straight_through: bool):
    jm = jdvae.DiscreteVAE(**DVAE_ARGS, straight_through=straight_through)
    img = np.random.default_rng(9).normal(size=(2, 32, 32, 3)).astype(np.float32)
    params = _jittered(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(img))["params"], 4)
    return jm, img, params


@pytest.mark.parametrize("straight_through", [False, True])
def test_discrete_vae_matches_jax(straight_through):
    """`DiscreteVAE` with flax's parameters through `from_flax_params` (the
    transposed convs by their flipped rule): the reconstruction within 1e-5
    of its largest magnitude, the loss within 1e-5, the code ids equal, and
    every parameter's gradient of the loss within 1e-4 of its largest
    magnitude; deterministic (no Gumbel noise) in both."""
    jm, img, params = _discrete_vae(straight_through)

    def loss_fn(p):
        recon, loss = jm.apply({"params": p}, jnp.asarray(img))
        return loss, recon

    (jloss, jrecon), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    jids = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(img),
                                                  method=jm.get_codebook_indices))(params))
    model = pdvae.DiscreteVAE(**DVAE_ARGS, straight_through=straight_through)
    model.load_state_dict(from_flax_params(params), strict=True)
    recon, loss = model(torch.from_numpy(img))
    loss.backward()
    jrecon = np.asarray(jrecon)
    np.testing.assert_allclose(recon.detach().numpy(), jrecon, rtol=1e-5,
                               atol=1e-5 * np.abs(jrecon).max())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(model.get_codebook_indices(torch.from_numpy(img)).numpy(),
                                  jids)
    for name, g in from_flax_params(jax.device_get(jg)).items():
        got = model.get_parameter(name).grad
        w = g.numpy()
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_conv_transpose_rule_needs_the_flip():
    """Control: loading the transposed convs' kernels with the plain
    transpose (no spatial flip) gives another reconstruction, far outside
    the tolerance above; so the comparison fails without the flip."""
    jm, img, params = _discrete_vae(False)
    jrecon, _ = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(img)))(params)
    state = from_flax_params(params)
    for i in range(DVAE_ARGS["num_layers"]):
        k = np.asarray(params[f"dec_convs_{i}"]["kernel"])
        state[f"dec_convs_{i}.weight"] = torch.from_numpy(k.transpose(2, 3, 0, 1).copy())
        assert not torch.equal(state[f"dec_convs_{i}.weight"],
                               from_flax_params(params)[f"dec_convs_{i}.weight"])
    model = pdvae.DiscreteVAE(**DVAE_ARGS)
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        recon, _ = model(torch.from_numpy(img))
    jrecon = np.asarray(jrecon)
    assert np.abs(recon.numpy() - jrecon).max() > 100 * 1e-5 * np.abs(jrecon).max()


def test_discrete_vae_gumbel_draws_on_its_generator():
    """With a generator, the Gumbel noise comes from it: the same seed gives
    the same reconstruction, another seed or no noise another."""
    _, img, params = _discrete_vae(False)
    model = pdvae.DiscreteVAE(**DVAE_ARGS)
    model.load_state_dict(from_flax_params(params), strict=True)
    x = torch.from_numpy(img)
    with torch.no_grad():
        a = model(x, torch.Generator().manual_seed(0))[0]
        b = model(x, torch.Generator().manual_seed(0))[0]
        c = model(x, torch.Generator().manual_seed(1))[0]
        d = model(x)[0]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


# ------------------------------------------------------------- submission


def test_write_vqa_submission_matches_jax(tmp_path, monkeypatch):
    """finetune_vqa's test-split submission from JAX's initial parameters:
    the merged `vqa_submit.json` equals JAX's `write_vqa_submission`'s,
    question by question and answer by answer, with `vqa_submit_0.json`
    beside it. JAX's needs a `qid` per sample (its synthetic samples have
    none, so its phase skips the submission, ROADMAP C10); here JAX's
    samples take their index as `qid`, as the port's submission does."""
    overrides = TINY + ["train=finetune_vqa", "data.synthetic_size=5"]
    getitem = jdatasets.SyntheticDataset.__getitem__
    monkeypatch.setattr(jdatasets.SyntheticDataset, "__getitem__",
                        lambda self, i: {**getitem(self, i), "qid": np.int64(i)})
    jtrainer = JaxTrainer(jax_load_config(overrides + [f"exp_dir={tmp_path}/jax"]))
    batch = next(iter(jtrainer.data.train_loader()))
    state = jtrainer.init_state({k: jnp.asarray(v) for k, v in batch.items()
                                 if not isinstance(v, list)})
    want_path = jax_write_submission(jtrainer, state)
    trainer = Trainer(load_config(overrides + [f"exp_dir={tmp_path}/port"]), device="cpu")
    load_flax_train_state(trainer.state, {"params": jax.device_get(state.params)})
    path = write_vqa_submission(trainer)
    assert path == str(tmp_path / "port" / "submit" / "vqa_submit.json")
    got, want = json.load(open(path)), json.load(open(want_path))
    assert got == want and len(got) == 6  # 5 samples in batches of 2, padded
    assert json.load(open(tmp_path / "port" / "submit" / "vqa_submit_0.json")) == got
    assert sorted({r["question_id"] for r in got}) == [0, 1, 2, 3, 4]
