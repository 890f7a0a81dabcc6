"""The PyTorch port's retrieval and NLVR2 serving endpoints and its
retrieval recall against the JAX package, on the CPU.

The same seeded flax weights (JAX's init, through `from_flax_params`) and the
same numpy inputs go through JAX's endpoint functions (`_encode_image_fn`,
`_encode_text_fn`, `_itm_fn`, `_nlvr2_fn`), its `Predictor` (`similarity` and
the string endpoints) and its `recall_at_k` / `evaluate_retrieval`, and
through the port's `Predictor` and `train/retrieval.py`, in fp32 at a small
width (vlmo_debug: depth 2, width 96; 32^2 images, 10 tokens): outputs
within 1e-5 absolute, recalls exactly equal. pretrain_mum's heads serve
encode_image, encode_text, similarity and itm_score, finetune_nlvr2's
serve nlvr2.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.data.datamodule import MultiTaskData
from exploremultimodal_tpu.infer import Predictor as JaxPredictor
from exploremultimodal_tpu.infer import (
    _encode_image_fn,
    _encode_text_fn,
    _itm_fn,
    _nlvr2_fn,
)
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.models.task import build_model as jax_build_model
from exploremultimodal_tpu.train import retrieval as jretrieval
from exploremultimodal_torch.config import load_config
from exploremultimodal_torch.infer import Predictor, _pad_to
from exploremultimodal_torch.models.convert import from_flax_params
from exploremultimodal_torch.train import retrieval as pretrieval
from exploremultimodal_torch.train.trainer import Trainer

IMG, TEXT_LEN = 32, 10
TINY = ["model=vlmo_debug", f"model.img_size={IMG}", f"model.max_text_len={TEXT_LEN}",
        "compute_dtype=float32", "attn_impl=pallas", "model.mlp_impl=fused"]
PHASES = {"mum": TINY + ["train=pretrain_mum"], "nlvr2": TINY + ["train=finetune_nlvr2"]}
ATOL = 1e-5


def _jitter(params):
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
def weights():
    """Per phase: JAX's task and its serving init (`init_inference`, as
    JAX's `Predictor.from_checkpoint` builds it), with non-zero biases,
    LayerNorm affines and, for pretrain_mum, a moved ITC temperature."""
    out = {}
    dummy = {"image": jnp.zeros((1, IMG, IMG, 3), jnp.float32),
             "text_ids": jnp.zeros((1, TEXT_LEN), jnp.int32),
             "text_mask": jnp.ones((1, TEXT_LEN), jnp.int32)}
    for phase, overrides in PHASES.items():
        task = jax_build_model(jax_load_config(overrides))
        init = jax.jit(lambda key, t=task: t.init({"params": key}, dummy,
                                                  method=JaxTask.init_inference))
        params = _jitter(init(jax.random.key(0))["params"])
        if "itc_temp" in params:
            params["itc_temp"] = np.asarray(2.1, np.float32)
        out[phase] = (task, params)
    return out


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    img0, img1 = (rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8) for _ in range(2))
    ids = rng.integers(1000, 30522, (n, TEXT_LEN)).astype(np.int32)
    mask = np.ones((n, TEXT_LEN), np.int32)
    for i in range(n):
        length = int(rng.integers(3, TEXT_LEN + 1))
        ids[i, length:] = 0
        mask[i, length:] = 0
    return img0, img1, ids, mask


def _port(weights, phase, max_batch=8):
    return Predictor(load_config(PHASES[phase]), from_flax_params(weights[phase][1]),
                     max_batch=max_batch, device="cpu")


ENDPOINTS = {
    # name: (phase, JAX function, its inputs, the port's call)
    "encode_image": ("mum", _encode_image_fn, lambda x: (x[0],),
                     lambda p, x: p.encode_image(x[0])),
    "encode_text": ("mum", _encode_text_fn, lambda x: (x[2], x[3]),
                    lambda p, x: p.encode_text_ids(x[2], x[3])),
    "itm_score": ("mum", _itm_fn, lambda x: (x[0], x[2], x[3]),
                  lambda p, x: p.itm_score_ids(x[0], x[2], x[3])),
    "nlvr2": ("nlvr2", _nlvr2_fn, lambda x: (x[0], x[1], x[2], x[3]),
              lambda p, x: p.nlvr2_ids(x[0], x[1], x[2], x[3])),
}


@pytest.mark.parametrize("name", list(ENDPOINTS))
def test_endpoints_match_jax(weights, name):
    """Each endpoint on token ids against JAX's function on the same padded
    batch (3 rows padded to the bucket of 4): unit-norm ITC embeddings, the
    ITM match probability, the NLVR2 probability, fp32 within 1e-5."""
    phase, jfn, jargs, call = ENDPOINTS[name]
    jtask, params = weights[phase]
    x = _inputs(3)
    want = np.asarray(jtask.apply({"params": params},
                                  *(jnp.asarray(_pad_to(a, 4)) for a in jargs(x)),
                                  method=jfn))[:3]
    got = call(_port(weights, phase), x)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if name.startswith("encode"):
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    else:
        assert ((got > 0) & (got < 1)).all()


@pytest.mark.parametrize("phase", list(PHASES))
def test_similarity_matches_jax(weights, phase):
    """Cosines scaled by exp(itc_temp) from the weights (pretrain_mum), or by
    1 / model.itc_temp where they have no ITC head (finetune_nlvr2), as
    JAX's `Predictor.similarity`."""
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(n, 256)).astype(np.float32) for n in (5, 3))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    jpred = JaxPredictor(jax_load_config(PHASES[phase]), weights[phase][1], max_batch=8)
    got = _port(weights, phase).similarity(a, b)
    want = jpred.similarity(a, b)
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)
    temp = np.exp(2.1) if phase == "mum" else 1.0 / 0.07
    np.testing.assert_allclose(got, a @ b.T * temp, rtol=1e-5)


def test_string_endpoints_match_jax(weights):
    """encode_text, itm_score and nlvr2 on strings: the BERT tokenizer's ids,
    then the id endpoints, against JAX's `Predictor` on the same strings."""
    texts = ["a dog on a couch", "two red buses", "the left image shows a cat"]
    img0, img1, _, _ = _inputs(3, seed=2)
    mum, nlvr2 = _port(weights, "mum"), _port(weights, "nlvr2")
    jmum = JaxPredictor(jax_load_config(PHASES["mum"]), weights["mum"][1], max_batch=8)
    jnlvr2 = JaxPredictor(jax_load_config(PHASES["nlvr2"]), weights["nlvr2"][1], max_batch=8)
    np.testing.assert_array_equal(mum.tokenize(texts), jmum.tokenize(texts))
    np.testing.assert_allclose(mum.encode_text(texts), jmum.encode_text(texts), atol=ATOL)
    np.testing.assert_allclose(mum.encode_image(img0), jmum.encode_image(img0), atol=ATOL)
    np.testing.assert_allclose(mum.itm_score(img0, texts), jmum.itm_score(img0, texts),
                               atol=ATOL)
    np.testing.assert_allclose(nlvr2.nlvr2(img0, img1, texts),
                               jnlvr2.nlvr2(img0, img1, texts), atol=ATOL)


def test_endpoints_refuse_what_jax_refuses(weights):
    """Images other than uint8 arrays and unpaired inputs raise
    ValueError; NLVR2's weights carry a 3-row token-type table."""
    mum, nlvr2 = _port(weights, "mum"), _port(weights, "nlvr2")
    img0, img1, ids, mask = _inputs(3)
    with pytest.raises(ValueError, match="uint8"):
        mum.encode_image(img0.astype(np.float32))
    with pytest.raises(ValueError, match="paired"):
        mum.itm_score_ids(img0[:2], ids, mask)
    with pytest.raises(ValueError, match="paired"):
        nlvr2.nlvr2_ids(img0, img1[:2], ids, mask)
    with pytest.raises(ValueError, match="paired"):
        mum.encode_text_ids(ids, mask[:2])
    assert nlvr2.task.transformer.token_type_embeddings.weight.shape[0] == 3
    assert mum.task.transformer.token_type_embeddings.weight.shape[0] == 2


@pytest.mark.parametrize("n,ties", [(7, False), (16, False), (12, True)])
def test_recall_at_k_matches_jax(n, ties):
    """recall@{1,5,10} both ways and their mean, equal to JAX's, also with
    tied similarities (both rank with numpy's argsort)."""
    rng = np.random.default_rng(n)
    img = rng.normal(size=(n, 8)).astype(np.float32)
    txt = img + rng.normal(scale=1.0, size=(n, 8)).astype(np.float32)
    if ties:
        img = np.round(img)
        txt = np.round(txt)
    assert pretrieval.recall_at_k(img, txt) == jretrieval.recall_at_k(img, txt)


RETRIEVAL = ["model=vlmo_debug", f"model.img_size={IMG}", f"model.max_text_len={TEXT_LEN}",
             "compute_dtype=float32", "train=finetune_retrieval",
             "train.datasets=[synthetic]", "data.batch_size=4", "data.synthetic_size=10",
             "data.eval_batch_size=4"]


def test_evaluate_retrieval_matches_jax(monkeypatch):
    """`evaluate_retrieval` over the val split (10 samples in batches of 4,
    the last filled with the first two, as both loaders do): the encoded
    features within 1e-5 of JAX's `encode_split`, the recalls equal to JAX's
    `evaluate_retrieval` from the same weights (JAX's init of the retrieval
    task)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trainer = Trainer(load_config(RETRIEVAL), device="cpu")
    jcfg = jax_load_config(RETRIEVAL)
    jtask = jax_build_model(jcfg)
    batch = next(trainer.val_loader.epoch(0))
    mb = {k: v.numpy() for k, v in trainer.model_batch(batch).items()}
    params = _jitter(jax.jit(lambda key: jtask.init(
        {"params": key, "sample": jax.random.key(1)}, mb,
        method=JaxTask.init_streams))(jax.random.key(0))["params"])
    trainer.task.load_state_dict(from_flax_params(params), strict=True)
    loader = MultiTaskData(jcfg).val_loader()
    loader.num_workers = 1
    jtrainer = types.SimpleNamespace(task=jtask, feeder=lambda it: it)
    jstate = types.SimpleNamespace(params=params)
    want_i, want_t = jretrieval.encode_split(jtask, params, jtrainer.feeder, loader)
    got_i, got_t = pretrieval.encode_split(trainer.task, trainer.val_loader, trainer.device)
    assert got_i.shape == want_i.shape == (12, 256)
    np.testing.assert_allclose(got_i, want_i, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=ATOL)
    want = jretrieval.evaluate_retrieval(jtrainer, jstate, loader)
    assert pretrieval.evaluate_retrieval(trainer) == want
    assert set(want) == {f"{d}_recall@{k}" for d in ("i2t", "t2i") for k in (1, 5, 10)} \
        | {"recall_mean"}
