"""The PyTorch port's VQA serving slice against the JAX package, on the CPU.

The same seeded flax weights are converted with `from_flax_params` and the
same numpy inputs go through JAX's `_vqa_fn` and the port's
`Predictor.vqa_logits`, in fp32 at a small width (depth 2, width 96, image
32, text 10). The port runs its plain PyTorch versions here, because the
tensors lie on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.infer import Predictor as JaxPredictor
from exploremultimodal_tpu.infer import _next_bucket as jax_next_bucket
from exploremultimodal_tpu.infer import _pad_to as jax_pad_to
from exploremultimodal_tpu.infer import _vqa_fn
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.models.task import build_model as jax_build_model
from exploremultimodal_torch.config import load_config
from exploremultimodal_torch.infer import Predictor, _next_bucket, _pad_to
from exploremultimodal_torch.models import build_model
from exploremultimodal_torch.models.convert import from_flax_params
from exploremultimodal_torch.ops.flash_attention import flash_attention_fwd
from exploremultimodal_torch.ops.mlp_fused import fused_mlp_fwd
from exploremultimodal_torch.ops.preprocess import normalize_image

TEXT_LEN = 10
TINY = [
    "model=vlmo_debug",
    "train=finetune_vqa",
    "model.img_size=32",
    "model.max_text_len=10",
    "compute_dtype=float32",
]
IMPLS = [("pallas", "fused"), ("recompute", "xla")]


def _impl(attn, mlp):
    return [f"attn_impl={attn}", f"model.mlp_impl={mlp}"]


@pytest.fixture(scope="module")
def flax_params():
    """Random flax params with non-zero biases and LayerNorm affines, so the
    conversion of every leaf shows in the logits."""
    task = jax_build_model(jax_load_config(TINY + _impl("xla", "xla")))
    dummy = {
        "image": jnp.zeros((1, 32, 32, 3), jnp.float32),
        "text_ids": jnp.zeros((1, TEXT_LEN), jnp.int32),
        "text_mask": jnp.ones((1, TEXT_LEN), jnp.int32),
    }
    init = jax.jit(lambda key: task.init({"params": key}, dummy,
                                         method=JaxTask.init_inference))
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


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(1000, 30522, (n, TEXT_LEN)).astype(np.int32)
    mask = np.ones((n, TEXT_LEN), np.int32)
    for i in range(n):  # questions of different lengths, padded at the end
        length = int(rng.integers(3, TEXT_LEN + 1))
        ids[i, length:] = 0
        mask[i, length:] = 0
    return img, ids, mask


def test_from_flax_params_loads_strict(flax_params):
    cfg = load_config(TINY)
    sd = from_flax_params(flax_params)
    n_leaves = len(jax.tree_util.tree_leaves(flax_params))
    assert len(sd) == n_leaves
    # strict=True inside: every torch parameter gets exactly one flax leaf
    pred = Predictor(cfg, sd, device="cpu")
    got = pred.task.state_dict()
    blk = "transformer.blocks.0."
    np.testing.assert_array_equal(
        got[blk + "attn.qkv.weight"].numpy(),
        np.asarray(flax_params["transformer"]["blocks_0"]["attn"]["qkv"]["kernel"]).T)
    np.testing.assert_array_equal(
        got["transformer.patch_embed.weight"].numpy(),
        np.asarray(flax_params["transformer"]["patch_embed"]["kernel"])
        .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        got["transformer.txt_embeddings.LayerNorm.weight"].numpy(),
        np.asarray(flax_params["transformer"]["txt_embeddings"]["LayerNorm"]["scale"]))


@pytest.mark.parametrize("attn,mlp", IMPLS)
def test_vqa_logits_match_jax(flax_params, attn, mlp):
    """Whole slice in fp32. Tolerance 1e-4: the two frameworks sum in
    different orders over 2 blocks, a 3129-way head and LayerNorms whose
    statistics are computed the same way; observed differences are ~1e-6."""
    overrides = TINY + _impl(attn, mlp)
    img, ids, mask = _inputs(3)
    jtask = jax_build_model(jax_load_config(overrides))
    bucket = 4  # the port pads 3 rows to 4; JAX sees the same padded batch
    want = np.asarray(jtask.apply(
        {"params": flax_params}, *(jnp.asarray(_pad_to(a, bucket))
                                   for a in (img, ids, mask)),
        method=_vqa_fn))[:3]

    pred = Predictor(load_config(overrides), from_flax_params(flax_params),
                     max_batch=8, device="cpu")
    before = (flash_attention_fwd.launches, fused_mlp_fwd.launches)
    got = pred.vqa_logits(img, ids, mask)
    assert got.shape == (3, 3129) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (flash_attention_fwd.launches, fused_mlp_fwd.launches) == before


def _both_tasks(flax_params):
    overrides = TINY + _impl("pallas", "fused")
    jtask = jax_build_model(jax_load_config(overrides))
    port = Predictor(load_config(overrides), from_flax_params(flax_params),
                     device="cpu").task
    return jtask, port


@pytest.mark.parametrize("mode", ["img_only", "txt_only", "img-txt"])
def test_infer_features_match_jax(flax_params, mode):
    """`VlmoTask.infer` features and pooled CLS in each mode, fp32, against
    JAX's `infer`. Tolerance 1e-4, as for the logits."""
    jtask, port = _both_tasks(flax_params)
    img, ids, mask = _inputs(2, seed=4)
    batch = {"image": normalize_image(torch.from_numpy(img)).numpy(),
             "text_ids": ids, "text_mask": mask}
    want = jtask.apply({"params": flax_params},
                       {k: jnp.asarray(v) for k, v in batch.items()}, mode,
                       method=JaxTask.infer)
    got = port.infer({k: torch.from_numpy(v) for k, v in batch.items()},
                     infer_mode=mode)
    for key in ("co_feats", "cls_feats", "co_masks"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_stream_methods_match_jax(flax_params):
    """`stream_below_fusion`, `fuse_from_hidden` and `continue_single_stream`
    against the same JAX methods, fp32, tolerance 1e-4."""
    jtask, port = _both_tasks(flax_params)
    img, ids, mask = _inputs(2, seed=5)
    img_f = normalize_image(torch.from_numpy(img)).numpy()

    def jax_call(fn, *arrays):
        return jtask.apply({"params": flax_params}, *map(jnp.asarray, arrays),
                           method=lambda m, *xs: fn(m.transformer, *xs))

    t = port.transformer
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4)
    img_h = t.stream_below_fusion(img=torch.from_numpy(img_f))
    txt_h = t.stream_below_fusion(txt=torch.from_numpy(ids),
                                  txt_mask=torch.from_numpy(mask))
    close(img_h, jax_call(lambda m, x: m.stream_below_fusion(img=x), img_f))
    close(txt_h, jax_call(lambda m, x, k: m.stream_below_fusion(txt=x, txt_mask=k),
                          ids, mask))
    co, co_mask = t.fuse_from_hidden(img_h, txt_h, torch.from_numpy(mask))
    want_co, want_mask = jax_call(lambda m, a, b, k: m.fuse_from_hidden(a, b, k),
                                  img_h.numpy(), txt_h.numpy(), mask)
    close(co, want_co)
    close(co_mask, want_mask)
    close(t.continue_single_stream(txt_h, torch.from_numpy(mask), "l"),
          jax_call(lambda m, x, k: m.continue_single_stream(x, k, "l"),
                   txt_h.numpy(), mask))


def test_vqa_answers_match_jax(flax_params):
    """Tokenizer + logits + vqa_dict.json mapping, end to end."""
    overrides = TINY + _impl("pallas", "fused")
    questions = ["what color is the bus?", "how many dogs", "is it raining?"]
    img, _, _ = _inputs(3, seed=1)
    jpred = JaxPredictor(jax_load_config(overrides), flax_params, max_batch=8)
    pred = Predictor(load_config(overrides), from_flax_params(flax_params),
                     max_batch=8, device="cpu")
    ids, mask = pred.tokenize(questions)
    np.testing.assert_array_equal((ids, mask), jpred.tokenize(questions))
    assert pred.vqa(img, questions) == jpred.vqa(img, questions)


@pytest.mark.parametrize("n,max_batch", [(1, 8), (3, 8), (5, 8), (8, 8), (11, 8)])
def test_bucket_and_edge_padding_match_jax(n, max_batch):
    assert _next_bucket(n, max_batch) == jax_next_bucket(n, max_batch)
    x = np.arange(n * 6).reshape(n, 2, 3)
    b = _next_bucket(n, max_batch)
    np.testing.assert_array_equal(_pad_to(x, b), jax_pad_to(x, b))
    assert (_pad_to(x, b)[n:] == x[-1]).all()


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, flax_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(TINY)
    sd = from_flax_params(flax_params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(cfg, sd)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    assert Predictor(cfg, sd, device="cpu").device.type == "cpu"
    assert next(build_model(cfg, device="cpu").parameters()).device.type == "cpu"


def test_build_model_is_seeded():
    cfg = load_config(TINY)
    a, b = build_model(cfg, device="cpu", seed=5), build_model(cfg, device="cpu", seed=5)
    c = build_model(cfg, device="cpu", seed=6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["transformer.pos_embed"], sc["transformer.pos_embed"])
    # a seeded state_dict serves as well as a converted one
    img, ids, mask = _inputs(2)
    logits = Predictor(cfg, sa, device="cpu").vqa_logits(img, ids, mask)
    assert np.isfinite(logits).all()
