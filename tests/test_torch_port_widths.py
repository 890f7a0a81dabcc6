"""The port's MLP and W8A8 kernels at the presets' widths, against the JAX
package on the CPU.

Rows 6 and 7 (the bf16 fused MLP) at vlmo_tiny's and vlmo_small's widths
(K = N = 192 and 384, hidden 4x), row 8 (the W8A8 matmul) at the K and N
of every preset's qkv and proj and of their tensor shares (K from 192 to
1,024, N down to 576, a multiple of 64 but not of 128), rows 9 and 10 (the
W8A8 whole MLP) at vlmo_large's (K = N = 1,024, hidden 4,096, whole and
split over two shares of 2,048), one vlmo_large-wide model served under
`w8a8_pallas`, and `Predictor` over several devices under the int8 modes
(C12). Inputs are made with numpy and go through both packages as
numpy arrays, at M of 64-130 rows (not multiples of the kernels' tiles);
JAX's Pallas kernels run in interpret mode, as the JAX package's own tests
run them. The port's wrappers take their plain versions here, because the
tensors lie on the CPU; `chip_smoke.py` holds the CUDA kernels against the
same plain versions at these widths on the card.

Tolerances. Rows 6 and 7 in fp32 as `test_fused_mlp_plain_matches_jax_kernel`
(rtol 2e-5, atol 2e-6: the same tanh-gelu math summed in another order).
Row 8's codes, scales and outputs are exact on both sides, so they are
compared bit for bit. Rows 9 and 10: the codes and scales of x and of both
weights bit for bit; their outputs pass the hidden through tanh, which
XLA's CPU backend and PyTorch compute to different last bits, so a hidden
value on a rounding boundary can take the neighbouring int8 code: each
output within two int8 steps of h against the largest weight, and almost
every output exact to fp32 rounding, as `tests/test_torch_port_quant.py`
holds them at vlmo_debug's widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.infer import _vqa_fn
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.models.task import build_model as jax_build_model
from exploremultimodal_tpu.ops import quant_pallas as jqp
from exploremultimodal_tpu.ops.mlp_pallas import fused_bf16_mlp, fused_bf16_mlp_dropout
from exploremultimodal_torch.config import load_config
from exploremultimodal_torch.infer import Predictor
from exploremultimodal_torch.models.convert import from_flax_params
from exploremultimodal_torch.models.task import build_model
from exploremultimodal_torch.ops import mlp_fused as pmlp
from exploremultimodal_torch.ops import quant_fused as pqf
from tests.test_torch_port_quant import _hidden_max, _int8_step, _rows, _t, _weights
from tests.test_torch_port_vqa_train import (  # noqa: F401 (fixtures)
    LABELS,
    VQA_TINY,
    _as_port_bits,
    _bits,
    host_batch,
    model_batch,
)

KERNELS = (pmlp.fused_mlp_fwd, pmlp.fused_mlp_fwd_drop, pqf.w8a8_matmul,
           pqf.w8a8_mlp_fwd, pqf.w8a8_mlp_fwd_drop)


def _launches():
    return tuple(fn.launches for fn in KERNELS)


def _tc(a) -> torch.Tensor:
    """A contiguous fp32 tensor of `a` (a transpose in nn.Linear's layout)."""
    return _t(np.ascontiguousarray(a))


# ------------------------------------------------ rows 6 and 7: vlmo_tiny, vlmo_small


@pytest.mark.parametrize("width,m,threshold", [
    (192, 100, 0), (192, 130, 6554), (384, 130, 0), (384, 100, 6554)])
def test_rows_6_7_plain_match_jax_kernels_at_tiny_and_small(width, m, threshold):
    """`fused_mlp` (rows 6 and 7 plain on the CPU) against JAX's
    `fused_bf16_mlp` / `fused_bf16_mlp_dropout` (interpret mode) at K = N
    = `width`, hidden 4 `width`, fp32, with JAX's uint16 bits for the
    dropout; the shape check the card's kernel applies passes at these
    widths. No kernel launches on the CPU."""
    rng = np.random.default_rng(width + m)
    hdim = 4 * width
    x = rng.standard_normal((m, width)).astype(np.float32)
    w1 = (rng.standard_normal((width, hdim)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(hdim) * 0.01).astype(np.float32)
    w2 = (rng.standard_normal((hdim, width)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(width) * 0.01).astype(np.float32)
    bits = _bits((m, hdim), seed=width)
    ja = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    want = np.asarray(fused_bf16_mlp_dropout(*ja, jnp.asarray(bits), threshold, True)
                      if threshold else fused_bf16_mlp(*ja, True))
    tb = _as_port_bits(bits) if threshold else None
    args = (_t(x), _tc(w1.T), _t(b1), _tc(w2.T), _t(b2))
    before = _launches()
    got = pmlp.fused_mlp(*args, tb, threshold)
    assert _launches() == before
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)
    bf = [a.to(torch.bfloat16) if a.dim() == 2 else a for a in args]
    assert pmlp._sm90_shapes("t", *bf, tb) == (m, hdim, width)


# ------------------------------------------------ row 8: every preset's qkv and proj


@pytest.mark.parametrize("n", [576, 1024, 1536, 3072])
@pytest.mark.parametrize("k", [192, 256, 512, 1024])
def test_row8_plain_matches_jax_kernel_at_the_presets_widths(k, n):
    """`w8a8_matmul` (row 8 plain on the CPU) against JAX's
    `fused_w8a8_matmul` (`_fused_kernel` in interpret mode) at K from
    vlmo_base's proj share at T = 4 (192) to vlmo_large (1,024) and N from
    qkv's share at vlmo_base and T = 4 (576, a 64-column tail past the
    128-column tiles) to vlmo_large's qkv (3,072): the weight codes and
    scales, the rows' codes and scales and the outputs bit for bit; the
    card's shape check passes at each."""
    m = 97
    x = _rows((m, k), seed=k + n)
    w = _weights(k, n, seed=k * n)
    jqw, jsw = jqp.quantize_weights(jnp.asarray(w))
    qw, sw = pqf.quantize_weights(_tc(w.T))
    np.testing.assert_array_equal(qw.numpy(), np.asarray(jqw).T)
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw)[0])
    jq, js = jax.jit(jqp._row_quant)(jnp.asarray(x))
    pq, ps = pqf.row_quant(_t(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    want = jqp.fused_w8a8_matmul(jnp.asarray(x), jqw, jsw, interpret=True)
    before = _launches()
    got = pqf.w8a8_matmul(_t(x), qw, sw)
    assert _launches() == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pqf.matmul_width_ok(k, n)


# ------------------------------------------------ rows 9 and 10: vlmo_large

LARGE, LARGE_HIDDEN = 1024, 4096


def _large_mlp(seed: int, m: int):
    rng = np.random.default_rng(seed)
    return (_rows((m, LARGE), seed), _weights(LARGE, LARGE_HIDDEN, seed + 1),
            (rng.standard_normal(LARGE_HIDDEN) * 0.05).astype(np.float32),
            _weights(LARGE_HIDDEN, LARGE, seed + 2, scale=0.02),
            (rng.standard_normal(LARGE) * 0.05).astype(np.float32))


def _jax_mlp(arrays, bits, threshold):
    ja = [jnp.asarray(a) for a in arrays]
    if threshold:
        return np.asarray(jqp.fused_w8a8_mlp_dropout(*ja, jnp.asarray(bits), threshold, True))
    return np.asarray(jqp.fused_w8a8_mlp(*ja, True))


def _within_int8_steps(got, want, arrays, bits, threshold):
    x, w1, b1, w2, _ = arrays
    diff = np.abs(got - want)
    assert diff.max() <= _int8_step(_hidden_max(x, w1, b1, bits, threshold), w2), diff.max()
    assert (diff <= 1e-5 * (1 + np.abs(want))).mean() >= 0.95


@pytest.mark.parametrize("threshold", [0, 6554])
def test_rows_9_10_plain_match_jax_kernels_at_vlmo_large(threshold):
    """`w8a8_mlp` forward (rows 9 and 10 plain on the CPU) against JAX's
    `fused_w8a8_mlp` / `fused_w8a8_mlp_dropout` (interpret mode) at K = N
    = 1,024 and hidden 4,096, with JAX's uint16 bits at drop_rate 0.1: the
    weights' codes and scales bit for bit, the outputs within two int8
    steps of h (module docstring); the card's shape check passes."""
    m = 72
    arrays = _large_mlp(40 + threshold, m)
    x, w1, b1, w2, b2 = arrays
    bits = _bits((m, LARGE_HIDDEN), seed=5)
    for w in (w1, w2):
        jq, js = jqp.quantize_weights(jnp.asarray(w))
        pq, ps = pqf.quantize_weights(_tc(w.T))
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq).T)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js)[0])
    want = _jax_mlp(arrays, bits, threshold)
    before = _launches()
    got = pqf.w8a8_mlp(_t(x), _tc(w1.T), _t(b1), _tc(w2.T), _t(b2),
                       _as_port_bits(bits) if threshold else None, threshold)
    assert _launches() == before
    _within_int8_steps(got.numpy(), want, arrays, bits, threshold)
    qw1, sw1 = pqf.quantize_weights(_tc(w1.T))
    qw2, sw2 = pqf.quantize_weights(_tc(w2.T))
    xb = _t(x).to(torch.bfloat16)
    assert pqf._check_mlp("t", xb, qw1, sw1, _t(b1), qw2, sw2, _t(b2)) == (m, LARGE,
                                                                           LARGE_HIDDEN)


@pytest.mark.parametrize("threshold", [0, 6554])
def test_rows_9_10_split_at_vlmo_large_matches_the_whole_and_jax(threshold):
    """Rows 9 and 10's split mode (plain on the CPU) on two shares of 2,048
    hidden columns, as vlmo_large's MLP splits at a tensor axis of 2: each
    share's row absmax of h maxed over both, W2's channels quantized at
    their absmax over the whole hidden, the fp32 partial outputs summed
    with b2 against the port's whole plain call (fp32 rounding of the two
    partial sums, 1e-5 of |y|) and against JAX's whole kernel (two int8
    steps of h)."""
    m = 64
    arrays = _large_mlp(60 + threshold, m)
    x, w1, b1, w2, b2 = arrays
    bits = _bits((m, LARGE_HIDDEN), seed=6)
    tbits = _as_port_bits(bits) if threshold else None
    qw1, sw1 = pqf.quantize_weights(_tc(w1.T))
    w2t = _tc(w2.T)
    whole_amax = w2t.abs().amax(1)
    shares = [slice(0, LARGE_HIDDEN // 2), slice(LARGE_HIDDEN // 2, LARGE_HIDDEN)]
    xt = _t(x)
    extra = [(tbits[:, s], threshold) if threshold else () for s in shares]
    amax = torch.stack([pqf.w8a8_mlp_amax_plain(xt, qw1[s], sw1[s], _t(b1)[s], *e)
                        for s, e in zip(shares, extra)]).amax(0)
    parts = []
    for s, e in zip(shares, extra):
        qw2, sw2 = pqf.quantize_weights(w2t[:, s], whole_amax)
        parts.append(pqf.w8a8_mlp_partial_plain(xt, qw1[s], sw1[s], _t(b1)[s], qw2, sw2,
                                                amax, *e))
    split = (parts[0] + parts[1] + _t(b2)).numpy()
    whole = pqf.w8a8_mlp(xt, _tc(w1.T), _t(b1), w2t, _t(b2), tbits, threshold).numpy()
    np.testing.assert_allclose(split, whole, rtol=1e-5, atol=1e-5)
    _within_int8_steps(split, _jax_mlp(arrays, bits, threshold), arrays, bits, threshold)


# ------------------------------------------------ a vlmo_large-wide model under w8a8_pallas

# vlmo_large's width and heads at depth 2 (fusion layer 1), on vlmo_debug's
# image and text sizes; layer scale at 0.1 instead of 1e-5, so that both
# blocks' int8 calls move the logits
LARGE_VQA = [
    "model=vlmo_large", "model.depth=2", "model.fusion_layer=1", "model.init_values=0.1",
    "train=finetune_vqa", "model.img_size=64", "model.max_text_len=10",
    "compute_dtype=float32", f"data.vqav2_label_size={LABELS}", "attn_impl=pallas",
    "model.quantize=w8a8_pallas",
]


@pytest.fixture(scope="module")
def large_params(model_batch):
    task = jax_build_model(jax_load_config(LARGE_VQA))
    batch = {k: jnp.asarray(v) for k, v in model_batch.items()}
    init = jax.jit(lambda key: task.init({"params": key, "sample": jax.random.key(1)},
                                         batch, method=JaxTask.init_streams))
    params = jax.device_get(init(jax.random.key(0))["params"])
    rng = np.random.default_rng(3)

    def jitter(path, x):  # non-zero biases
        x = np.asarray(x, np.float32)
        if "bias" in jax.tree_util.keystr(path):
            return x + rng.normal(0.0, 0.02, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(jitter, params)


def test_vqa_logits_match_jax_at_vlmo_large_width_under_w8a8_pallas(large_params):
    """`Predictor.vqa_logits` at vlmo_large's width (1,024, 16 heads) and
    depth 2 under `w8a8_pallas` (row 8 on qkv and proj, row 9 on every FFN
    call) against JAX's `_vqa_fn` from the same weights (the port's Flax
    converter) and inputs, fp32. Tolerance 2e-3, as
    `test_vqa_logits_match_jax_under_int8`: a flipped code moves an FFN
    output by one int8 step before the blocks and the head."""
    rng = np.random.default_rng(0)
    n = 4
    img = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
    ids = rng.integers(1000, 30522, (n, 10)).astype(np.int32)
    for i in range(n):
        ids[i, int(rng.integers(3, 11)):] = 0
    mask = (ids != 0).astype(np.int32)
    jtask = jax_build_model(jax_load_config(LARGE_VQA))
    want = np.asarray(jax.jit(lambda p, *a: jtask.apply({"params": p}, *a, method=_vqa_fn))(
        large_params, *map(jnp.asarray, (img, ids, mask))))
    cfg = load_config(LARGE_VQA)
    assert (cfg["model"]["embed_dim"], cfg["model"]["num_heads"]) == (1024, 16)
    pred = Predictor(cfg, from_flax_params(large_params), device="cpu")
    before = _launches()
    got = pred.vqa_logits(img, ids, mask)
    assert _launches() == before
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert (got.argmax(-1) == want.argmax(-1)).all()


# ------------------------------------------------ C12: int8 serving over several devices


def test_predictor_refuses_w8a8_over_devices_and_splits_w8a8_pallas():
    """`Predictor(devices=[...])` under `model.quantize=w8a8` raises
    ValueError naming ROADMAP §A10: JAX's mesh takes `quant_dot`'s one
    absmax over the whole bucket, which replicas quantizing their own
    shards would not give. One device serves it. Under `w8a8_pallas` (a
    scale per row, so a shard's codes are the bucket's) and in bf16 several
    devices serve, and one bucket split over two devices gives one
    device's logits within 1e-5."""
    rng = np.random.default_rng(1)
    n = 6
    img = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
    ids = rng.integers(1000, 30522, (n, 10)).astype(np.int32)
    ids[:, 7:] = 0
    mask = (ids != 0).astype(np.int32)
    cfg = load_config(VQA_TINY + ["model.quantize=w8a8"])
    state = build_model(cfg, device="cpu", seed=0).state_dict()
    with pytest.raises(ValueError, match="§A10"):
        Predictor(cfg, state, device="cpu", devices=["cpu", "cpu"])
    Predictor(cfg, state, device="cpu", devices=["cpu"])
    Predictor(load_config(VQA_TINY), state, device="cpu", devices=["cpu", "cpu"])
    pallas = load_config(VQA_TINY + ["model.quantize=w8a8_pallas"])
    one = Predictor(pallas, state, device="cpu").vqa_logits(img, ids, mask)
    two = Predictor(pallas, state, devices=["cpu", "cpu"]).vqa_logits(img, ids, mask)
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-5)
