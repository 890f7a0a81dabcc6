"""The PyTorch port's int8 (W8A8) slice against the JAX package, on the CPU.

`ops/quant.py` (`quant_dot`, `QuantLinear`, `dense`, `site_mode`) and
`ops/quant_fused.py` (the W8A8 matmul, row 8; the W8A8 whole MLP with and
without hidden dropout, rows 9 and 10; their straight-through (STE)
backwards), the int8 routes of the backbone, VQA serving and one
finetune_vqa step under int8 modes (the int8 dVAE is in
`tests/test_torch_port_dvae.py`). Inputs are made with numpy and go through
both packages as numpy arrays; JAX's Pallas kernels run in interpret mode,
as `tests/test_quant.py` runs them. The port's wrappers take their plain
versions here because the tensors lie on the CPU; `chip_smoke.py` holds the
CUDA kernels against the same plain versions on the card.

Tolerances. The quantization itself (codes and scales) and every int32 sum
are exact on both sides, so row 8 is compared exactly. Rows 9 and 10 pass
the hidden through tanh, which XLA's CPU backend and PyTorch compute to
different last bits; a hidden value on a rounding boundary can then take the
neighbouring int8 code, which moves an output by one int8 step of h against
one weight: at most max|h| / 127 * max|w2| per flipped code.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.infer import _vqa_fn
from exploremultimodal_tpu.models.task import build_model as jax_build_model
from exploremultimodal_tpu.models.task import total_loss as jax_total_loss
from exploremultimodal_tpu.models.vlmo import Mlp as JaxMlp
from exploremultimodal_tpu.ops import quant as jquant
from exploremultimodal_tpu.ops import quant_pallas as jqp
from exploremultimodal_torch.config import QUANTIZE_MODES, VlmoConfig, load_config
from exploremultimodal_torch.infer import Predictor
from exploremultimodal_torch.models import vlmo as pvlmo
from exploremultimodal_torch.models.convert import from_flax_params
from exploremultimodal_torch.models.task import VlmoTask, total_loss
from exploremultimodal_torch.ops import mlp_fused as pmlp
from exploremultimodal_torch.ops import quant as pquant
from exploremultimodal_torch.ops import quant_fused as pqf
from exploremultimodal_torch.ops import stochastic as pst
from tests.test_torch_port_vqa_train import (  # noqa: F401 (fixtures)
    VQA_TINY as TINY,
    _as_port_bits,
    _bits,
    _replay_bits,
    flax_params,
    host_batch,
    model_batch,
)

KERNELS = (pqf.w8a8_matmul, pqf.w8a8_mlp_fwd, pqf.w8a8_mlp_fwd_drop)


def _launches():
    return tuple(fn.launches for fn in KERNELS)


def _rows(shape, seed):
    """Rows of very different magnitudes, so per-row scales matter."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x * np.linspace(0.05, 4.0, shape[-2], dtype=np.float32)[:, None]


def _weights(kdim, ndim, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((kdim, ndim)) * scale
    return (w * rng.uniform(0.2, 2.0, ndim)).astype(np.float32)  # JAX's (K, N)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _int8_step(h_max: float, w2: np.ndarray, codes: int = 2) -> float:
    """`codes` flipped int8 codes of h against the largest weight."""
    return codes * h_max / 127.0 * float(np.abs(w2).max())


# --------------------------------------------------------------- quantization


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codes_and_scales_match_jax_exactly(dtype):
    """`quantize_weights` (per output channel), `_quantize_int8` (per tensor
    and per channel) and the kernels' `row_quant` give JAX's int8 codes and
    fp32 scales bit for bit, from fp32 and from bf16 tensors; a zero channel
    takes the 1e-8 floor."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    w = _weights(48, 40, seed=1)
    w[:, 7] = 0.0
    x = _rows((24, 48), seed=2)
    jw, jx = jnp.asarray(w, jdt), jnp.asarray(x, jdt)
    tw, tx = _t(w).to(tdt), _t(x).to(tdt)

    jq, js = jqp.quantize_weights(jw)
    pq, ps = pqf.quantize_weights(tw.T.contiguous())
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js)[0])
    assert ps[7] == np.float32(1e-8) / np.float32(127.0)

    for jargs, targs in (((jx,), (tx,)), ((jw, 0), (tw.T.contiguous(), 1))):
        jq, js = jquant._quantize_int8(*jargs)
        pq, ps = pquant._quantize_int8(*targs)
        transpose = len(jargs) == 2
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq).T if transpose else jq)
        np.testing.assert_array_equal(ps.numpy().reshape(-1), np.asarray(js).reshape(-1))

    jq, js = jax.jit(jqp._row_quant)(jx.astype(jnp.float32))  # a primitive needing jit
    pq, ps = pqf.row_quant(tx.float())
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row8_plain_matches_jax_kernel_exactly(dtype):
    """`w8a8_matmul` (its plain version on the CPU) against JAX's
    `fused_w8a8_matmul` (`_fused_kernel` in interpret mode) on JAX's weight
    codes: the same codes, exact int32 sums and the same two fp32 products,
    so the outputs are equal. No kernel launches on the CPU."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = _rows((60, 64), seed=3)
    qw, sw = jqp.quantize_weights(jnp.asarray(_weights(64, 48, seed=4)))
    want = jqp.fused_w8a8_matmul(jnp.asarray(x, jdt), qw, sw, interpret=True)
    before = _launches()
    got = pqf.w8a8_matmul(_t(x).to(tdt), torch.from_numpy(np.asarray(qw).T.copy()),
                          torch.from_numpy(np.asarray(sw)[0].copy()))
    assert _launches() == before and got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _mlp_arrays(seed, lead=(64,), kdim=64, hdim=256):
    rng = np.random.default_rng(seed)
    return (_rows((*lead, kdim), seed),
            _weights(kdim, hdim, seed + 1),
            (rng.standard_normal(hdim) * 0.05).astype(np.float32),
            _weights(hdim, kdim, seed + 2),
            (rng.standard_normal(kdim) * 0.05).astype(np.float32))


def _hidden_max(x, w1, b1, bits, threshold):
    """max |h| of the unquantized hidden (erf gelu, dropout), with 5% room."""
    h = x.astype(np.float64) @ w1 + b1
    h = 0.5 * h * (1.0 + np.tanh(0.7978845608028654 * (h + 0.044715 * h ** 3)))
    if threshold:
        h = np.where(bits >= threshold, h * 65536.0 / (65536 - threshold), 0.0)
    return 1.05 * float(np.abs(h).max())


@pytest.mark.parametrize("threshold", [0, 6554, 32768])
def test_rows_9_10_plain_match_jax_kernels(threshold):
    """`w8a8_mlp` forward (rows 9/10 plain on the CPU) against JAX's
    `fused_w8a8_mlp` / `fused_w8a8_mlp_dropout` (interpret mode) with JAX's
    own uint16 bits, at thresholds 0.1 and 0.5. fp32 out; tolerance two
    int8 steps of h (module docstring), and almost every output exact to
    fp32 rounding (1e-5)."""
    x, w1, b1, w2, b2 = _mlp_arrays(seed=10 + threshold)
    bits = _bits((64, 256), seed=threshold)
    ja = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    if threshold:
        want = jqp.fused_w8a8_mlp_dropout(*ja, jnp.asarray(bits), threshold, True)
    else:
        want = jqp.fused_w8a8_mlp(*ja, True)
    before = _launches()
    got = pqf.w8a8_mlp(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2),
                       _as_port_bits(bits) if threshold else None, threshold)
    assert _launches() == before
    want = np.asarray(want)
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= _int8_step(_hidden_max(x, w1, b1, bits, threshold), w2), diff.max()
    assert (diff <= 1e-5 * (1 + np.abs(want))).mean() >= 0.95


# -------------------------------------------------------- straight-through


def test_quant_dot_matches_jax_forward_and_grads():
    """`quant_dot` (w8a8: one scale for all of x, per-channel weights)
    against JAX's: the forward exactly (the same codes and int32 sums), the
    STE gradients within fp32 rounding (rtol 1e-6, as JAX's own test)."""
    x = _rows((4, 7, 24), seed=20)
    w = _weights(24, 16, seed=21)
    g = np.random.default_rng(22).standard_normal((4, 7, 16)).astype(np.float32)
    want, vjp = jax.vjp(jquant.quant_dot, jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w.T).requires_grad_()
    y = pquant.quant_dot(tx, tw)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    y.backward(_t(g))
    dx, dw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(dw), rtol=1e-6, atol=1e-6)


def test_pallas_quant_dot_matches_jax_forward_and_grads():
    """`pallas_quant_dot` (row 8 with `_pqd_bwd`) against JAX's in interpret
    mode, with leading batch dims: the forward exactly, the STE gradients
    within fp32 rounding of their sums (rtol 1e-5)."""
    x = _rows((2, 20, 64), seed=23)
    w = _weights(64, 48, seed=24)
    g = np.random.default_rng(25).standard_normal((2, 20, 48)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: jqp.pallas_quant_dot(a, b, True),
                        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w.T).requires_grad_()
    y = pqf.pallas_quant_dot(tx, tw)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    y.backward(_t(g))
    dx, dw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(dw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("threshold", [0, 6554])
def test_w8a8_mlp_grads_match_jax_erf_vjp(threshold):
    """`w8a8_mlp`'s STE backward against `jax.vjp` of `fused_w8a8_mlp` /
    `fused_w8a8_mlp_dropout` with the same bits and cotangent: the *erf*
    gelu's VJP, which the port takes although its forward is tanh (the tanh
    VJP would differ beyond the tolerance, checked too). fp32; rtol 1e-4,
    atol 1e-5, as `tests/test_quant.py`."""
    x, w1, b1, w2, b2 = _mlp_arrays(seed=30 + threshold, lead=(2, 16))
    bits = _bits((2, 16, 256), seed=31)
    g = np.random.default_rng(32).standard_normal((2, 16, 64)).astype(np.float32)
    if threshold:
        fn = lambda *a: jqp.fused_w8a8_mlp_dropout(*a, jnp.asarray(bits), threshold, True)  # noqa: E731
    else:
        fn = lambda *a: jqp.fused_w8a8_mlp(*a, True)  # noqa: E731
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (x, w1, b1, w2, b2)))
    want = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_() for t in (_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2))]
    pbits = _as_port_bits(bits) if threshold else None
    pqf.w8a8_mlp(*leaves, pbits, threshold).backward(_t(g))
    for name, leaf, w in zip("x w1 b1 w2 b2".split(), leaves, want):
        got = leaf.grad.numpy().T if name in ("w1", "w2") else leaf.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)
    tanh = pmlp.mlp_backward(_t(g).reshape(32, 64), _t(x).reshape(32, 64), _t(w1.T), _t(b1),
                             _t(w2.T), pbits.reshape(32, 256) if threshold else None,
                             threshold, torch.float32, approximate="tanh")
    assert np.abs(tanh[1].numpy().T - np.asarray(want[1])).max() > 1e-4


# -------------------------------------------------------- modes and layers


@pytest.mark.parametrize("mode", QUANTIZE_MODES)
def test_site_mode_and_dense_dispatch_as_jax(mode):
    """Every mode resolves each call site as JAX's `site_mode`, and `dense`
    builds the counterpart of JAX's layer for it (`Linear` for nn.Dense,
    `QuantLinear` with the same impl for `QuantDense`) with nn.Linear's
    parameters; the int8 whole-MLP mode is the Mlp's own branch."""
    for site in ("qkv", "proj", "mlp"):
        resolved = pquant.site_mode(mode, site)
        assert resolved == jquant.site_mode(mode, site)
        layer, jlayer = pquant.dense(resolved, 8, 4), jquant.dense(resolved, 4)
        if isinstance(jlayer, nn.Dense):
            assert type(layer) is pquant.Linear
        else:
            assert isinstance(layer, pquant.QuantLinear) and layer.impl == jlayer.impl
        assert [n for n, _ in layer.named_parameters()] == ["weight", "bias"]


def test_unknown_quantize_mode_is_rejected():
    """An unknown `model.quantize` raises ValueError, as JAX's `dense` does;
    `model.quantize=none` on the command line is 'none'."""
    with pytest.raises(ValueError, match="quantize"):
        jquant.dense("int4", 4)
    with pytest.raises(ValueError, match="quantize"):
        pquant.dense("int4", 8, 4)
    with pytest.raises(ValueError, match="quantize"):
        VlmoConfig.from_config(load_config(TINY + ["model.quantize=int4"]))
    assert VlmoConfig.from_config(load_config(TINY + ["model.quantize=none"])).quantize == "none"


def test_int8_mlp_quantizes_fp32_weights_at_bf16():
    """At compute dtype bf16 JAX's int8 MLP quantizes its fp32 parameters
    (`DenseParams`), so the port's int8 `Mlp` keeps fc1/fc2 fp32 while the
    bf16 one stores them in bf16. Its output matches JAX's `Mlp` at
    `dtype=bfloat16` within one bf16 ulp of |y| (2**-7 relative) plus two
    int8 steps of h; codes of the bf16-rounded weights would differ."""
    x, w1, b1, w2, b2 = _mlp_arrays(seed=40, lead=(2, 24))
    jmlp = JaxMlp(hidden_dim=256, out_dim=64, dtype=jnp.bfloat16,
                  quantize="w8a8_pallas_mlp")
    params = {"fc1": {"kernel": jnp.asarray(w1), "bias": jnp.asarray(b1)},
              "fc2": {"kernel": jnp.asarray(w2), "bias": jnp.asarray(b2)}}
    want = np.asarray(jmlp.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32))

    mlp = pvlmo.Mlp(64, 256, torch.bfloat16, "fused", 0.0, "w8a8_pallas_mlp")
    assert mlp.int8 and mlp.fc1.weight.dtype == mlp.fc2.weight.dtype == torch.float32
    assert pvlmo.Mlp(64, 256, torch.bfloat16, "fused").fc1.weight.dtype == torch.bfloat16
    with torch.no_grad():
        for lin, w, b in ((mlp.fc1, w1, b1), (mlp.fc2, w2, b2)):
            lin.weight.copy_(_t(w.T))
            lin.bias.copy_(_t(b))
    with torch.no_grad():
        got = mlp(_t(x)).float().numpy()
    tol = 2 ** -7 * np.abs(want) + _int8_step(_hidden_max(x, w1, b1, None, 0), w2)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    q32, _ = pqf.quantize_weights(_t(w1.T))
    q16, _ = pqf.quantize_weights(_t(w1.T).to(torch.bfloat16))
    assert not torch.equal(q32, q16)


# ------------------------------------------------------------- the slice


@pytest.mark.parametrize("mode", QUANTIZE_MODES)
def test_flax_params_load_strict_under_every_mode(flax_params, mode):
    """`from_flax_params` needs no change for int8: every mode's task loads
    the same tree with strict=True, at bf16 too; the int8 MLP's weights
    stay fp32."""
    cfg = load_config(TINY + [f"model.quantize={mode}", "compute_dtype=bfloat16"])
    task = VlmoTask(VlmoConfig.from_config(cfg))
    task.load_state_dict(from_flax_params(flax_params), strict=True)
    blk = task.transformer.blocks[0]
    int8_mlp = pquant.site_mode(mode, "mlp") == "w8a8_pallas"
    assert blk.mlp_v.int8 == int8_mlp
    assert blk.mlp_v.fc1.weight.dtype == (torch.float32 if int8_mlp else torch.bfloat16)
    assert blk.attn.qkv.weight.dtype == torch.bfloat16


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
    ids = rng.integers(1000, 30522, (n, 10)).astype(np.int32)
    mask = np.ones((n, 10), np.int32)
    for i in range(n):
        ids[i, int(rng.integers(3, 11)):] = 0
    mask[ids == 0] = 0
    return img, ids, mask


@pytest.mark.parametrize("mode", ["w8a8_pallas", "w8a8_pallas_mlp"])
def test_vqa_logits_match_jax_under_int8(flax_params, mode):
    """`Predictor.vqa_logits` under the int8 serving modes against JAX's
    `_vqa_fn` from the same weights and inputs, fp32. Tolerance 2e-3 on
    logits of magnitude ~1: a flipped code in one of the 4 int8 MLP calls
    (and 4 row-8 qkv/proj calls) moves an FFN output by one int8 step
    (~1e-3 at these widths) before the 2 blocks and the head."""
    overrides = TINY + ["attn_impl=pallas", "model.mlp_impl=fused",
                        f"model.quantize={mode}"]
    img, ids, mask = _inputs(4)
    jtask = jax_build_model(jax_load_config(overrides))
    want = np.asarray(jax.jit(lambda p, *a: jtask.apply({"params": p}, *a, method=_vqa_fn))(
        flax_params, *map(jnp.asarray, (img, ids, mask))))
    pred = Predictor(load_config(overrides), from_flax_params(flax_params), device="cpu")
    before = _launches()
    got = pred.vqa_logits(img, ids, mask)
    assert _launches() == before
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def _draw_bits(monkeypatch):
    """JAX's `jax.random.bits` becomes seeded numpy draws, recorded in call
    order, so that the step can be jitted and the port replay them."""
    drawn = []
    rng = np.random.default_rng(7)

    def draw(key, shape=(), dtype=jnp.uint32):
        assert dtype == jnp.uint16
        drawn.append(rng.integers(0, 65536, shape).astype(np.uint16))
        return jnp.asarray(drawn[-1])

    monkeypatch.setattr(jax.random, "bits", draw)
    return drawn


def test_finetune_vqa_step_under_w8a8_pallas_matches_jax(monkeypatch, flax_params,
                                                         model_batch):
    """One finetune_vqa forward and backward under `w8a8_pallas` (row 8 on
    qkv and proj, row 10 on every FFN call, their STE backwards) with the
    hidden dropout live on the uint16 bits JAX's dropouts take, replayed
    into the port in JAX's order (attention dropout and DropPath at 0, so
    nothing else is random). fp32: the loss within rtol 1e-4 and every gradient within
    1e-3 of its largest magnitude plus 2e-5 (a flipped code moves the
    cotangent the backward sees)."""
    overrides = TINY + ["model.quantize=w8a8_pallas", "model.attn_drop_rate=0.0",
                        "model.drop_path_rate=0.0", "model.mlp_impl=fused"]
    jtask = jax_build_model(jax_load_config(overrides))
    jbatch = {k: jnp.asarray(v) for k, v in model_batch.items()}
    drawn = _draw_bits(monkeypatch)

    def loss_fn(p):
        out = jtask.apply({"params": p}, jbatch, deterministic=False,
                          rngs={"dropout": jax.random.key(5), "droppath": jax.random.key(6)})
        return jax_total_loss(out), out

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(flax_params)
    # the int8 MLP's hidden bits: image and text below the fusion layer, fused above
    assert len([d for d in drawn if d.shape[-1] == 384]) == 3

    task = VlmoTask(VlmoConfig.from_config(load_config(overrides)))
    task.load_state_dict(from_flax_params(flax_params), strict=True)
    _replay_bits(monkeypatch, drawn)
    rng = pst.StepRng(torch.Generator(), torch.Generator(), torch.device("cpu"))
    before = _launches()
    out = task({k: torch.from_numpy(v) for k, v in model_batch.items()}, rng=rng)
    loss = total_loss(out)
    loss.backward()
    assert _launches() == before
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    want = from_flax_params(jgrads)
    reached = 0
    for name, p in task.named_parameters():
        w = want[name].numpy()
        if p.grad is None:
            assert not w.any(), name
            continue
        reached += 1
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=2e-5 + 1e-3 * np.abs(w).max(), err_msg=name)
    assert reached > 0
