"""The default preset, vlmo_debug, on the port's kernels: rows 1-5 at its head
dim 32 and rows 6 and 7 at its width 96, against the JAX package on the CPU.

vlmo_debug (`configs/model/vlmo_debug.yaml`) is 96 wide with 3 heads, so
every attention call has head dim 32, and its MLP is 96 -> 384 -> 96, which
`fits_vmem` sends to the fused kernel. Inputs are made with numpy and go
through both packages as numpy arrays; JAX's Pallas kernels run in
interpret mode, as the JAX package's own tests run them on the CPU. The
port's wrappers take their plain versions here, because the tensors lie on
the CPU; `chip_smoke.py` (phase 31, `--debug`) holds the CUDA kernels
against the same plain versions at these shapes on the card.

Tolerances are those of the head-dim-64 tests: rows 1, 3 and 5 at 1e-5
(`tests/test_torch_port_ops.py`, `tests/test_torch_port_train_ops.py`,
`tests/test_torch_port_dvae.py`: the same fp32 products summed in another
order), rows 2 and 4 and the gradients at 1e-4 (sums of up to N products
of magnitude ~1), rows 6 and 7 at rtol 2e-5, atol 2e-6
(`tests/test_torch_port_widths.py`), serving logits at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.infer import Predictor as JaxPredictor
from exploremultimodal_tpu.infer import _vqa_fn
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.models.task import build_model as jax_build_model
from exploremultimodal_tpu.ops import flash_attention as jfa
from exploremultimodal_tpu.ops.attention import key_padding_bias as jax_key_padding_bias
from exploremultimodal_tpu.ops.mlp_pallas import fits_vmem as jax_fits_vmem
from exploremultimodal_tpu.ops.mlp_pallas import fused_bf16_mlp, fused_bf16_mlp_dropout
from exploremultimodal_torch.config import load_config
from exploremultimodal_torch.infer import Predictor
from exploremultimodal_torch.models.convert import from_flax_params
from exploremultimodal_torch.ops import flash_attention as pfa
from exploremultimodal_torch.ops import mlp_fused as pmlp
from exploremultimodal_torch.ops.attention import key_padding_bias

D = 32  # vlmo_debug: 96 wide, 3 heads
SCALE = D ** -0.5
RATE = 0.1  # vlmo_debug's attn_drop_rate
PATH_N = [40, 197, 237, 512]  # text, image, fused tokens; pretrain_txt's 512

KERNELS = (pfa.flash_attention_fwd, pfa.flash_attention_fwd_drop, pfa.flash_attention_bwd,
           pfa.flash_attention_bwd_drop, pfa.flash_attention_fwd_long, pmlp.fused_mlp_fwd,
           pmlp.fused_mlp_fwd_drop)


def _launches():
    return tuple(fn.launches for fn in KERNELS)


def _inputs(n, b=2, h=3, seed=0):
    """(B*H, N, 32) fp32 q, k, v, do and a (B, N) key mask whose last row
    pads its last third."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b * h, n, D)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, n), np.int32)
    mask[-1, n - n // 3:] = 0
    return q, k, v, do, mask


def _jax_padded(n, mask, *arrays):
    """The JAX kernels' layout: N padded to BLOCK_Q with zero rows and a
    -1e30 key bias, (B, 1, N_pad) fp32."""
    n_pad = jfa._round_up(n, jfa.BLOCK_Q)
    flat = [jnp.asarray(np.pad(a, [(0, 0), (0, n_pad - n), (0, 0)])) for a in arrays]
    bias = jax_key_padding_bias(jnp.asarray(mask)).reshape(mask.shape[0], 1, n)
    bias = jnp.pad(bias, [(0, 0), (0, 0), (0, n_pad - n)], constant_values=jfa.NEG_INF)
    return flat, bias


def _port_bias(mask):
    return key_padding_bias(torch.from_numpy(mask)).reshape(mask.shape).contiguous()


def test_vlmo_debug_is_the_default_and_its_head_dim_is_32():
    """Both packages' default model is vlmo_debug; its attention runs at
    head dim 32 with dropout live under `attn_impl: auto` (rows 3 and 4 on
    the card), and its MLP fits JAX's fused kernel (rows 6 and 7 under
    `mlp_impl=fused`). Both head dims and the width are the kernels'."""
    for cfg in (load_config([]), jax_load_config([])):
        m = cfg["model"]
        assert m["name"] == "vlmo_debug" and m["embed_dim"] // m["num_heads"] == D
        assert m["attn_drop_rate"] == RATE and cfg["attn_impl"] == "auto"
    k = load_config([])["model"]["embed_dim"]
    assert pmlp.fits_vmem(k, 4 * k, k) and jax_fits_vmem(k, 4 * k, k)
    assert D in pfa.HEAD_DIMS and k in pmlp.WIDTHS


# ------------------------------------------------------------- rows 1 and 3


@pytest.mark.parametrize("n", PATH_N)
@pytest.mark.parametrize("dropout", [False, True])
def test_rows_1_3_plain_match_jax_kernels(n, dropout):
    """Row 1 (`flash_attention_fwd`) against `_fwd_call`, row 3
    (`flash_attention_fwd_drop`) against `_fwd_drop_call`, both in
    interpret mode at head dim 32: out and lse, fp32. No kernel launches."""
    q, k, v, _, mask = _inputs(n, seed=n + dropout)
    (jq, jk, jv), jbias = _jax_padded(n, mask, q, k, v)
    seed = np.asarray([4321], np.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = _launches()
    if dropout:
        want, want_lse = jfa._fwd_drop_call(jnp.asarray(seed), jq, jk, jv, jbias, SCALE, RATE)
        got, got_lse = pfa.flash_attention_fwd_drop(tq, tk, tv, _port_bias(mask),
                                                    torch.from_numpy(seed), SCALE, RATE)
    else:
        want, want_lse = jfa._fwd_call(jq, jk, jv, jbias, SCALE)
        got, got_lse = pfa.flash_attention_fwd(tq, tk, tv, _port_bias(mask), SCALE)
    assert _launches() == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :n], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[:, :n, 0],
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- rows 2 and 4


@pytest.mark.parametrize("n", PATH_N)
@pytest.mark.parametrize("dropout", [False, True])
def test_rows_2_4_plain_match_jax_kernels(n, dropout):
    """Row 2 (`flash_attention_bwd`) against `_bwd_call` and row 4
    (`flash_attention_bwd_drop`) against `_bwd_drop_call` (interpret mode)
    at head dim 32, on JAX's forward output and lse and the same upstream
    gradient; fp32."""
    q, k, v, do, mask = _inputs(n, seed=10 + n + dropout)
    (jq, jk, jv, jdo), jbias = _jax_padded(n, mask, q, k, v, do)
    seed = np.asarray([99], np.int32)
    if dropout:
        jo, jlse = jfa._fwd_drop_call(jnp.asarray(seed), jq, jk, jv, jbias, SCALE, RATE)
        want = jfa._bwd_drop_call(jnp.asarray(seed), jq, jk, jv, jbias, jo, jdo, jlse, SCALE,
                                  RATE)
    else:
        jo, jlse = jfa._fwd_call(jq, jk, jv, jbias, SCALE)
        want = jfa._bwd_call(jq, jk, jv, jbias, jo, jdo, jlse, SCALE)
    o = torch.from_numpy(np.asarray(jo)[:, :n].copy())
    lse = torch.from_numpy(np.asarray(jlse)[:, :n, 0].copy())
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    before = _launches()
    if dropout:
        got = pfa.flash_attention_bwd_drop(tq, tk, tv, _port_bias(mask), torch.from_numpy(seed),
                                           o, tdo, lse, SCALE, RATE)
    else:
        got = pfa.flash_attention_bwd(tq, tk, tv, _port_bias(mask), o, tdo, lse, SCALE)
    assert _launches() == before
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :n], rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("n", PATH_N)
def test_rows_3_4_grads_match_jax_vjp(n):
    """`flash_attention` with vlmo_debug's attention dropout (rows 3 and 4
    under autograd) against `jax.vjp` of JAX's `flash_attention` at (B, 3,
    N, 32) with the same seed and cotangent: the output and dq, dk, dv."""
    b, h = 2, 3
    q, k, v, do, mask = _inputs(n, b=b, h=h, seed=20 + n)
    q, k, v, do = (a.reshape(b, h, n, D) for a in (q, k, v, do))
    seed = np.asarray([77], np.int32)
    jbias = jax_key_padding_bias(jnp.asarray(mask))
    want_out, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(
        q_, k_, v_, bias=jbias, scale=SCALE, dropout_rate=RATE,
        dropout_seed=jnp.asarray(seed)), *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = pfa.flash_attention(*leaves, bias=key_padding_bias(torch.from_numpy(mask)),
                              scale=SCALE, dropout_rate=RATE,
                              dropout_seed=torch.from_numpy(seed))
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=1e-4,
                               atol=1e-4)
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


# ------------------------------------------------------------------- row 5


def test_row5_plain_matches_jax_kernel(monkeypatch):
    """With FULL_ROW_FWD_MAX = 512 in both packages, N = 600 (padded 640)
    takes the long forward: the port's row 5 (its plain version) against
    JAX's `_attn_long_kernel` (interpret mode) at vlmo_debug's 3 heads of
    32, padded keys in one row; each package's long forward runs once."""
    monkeypatch.setattr(jfa, "FULL_ROW_FWD_MAX", 512)
    monkeypatch.setattr(pfa, "FULL_ROW_FWD_MAX", 512)
    seen = []
    for module, name in ((jfa, "_long_fwd_call"), (pfa, "flash_attention_fwd_long")):
        orig = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _o=orig, _n=name, **kw: seen.append(_n) or _o(*a, **kw))
    n, b, h = 600, 2, 3
    q, k, v, _, mask = _inputs(n, b=b, h=h, seed=5)
    q, k, v = (a.reshape(b, h, n, D) for a in (q, k, v))
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)),
                               bias=jax_key_padding_bias(jnp.asarray(mask)), scale=SCALE)
    got = pfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              bias=key_padding_bias(torch.from_numpy(mask)), scale=SCALE)
    assert seen == ["_long_fwd_call", "flash_attention_fwd_long"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- rows 6 and 7


def _bits(shape, seed):
    return np.random.default_rng(seed).integers(0, 65536, shape).astype(np.uint16)


@pytest.mark.parametrize("m,threshold", [(100, 0), (130, 6554), (64, 32768)])
def test_rows_6_7_plain_match_jax_kernels_at_96(m, threshold):
    """`fused_mlp` (rows 6 and 7 plain on the CPU) against JAX's
    `fused_bf16_mlp` / `fused_bf16_mlp_dropout` (interpret mode) at K = N =
    96, hidden 384, fp32, with JAX's uint16 bits (stored as the int16 u -
    32768) for the dropout; the card's shape check passes. No launches."""
    rng = np.random.default_rng(m + threshold)
    k, hdim = 96, 384
    x = rng.standard_normal((m, k)).astype(np.float32)
    w1 = (rng.standard_normal((k, hdim)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(hdim) * 0.01).astype(np.float32)
    w2 = (rng.standard_normal((hdim, k)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(k) * 0.01).astype(np.float32)
    bits = _bits((m, hdim), seed=m)
    ja = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    want = np.asarray(fused_bf16_mlp_dropout(*ja, jnp.asarray(bits), threshold, True)
                      if threshold else fused_bf16_mlp(*ja, True))
    tb = (torch.from_numpy((bits.astype(np.int32) - 32768).astype(np.int16))
          if threshold else None)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w1.T, b1, w2.T, b2)]
    before = _launches()
    got = pmlp.fused_mlp(*args, tb, threshold)
    assert _launches() == before
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)
    bf = [a.to(torch.bfloat16) if a.dim() == 2 else a for a in args]
    assert pmlp._sm90_shapes("t", *bf, tb) == (m, hdim, k)


# ------------------------------------------------------------- refusals


def _meta_attn(d: int, n: int = 197, bh: int = 6, b: int = 2):
    q, k, v = (torch.empty(bh, n, d, dtype=torch.bfloat16, device="meta") for _ in range(3))
    return torch.empty(b, n, device="meta"), q, k, v


@pytest.mark.parametrize("d", [16, 128])
def test_rows_1_5_refuse_head_dims_no_preset_has(d):
    """Off the CPU (meta tensors here, CUDA ones on the card) the wrappers
    raise ValueError naming the head dims they take; nothing falls back to
    the plain chain, and no launch is counted."""
    kb, q, k, v = _meta_attn(d)
    seed = torch.empty(1, dtype=torch.int32, device="meta")
    lse = torch.empty(6, 197, device="meta")
    before = _launches()
    calls = [lambda: pfa.flash_attention_fwd(q, k, v, kb, 0.1),
             lambda: pfa.flash_attention_fwd_drop(q, k, v, kb, seed, 0.1, RATE),
             lambda: pfa.flash_attention_bwd(q, k, v, kb, q, q, lse, 0.1),
             lambda: pfa.flash_attention_bwd_drop(q, k, v, kb, seed, q, q, lse, 0.1, RATE),
             lambda: pfa.flash_attention_fwd_long(q, k, v, kb, 0.1)]
    for call in calls:
        with pytest.raises(ValueError, match=r"head dims \(32, 64\)"):
            call()
    assert _launches() == before


@pytest.mark.parametrize("width", [112, 160])
def test_rows_6_7_refuse_widths_no_preset_has(width):
    """K = N = 112 or 160 (hidden 4x) raise ValueError off the CPU, with and
    without the dropout bits; the presets' 96 passes the same check."""
    def args(w):
        x = torch.empty(64, w, dtype=torch.bfloat16, device="meta")
        w1 = torch.empty(4 * w, w, dtype=torch.bfloat16, device="meta")
        w2 = torch.empty(w, 4 * w, dtype=torch.bfloat16, device="meta")
        b1, b2 = (torch.empty(n, device="meta") for n in (4 * w, w))
        return x, w1, b1, w2, b2

    bits = torch.empty(64, 4 * width, dtype=torch.int16, device="meta")
    before = _launches()
    with pytest.raises(ValueError, match="N in"):
        pmlp.fused_mlp_fwd(*args(width))
    with pytest.raises(ValueError, match="N in"):
        pmlp.fused_mlp_fwd_drop(*args(width), bits, 6554)
    assert _launches() == before
    assert pmlp._sm90_shapes("t", *args(96)) == (64, 384, 96)


# ---------------------------------------------------- the slice as a whole

SERVE_TINY = [
    "model=vlmo_debug", "train=finetune_vqa", "model.img_size=64", "model.max_text_len=12",
    "compute_dtype=float32", "attn_impl=pallas", "model.mlp_impl=fused",
]


def _random_tree(shapes, seed: int):
    """Seeded numpy leaves for a flax shape tree: kernels normal with
    variance 1 / fan_in, LayerNorm scales near 1, the rest small normals."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return rng.normal(0.0, int(np.prod(s.shape[:-1])) ** -0.5, s.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + rng.normal(0.0, 0.1, s.shape)).astype(np.float32)
        return rng.normal(0.0, 0.05, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_vqa_serving_matches_jax_through_rows_1_and_6(monkeypatch):
    """`Predictor.vqa_logits` at vlmo_debug under attn_impl=pallas and
    mlp_impl=fused (the card's serving route: row 1 on every attention
    call, row 6 on every FFN call, at head dim 32 and width 96) against
    JAX's `Predictor` on the same weights, at image 64 (17 image and 29
    fused tokens) and a padded text of 12: the three streams' wrappers each
    called once per layer they cover (2 text + image calls below the fusion
    layer, 1 fused above), fp32 logits within 1e-4."""
    calls = []
    for name in ("flash_attention_fwd", "fused_mlp_fwd"):
        module = pfa if name.startswith("flash") else pmlp
        orig = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _o=orig, _n=name, **kw: calls.append(_n) or _o(*a, **kw))
    task = jax_build_model(jax_load_config(SERVE_TINY))
    dummy = {"image": jnp.zeros((1, 64, 64, 3)), "text_ids": jnp.zeros((1, 12), jnp.int32),
             "text_mask": jnp.ones((1, 12), jnp.int32)}
    shapes = jax.eval_shape(lambda key: task.init(
        {"params": key}, dummy, method=JaxTask.init_inference), jax.random.key(0))["params"]
    params = _random_tree(shapes, seed=80)
    rng = np.random.default_rng(81)
    img = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    ids = rng.integers(1000, 30522, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    ids[1, 8:], mask[1, 8:] = 0, 0
    want = JaxPredictor(jax_load_config(SERVE_TINY), params, max_batch=2)._run(
        "vqa", _vqa_fn, 2, img, ids, mask)
    got = Predictor(load_config(SERVE_TINY), from_flax_params(params), max_batch=2,
                    device="cpu").vqa_logits(img, ids, mask)
    assert calls.count("flash_attention_fwd") == calls.count("fused_mlp_fwd") == 3
    assert got.shape == want.shape == (2, 3129)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
