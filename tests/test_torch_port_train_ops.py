"""The PyTorch port's training ops against the JAX package, on the CPU.

The attention-dropout hash, the plain versions of the flash backward
(`_attn_bwd_kernel`), the dropout forward (`_attn_drop_kernel`) and the
dropout backward (`_attn_drop_bwd_kernel`), the differentiable
`flash_attention`, and the stochastic ops. Inputs are made with numpy and go
through both packages as numpy arrays; the JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them on the CPU. The
port's wrappers take their plain versions here because the tensors lie on
the CPU; `chip_smoke.py` holds the CUDA kernels against the same plain
versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exploremultimodal_tpu.ops import flash_attention as jfa
from exploremultimodal_tpu.ops import stochastic as jst
from exploremultimodal_tpu.ops.attention import key_padding_bias as jax_key_padding_bias
from exploremultimodal_tpu.ops.attention import multi_head_attention as jax_mha
from exploremultimodal_torch.ops import flash_attention as pfa
from exploremultimodal_torch.ops import stochastic as pst
from exploremultimodal_torch.ops.attention import key_padding_bias, multi_head_attention

D = 64
SCALE = D ** -0.5
RATE = 0.1


def _inputs(n, b=2, h=1, seed=0):
    """(B*H, N, D) fp32 q, k, v, do and a (B, N) key mask whose second row
    pads its last third."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b * h, n, D)).astype(np.float32)
                   for _ in range(4))
    mask = np.ones((b, n), np.int32)
    mask[-1, n - n // 3:] = 0
    return q, k, v, do, mask


def _jax_padded(n, mask, *arrays):
    """The JAX kernels' layout: N padded to BLOCK_Q with zero rows and a
    -1e30 key bias, (B, 1, N_pad) fp32."""
    n_pad = jfa._round_up(n, jfa.BLOCK_Q)
    pad = [(0, 0), (0, n_pad - n), (0, 0)]
    flat = [jnp.asarray(np.pad(a, pad)) for a in arrays]
    bias = jax_key_padding_bias(jnp.asarray(mask)).reshape(mask.shape[0], 1, n)
    bias = jnp.pad(bias, [(0, 0), (0, 0), (0, n_pad - n)],
                   constant_values=jfa.NEG_INF)
    return flat, bias


def _port_bias(mask):
    return key_padding_bias(torch.from_numpy(mask)).reshape(mask.shape).contiguous()


# ------------------------------------------------------------- dropout hash


@pytest.mark.parametrize("seed,rate,bh,n", [(1234, 0.1, 5, 237),
                                            (-7, 0.3, 3, 197),
                                            (2**31 - 1, 0.5, 2, 40)])
def test_dropout_keep_mask_bit_exact_against_jax(seed, rate, bh, n):
    """The port's hash (uint32 emulated in int64) gives JAX's
    `dropout_keep_mask` bit for bit, negative seeds included; exact."""
    want = np.asarray(jfa.dropout_keep_mask(jnp.asarray([seed], jnp.int32),
                                            bh, 1, n, rate)).reshape(bh, n, n)
    got = pfa.dropout_keep_mask_plain(torch.tensor([seed], dtype=torch.int32),
                                      bh, n, rate)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert abs((want > 0).mean() - (1 - rate)) < 0.02


def test_dropout_threshold_and_scale_are_the_kernels():
    """The threshold is `_keep_mask`'s min(int(rate * 2^32), 2^32 - 1) and
    the scale its fp32 1 / (1 - rate)."""
    assert pfa.dropout_threshold(0.1) == int(0.1 * 2**32)
    assert pfa.dropout_threshold(1.0) == 2**32 - 1
    assert pfa.dropout_scale(0.1) == float(np.float32(1.0 / 0.9))


# ------------------------------------------------- plain kernels, rows 2-4


@pytest.mark.parametrize("n", [40, 197, 237, 333, 512])
def test_plain_dropout_forward_matches_jax_kernel(n):
    """Row 3: `flash_attention_fwd_drop_plain` against `_fwd_drop_call`
    (interpret mode), out and lse, fp32 throughout. Tolerance 1e-5: the two
    sum the same fp32 products in other orders."""
    q, k, v, _, mask = _inputs(n, seed=n)
    (jq, jk, jv), jbias = _jax_padded(n, mask, q, k, v)
    seed = np.asarray([4321], np.int32)
    want, want_lse = jfa._fwd_drop_call(jnp.asarray(seed), jq, jk, jv, jbias,
                                        SCALE, RATE)
    got, got_lse = pfa.flash_attention_fwd_drop(
        *map(torch.from_numpy, (q, k, v)), _port_bias(mask),
        torch.from_numpy(seed), SCALE, RATE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :n],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[:, :n, 0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [40, 197, 237])
@pytest.mark.parametrize("dropout", [False, True])
def test_plain_backward_matches_jax_kernel(n, dropout):
    """Rows 2 and 4: `flash_attention_bwd_plain` against `_bwd_call` and
    `flash_attention_bwd_drop_plain` against `_bwd_drop_call` (interpret
    mode) on the same forward output, lse and upstream gradient. The padded
    query rows get a zero gradient, as `flash_attention`'s slice gives them.
    fp32 throughout; tolerance 1e-4 for sums of up to 237 products of
    magnitude ~1 in other orders."""
    q, k, v, do, mask = _inputs(n, seed=10 + n)
    (jq, jk, jv, jdo), jbias = _jax_padded(n, mask, q, k, v, do)
    seed = np.asarray([99], np.int32)
    if dropout:
        jo, jlse = jfa._fwd_drop_call(jnp.asarray(seed), jq, jk, jv, jbias,
                                      SCALE, RATE)
        want = jfa._bwd_drop_call(jnp.asarray(seed), jq, jk, jv, jbias, jo, jdo,
                                  jlse, SCALE, RATE)
    else:
        jo, jlse = jfa._fwd_call(jq, jk, jv, jbias, SCALE)
        want = jfa._bwd_call(jq, jk, jv, jbias, jo, jdo, jlse, SCALE)
    o = torch.from_numpy(np.asarray(jo)[:, :n].copy())
    lse = torch.from_numpy(np.asarray(jlse)[:, :n, 0].copy())
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    if dropout:
        got = pfa.flash_attention_bwd_drop(tq, tk, tv, _port_bias(mask),
                                           torch.from_numpy(seed), o, tdo, lse,
                                           SCALE, RATE)
    else:
        got = pfa.flash_attention_bwd(tq, tk, tv, _port_bias(mask), o, tdo, lse,
                                      SCALE)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :n], rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors no kernel is launched: every count stays put."""
    q, k, v, do, mask = _inputs(40)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    seed = torch.tensor([5], dtype=torch.int32)
    fns = (pfa.flash_attention_fwd_drop, pfa.flash_attention_bwd,
           pfa.flash_attention_bwd_drop)
    before = [f.launches for f in fns]
    o, lse = pfa.flash_attention_fwd_drop(tq, tk, tv, _port_bias(mask), seed,
                                          SCALE, RATE)
    pfa.flash_attention_bwd(tq, tk, tv, _port_bias(mask), o, tdo, lse, SCALE)
    pfa.flash_attention_bwd_drop(tq, tk, tv, _port_bias(mask), seed, o, tdo,
                                 lse, SCALE, RATE)
    assert [f.launches for f in fns] == before


# ------------------------------------------------------ differentiable call


@pytest.mark.parametrize("n,rate", [(40, 0.0), (197, 0.0), (197, RATE),
                                    (237, RATE), (333, RATE), (520, 0.0)])
def test_flash_attention_grads_match_jax_vjp(n, rate):
    """The port's `flash_attention` (autograd over rows 1+2, rows 3+4, or
    the long-sequence recompute backward at N > 512) against `jax.vjp` of
    the JAX `flash_attention` on the same inputs, seed and cotangent. fp32;
    tolerance 1e-4."""
    b, h = (2, 2) if n <= 512 else (1, 1)
    q, k, v, do, mask = _inputs(n, b=b, h=h, seed=n + int(rate * 10))
    shape = (b, h, n, D)
    q, k, v, do = (a.reshape(shape) for a in (q, k, v, do))
    seed = np.asarray([77], np.int32)
    kw = dict(dropout_rate=rate, dropout_seed=jnp.asarray(seed)) if rate else {}
    jbias = jax_key_padding_bias(jnp.asarray(mask))
    want_out, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, bias=jbias,
                                               scale=SCALE, **kw),
        *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(do))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    pkw = dict(dropout_rate=rate, dropout_seed=torch.from_numpy(seed)) if rate else {}
    out = pfa.flash_attention(*leaves, bias=key_padding_bias(torch.from_numpy(mask)),
                              scale=SCALE, **pkw)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-4, atol=1e-4)
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_training_attention_routes_as_jax():
    """`auto` with live dropout goes to the in-kernel dropout path with the
    step's next seed, and gives what `flash_attention` gives for that seed;
    without a StepRng it is JAX's deterministic recompute chain."""
    q, k, v, _, mask = _inputs(40, b=2, h=2)
    q, k, v = (torch.from_numpy(a.reshape(2, 2, 40, D)) for a in (q, k, v))
    bias = key_padding_bias(torch.from_numpy(mask))
    rng = pst.StepRng(torch.Generator().manual_seed(0),
                      torch.Generator().manual_seed(1), torch.device("cpu"))
    got = multi_head_attention(q, k, v, bias=bias, dropout_rate=RATE,
                               dropout_rng=rng, impl="auto")
    assert rng.attention_calls == 1
    want = pfa.flash_attention(q, k, v, bias=bias, scale=SCALE, dropout_rate=RATE,
                               dropout_seed=rng._seeds[0:1])
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    det = multi_head_attention(q, k, v, bias=bias, dropout_rate=RATE, impl="auto")
    jdet = jax_mha(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                   bias=jax_key_padding_bias(jnp.asarray(mask)),
                   dropout_rate=RATE, impl="auto")
    np.testing.assert_allclose(det.numpy(), np.asarray(jdet), rtol=1e-5, atol=1e-5)


def test_step_rng_draws_device_seeds_ahead():
    """Each attention call takes the next of the step's seeds, one int32
    element on the device, and a step that needs more raises."""
    rng = pst.StepRng(torch.Generator().manual_seed(0),
                      torch.Generator().manual_seed(3), torch.device("cpu"),
                      max_attention_calls=2)
    a, b = rng.attention_seed(), rng.attention_seed()
    assert a.dtype == torch.int32 and a.shape == (1,) and not torch.equal(a, b)
    with pytest.raises(RuntimeError, match="max_attention_calls"):
        rng.attention_seed()
    again = pst.StepRng(torch.Generator().manual_seed(0),
                        torch.Generator().manual_seed(3), torch.device("cpu"))
    assert torch.equal(again.attention_seed(), a)


# --------------------------------------------------------- stochastic ops


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fast_dropout_matches_jax_with_its_bits(monkeypatch, rate, dtype):
    """`fast_dropout_plain` fed the uint16 bits JAX's `FastDropout` drew
    (as the port stores a draw u: the int16 u - 32768) gives JAX's output
    exactly: threshold round(rate * 65536), scale 65536 / (65536 - t) in
    x's dtype."""
    drawn = []
    real_bits = jax.random.bits

    def capture(key, shape=(), dtype=jnp.uint32):
        out = real_bits(key, shape, dtype)
        drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bits", capture)
    x = np.random.default_rng(1).standard_normal((4, 7, 96)).astype(np.float32)
    want = jst.FastDropout(rate).apply({}, jnp.asarray(x, dtype), deterministic=False,
                                       rngs={"dropout": jax.random.key(0)})
    assert len(drawn) == 1 and drawn[0].dtype == np.uint16
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    bits = (drawn[0].astype(np.int32) - 32768).astype(np.int16)
    got = pst.fast_dropout_plain(torch.from_numpy(x).to(tdt), rate,
                                 torch.from_numpy(bits))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_drop_path_matches_jax_with_its_mask(monkeypatch, rate):
    """`drop_path_plain` fed the per-sample keep mask JAX's `drop_path` drew
    gives JAX's output exactly."""
    drawn = []
    real = jax.random.bernoulli

    def capture(key, p=0.5, shape=None):
        out = real(key, p, shape)
        drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", capture)
    x = np.random.default_rng(2).standard_normal((16, 5, 8)).astype(np.float32)
    want = jst.drop_path(jnp.asarray(x), rate, jax.random.key(3), deterministic=False)
    keep = torch.from_numpy(drawn[0].reshape(16).copy())
    got = pst.drop_path_plain(torch.from_numpy(x), rate, keep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stochastic_ops_are_identity_without_a_step_rng():
    """rng None is JAX's deterministic=True; a live rng draws on the step's
    generator at about the configured rate."""
    x = torch.ones(64, 100)
    assert pst.fast_dropout(x, 0.1, None) is x and pst.drop_path(x, 0.1, None) is x
    rng = pst.StepRng(torch.Generator().manual_seed(0), torch.Generator(),
                      torch.device("cpu"))
    kept = (pst.fast_dropout(x, 0.1, rng) != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.01
    y = pst.drop_path(x, 0.5, rng)
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
