"""The port's optimizer menu against JAX's `create_optimizer`, on the CPU.

Every name of JAX's `_update_rule` table, two `lookahead_` names and a
`fused`-prefixed one build the port's optimizer (`RuleOptimizer`, or
`torch.optim.AdamW` for adamw) and JAX's optax chain over the same
parameter tree; the same seeded numpy gradients go into both, and each
step's parameter change must match (3 steps, 7 where lookahead syncs at
the 6th, or where radam's rectified branch starts at the 6th at b2 0.98).

The tree is a small VLMo-shaped one (flax paths that the multipliers, the
decay mask and the head and fusion groups read) with leaves whose dims
reach 128, so that adafactor factors (a Dense kernel, the 3-D pos_embed)
and does not (the narrow ones), a zero bias (the trust ratio's 1) and a
leaf with a zero gradient (an expert the step does not reach).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.train import optim as joptim
from exploremultimodal_torch.config import load_config
from exploremultimodal_torch.models.convert import from_flax_params
from exploremultimodal_torch.train import optim as poptim

BASE = ["model=vlmo_debug", "train=pretrain_mum", "train.warmup_steps=2",
        "train.base_lr=1e-2", "train.warmup_lr=1e-3", "train.epochs=2",
        "train.clip_grad=1.0", "train.lr_mult_head=2.0", "train.lr_mult_fusion=3.0"]
NAMES = sorted(poptim.RULES) + ["lookahead_adamw", "lookahead_lamb", "FusedLAMB"]
# each rule's tolerance on a step's change, relative to the leaf's largest
# change (fp32 arithmetic in another order), plus two fp32 spacings of the
# parameter: the adaptive rules divide by
# square roots of small moments, adafactor adds its means in another order
TOL = {"adafactor": 2e-4, "radam": 2e-4, "nadam": 2e-4}
LION_B1 = 0.9


def _tree() -> dict:
    """A flax parameter tree with VLMo's paths at small widths: a Dense
    kernel, a conv kernel and the 3-D pos_embed that adafactor factors, a
    narrow kernel it does not, an embedding table (not a kernel), LayerNorm
    leaves and zero biases (no decay), the fusion block and two heads (their
    LR multipliers) and the 0-d itc_temp."""
    rng = np.random.default_rng(0)

    def w(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "transformer": {
            "patch_embed": {"kernel": w(4, 4, 3, 32)},
            "pos_embed": w(1, 130, 128),
            "txt_embeddings": {"word_embeddings": {"embedding": w(200, 32)}},
            "blocks_0": {"norm1": {"scale": 1 + w(32), "bias": w(32)},
                         "attn": {"qkv": {"kernel": w(32, 96)}}},
            "blocks_1": {"attn": {"qkv": {"kernel": w(128, 384)},
                                  "v_bias": np.zeros(128, np.float32)},
                         "mlp_v": {"fc2": {"bias": w(128)}},
                         "mlp_vl": {"fc2": {"kernel": w(256, 128)}}},
        },
        "mlm_head": {"bias": np.zeros(200, np.float32)},
        "itm_head": {"fc": {"kernel": w(32, 2)}},
        "itc_temp": np.asarray(0.07, np.float32),
    }


def _grads(tree, rng):
    def g(path, x):
        name = jax.tree_util.keystr(path)
        if "mlp_v'" in name and "fc2" in name and "bias" in name:
            return np.zeros_like(x)  # an expert the step does not reach
        return (rng.standard_normal(x.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(g, tree)


def _find(state, kind):
    """The first optax state of `kind` in a chain's (nested) state."""
    for leaf in jax.tree_util.tree_leaves(state, is_leaf=lambda s: isinstance(s, kind)):
        if isinstance(leaf, kind):
            return leaf
    raise LookupError(kind)


@pytest.mark.parametrize("name", NAMES)
def test_rule_steps_match_create_optimizer(name):
    """The port's `create_optimizer(name)` against JAX's chain (clip ->
    rule -> decay where the rule takes it -> -lr -> multipliers, lookahead
    around it): every leaf's change at each step within TOL of its largest.
    lion's update is the sign of (1 - b1) g + b1 mu, and a sign of a value
    within fp32 noise of 0 may flip: its momentum is compared at 1e-6, and
    its step only where that argument is above 1e-4 of the leaf's largest
    (from JAX's momentum before the step). Every comparison allows two
    fp32 spacings of the parameter besides: both sides round p + du."""
    overrides = BASE + [f"train.opt.name={name}"]
    rule, lookahead = poptim.parse_name(name)
    steps = 7 if lookahead or rule == "radam" else 3
    tree = _tree()
    tx, jsched = joptim.create_optimizer(jax_load_config(overrides), tree, 5)
    named = {k: v.requires_grad_() for k, v in from_flax_params(tree).items()}
    opt, psched = poptim.create_optimizer(load_config(overrides), named, 5)
    assert isinstance(opt.torch, torch.optim.AdamW) == (name == "adamw")
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(11)
    tol = TOL.get(rule, 1e-4)
    for t in range(steps):
        grads = _grads(tree, rng)
        before = {k: p.detach().clone() for k, p in named.items()}
        for k, g in from_flax_params(grads).items():
            named[k].grad = g
        if rule == "lion":
            mu_before = from_flax_params(jax.device_get(_find(jstate, optax.ScaleByLionState).mu))
        opt.step(t)
        updates, jstate = update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        assert psched(t) == pytest.approx(float(jsched(t)), rel=1e-4)
        want = from_flax_params(jax.device_get(jparams))
        gt = from_flax_params(grads)
        for k, p in named.items():
            got_step = (p.detach() - before[k]).double().numpy()
            want_step = want[k].double().numpy() - before[k].double().numpy()
            # plus two fp32 spacings of the parameter: each side rounds p + du
            atol = tol * np.abs(want_step).max() + 2 * np.spacing(
                np.abs(before[k].numpy())).astype(np.float64)
            if rule == "lion":
                arg = ((1 - LION_B1) * gt[k] + LION_B1 * mu_before[k]).double().numpy()
                keep = np.abs(arg) > 1e-4 * max(np.abs(arg).max(), 1e-30)
                got_step, want_step, atol = got_step[keep], want_step[keep], atol[keep]
            bad = np.abs(got_step - want_step) > atol
            assert not bad.any(), (f"{name} {k} step {t}: {bad.sum()} of {bad.size} off, "
                                   f"{got_step[bad][:4]} vs {want_step[bad][:4]}")
        if rule == "lion":
            mu = from_flax_params(jax.device_get(_find(jstate, optax.ScaleByLionState).mu))
            for k, p in named.items():
                st = opt.torch.state[p]
                np.testing.assert_allclose(st["mu"].numpy(), mu[k].numpy(), rtol=1e-6,
                                           atol=1e-9, err_msg=f"lion mu {k}")


# flax leaf shapes: a tie, a Dense kernel (in, out), an HWIO conv kernel
@pytest.mark.parametrize("shape", [(128, 128), (256, 128), (3, 3, 128, 256)])
def test_adafactor_factors_by_the_flax_leaf(shape):
    """Adafactor on the torch layout (a Dense kernel transposed, a conv
    OIHW) gives optax's `scale_by_factored_rms` update of the flax leaf:
    optax factors the two largest axes, the same physical axes in either
    layout, and the update is symmetric in which of them is the row (ties
    included). Three steps of seeded gradients; its factored state is the
    torch leaf's row and column vectors."""
    rng = np.random.default_rng(3)
    to_torch = (1, 0) if len(shape) == 2 else (3, 2, 0, 1)
    leaf = rng.standard_normal(shape).astype(np.float32)
    p = torch.from_numpy(leaf.transpose(to_torch).copy()).requires_grad_()
    opt = poptim.RuleOptimizer([p], rule="adafactor", lr=1.0)
    tx = optax.scale_by_factored_rms()
    jstate = tx.init(jnp.asarray(leaf))
    for _ in range(3):
        g = rng.standard_normal(shape).astype(np.float32)
        p.grad = torch.from_numpy(g.transpose(to_torch).copy())
        before = p.detach().clone()
        opt.step()
        u, jstate = tx.update(jnp.asarray(g), jstate, jnp.asarray(leaf))
        want = np.asarray(u).transpose(to_torch).astype(np.float64)
        got = (before - p.detach()).double().numpy()
        atol = 2e-4 * np.abs(want).max() + 2 * np.spacing(np.abs(before.numpy()))
        bad = np.abs(got - want) > atol
        assert not bad.any(), f"{bad.sum()} of {bad.size} off: {got[bad][:4]} vs {want[bad][:4]}"
    st = opt.state[p]
    d1, d0 = poptim.factored_dims(p.shape)
    assert "v" not in st and st["v_row"].numel() * p.shape[d0] == p.numel()
    assert st["v_col"].numel() * p.shape[d1] == p.numel()
    assert poptim.factored_dims((16, 16, 3, 768)) is None


@pytest.mark.parametrize("name", ["sgdw", "adamax", "lookahead_sgdw"])
def test_unknown_names_raise_as_jaxs(name):
    """A name outside JAX's table raises NotImplementedError listing the
    rules, in both packages (`sgdw` is in JAX's decay list, not its
    table)."""
    overrides = BASE + [f"train.opt.name={name}"]
    with pytest.raises(NotImplementedError, match="available") as jerr:
        joptim.create_optimizer(jax_load_config(overrides), _tree(), 5)
    with pytest.raises(NotImplementedError, match="available") as perr:
        poptim.create_optimizer(load_config(overrides), from_flax_params(_tree()), 5)
    assert str(perr.value) == str(jerr.value)
