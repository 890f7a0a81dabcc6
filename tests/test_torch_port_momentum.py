"""pretrain_mum's full recipe in the PyTorch port against the JAX package,
on the CPU: the ITC momentum encoder with the negative queues and the local
global-to-local losses, the eval EMA, and gradient accumulation.

The shapes are `tests/test_momentum_itc.py`'s (vlmo_debug: image 32, width
32, 2 heads, 12 tokens, `itc_dim` 16, a queue of 64, batch 8), fp32, with
every dropout at 0. The same seeded inputs go through the JAX functions and
their counterparts in the port; the whole-step cases run JAX's `Trainer`
(its jitted `train_step`) and the port's from the same initial state
(parameters, both EMA trees, the queues and the pointer carried over by
`load_flax_train_state`), with the ITM negatives injected on both sides.
Losses within rtol 1e-5 and gradients within rtol 1e-3 plus 1e-3 of the
leaf's largest magnitude, as in `tests/test_torch_port_train_step.py`.

The whole-step cases take AdamW's eps at 1 and a learning rate of 1e-2 from
the first step: the first AdamW step is lr * g / (|g| + eps), which with
the default eps of 1e-8 is lr * sign(g), so a gradient element near zero
(below the two frameworks' summation differences) could take either sign.
With eps 1 the step follows the gradient continuously, so the parameters
after it hold the gradients to the gradient tolerance; each tree's change
over the step is compared, within rtol 1e-3 plus 1e-3 of the leaf's
largest change and two ulps of its largest value (the rounding of the
weights themselves). The EMA decays are set apart from their defaults (0.9
and 0.99), so that one step moves each tree well past that rounding.
"""

import copy
import functools
import itertools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.models.task import build_model as jax_build_model
from exploremultimodal_tpu.objectives import losses as jlosses
from exploremultimodal_tpu.ops.preprocess import preprocess_batch as jax_preprocess
from exploremultimodal_tpu.train import state as jstate
from exploremultimodal_tpu.train.trainer import Trainer as JaxTrainer
from exploremultimodal_torch.config import VlmoConfig, load_config
from exploremultimodal_torch.models.convert import from_flax_params, load_flax_train_state
from exploremultimodal_torch.models.task import VlmoTask
from exploremultimodal_torch.objectives import losses as plosses
from exploremultimodal_torch.ops.preprocess import preprocess_batch
from exploremultimodal_torch.train import checkpoints as ckpt_lib
from exploremultimodal_torch.train import state as pstate
from exploremultimodal_torch.train.trainer import Trainer

BATCH, QUEUE, ITC_DIM = 8, 64, 16
TINY = [
    "model=vlmo_debug", "train=pretrain_mum", "train.loss_names=[itc,itm,mlm]",
    "train.datasets=[synthetic]", f"data.batch_size={BATCH}", "data.synthetic_size=16",
    "model.img_size=32", "model.embed_dim=32", "model.num_heads=2",
    "model.max_text_len=12", f"model.itc_dim={ITC_DIM}", "model.drop_rate=0.0",
    "model.attn_drop_rate=0.0", "model.drop_path_rate=0.0", "data.num_mask_patches=2",
    "data.min_mask_patches_per_block=1", "compute_dtype=float32", "attn_impl=xla",
]
RECIPE = ["vlmo_ema=true", "train.neg_queue=true", f"train.queue_size={QUEUE}",
          "model_ema=true", "vlmo_ema_decay=0.9", "model_ema_decay=0.99"]
# the first step at lr 1e-2, AdamW's eps at 1 (the module docstring says why)
STEP = ["train.warmup_steps=1", "train.warmup_lr=1e-2", "train.base_lr=1e-2",
        "train.opt.eps=1.0"]
RTOL = 1e-5
NEG = {8: (np.array([3, 0, 1, 2, 7, 4, 5, 6]), np.array([1, 2, 3, 0, 5, 6, 7, 4])),
       4: (np.array([2, 3, 1, 0]), np.array([1, 0, 3, 2]))}
TREES = ("params", "ema_params", "model_ema_params")


def _jitted_init(init):
    """flax's `Module.init` under one jit, compiled once for each module
    (by its fields), method and input shapes: JAX's trainer initializes
    eagerly, op by op, which costs seconds of compiles."""
    jitted = jax.jit(lambda self, r, a, method: init(self, r, *a, method=method),
                     static_argnums=(0, 3))

    def jinit(self, rngs, *args, method=None):
        return jitted(self, rngs, args, method)

    return jinit


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads while this file runs, the count restored after:
    beside the other test processes, one thread per core oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _fast_init():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTask, "init", _jitted_init(JaxTask.init))
        yield


def _inject(mp, rows):
    """JAX draws the ITM negatives with `jax.random.categorical`, images for
    each text first, then texts for each image: every traced call returns
    the given indices in turn (a jitted step traces its microbatch body
    once, so one pair serves every microbatch, as the port's `negatives`)."""
    given = itertools.cycle(NEG[rows])
    mp.setattr(jax.random, "categorical",
               lambda key, logits, axis=-1: jnp.asarray(next(given)))


def _parts(state) -> dict:
    """A JAX TrainState's parameters, trees, queues and pointer as numpy."""
    return jax.device_get({k: getattr(state, k) for k in (*TREES, "img_queue",
                                                           "txt_queue", "queue_ptr")
                           if getattr(state, k) is not None})


def _jbatch(host: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in host.items()}


def _close_change(got: torch.nn.Module, want: dict, before: dict, what: str) -> None:
    """Each parameter's change over the step against JAX's."""
    want, before = from_flax_params(want), from_flax_params(before)
    for name, p in got.named_parameters():
        w, b = want[name].numpy(), before[name].numpy()
        d_want = w - b
        atol = 1e-3 * np.abs(d_want).max() + 2 * np.spacing(np.abs(b).max())
        np.testing.assert_allclose(p.detach().numpy() - b, d_want, rtol=1e-3, atol=atol,
                                   err_msg=f"{what} {name}")


def _close_metrics(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), atol=1e-7, err_msg=k,
                                   rtol=1e-4 if k == "grad_norm" else RTOL)


@functools.cache
def _jax_trainer(family: tuple) -> JaxTrainer:
    """One JAX Trainer for each family of overrides (the same losses and
    recipe, any accumulation), built once for the module."""
    return JaxTrainer(jax_load_config(list(family) + [f"exp_dir={tempfile.mkdtemp()}"]))


def _run(tmp, overrides, steps, accum_rows=BATCH):
    """`steps` steps of JAX's Trainer and the port's from JAX's initial state
    on the port's first batches; returns (JAX trainer, its state before and
    after, its metrics, the port's trainer, its metrics, the batches). The
    JAX trainer is its family's (`_jax_trainer`), with these overrides'
    config, so its train step is traced for their accumulation."""
    family = tuple(o for o in overrides if not o.startswith("train.accumulation_steps="))
    jtrainer = copy.copy(_jax_trainer(family))
    jtrainer.cfg = jax_load_config(overrides + [f"exp_dir={tmp}/jax"])
    jtrainer._eval_step = None
    trainer = Trainer(load_config(overrides + [f"exp_dir={tmp}/port"]), device="cpu")
    batches = [trainer.next_batch() for _ in range(steps)]
    state = jtrainer.init_state(_jbatch(batches[0]))
    init = _parts(state)
    load_flax_train_state(trainer.state, init)
    jmetrics, pmetrics = [], []
    with pytest.MonkeyPatch.context() as mp:
        _inject(mp, accum_rows)
        train_step = jtrainer.make_train_step()
        for batch in batches:
            state, m = train_step(state, _jbatch(batch), jnp.asarray(0.0))
            jmetrics.append(jax.device_get(m))
            pmetrics.append(trainer.step(batch, negatives=NEG[accum_rows]))
    return jtrainer, init, state, jmetrics, trainer, pmetrics, batches


def _check_step(init, state, jmetrics, trainer, pmetrics):
    for got, want in zip(pmetrics, jmetrics):
        _close_metrics(got, want)
    after = _parts(state)
    st = trainer.state
    for name, tree in zip(TREES, (st.task, st.ema_task, st.model_ema_task)):
        assert (tree is None) == (name not in after), name
        if tree is not None:
            _close_change(tree, after[name], init["params"], name)
    assert (st.img_queue is None) == ("img_queue" not in after)
    if st.img_queue is not None:
        assert st.queue_ptr == int(after["queue_ptr"])
        for key in ("img_queue", "txt_queue"):
            np.testing.assert_allclose(getattr(st, key).numpy(), after[key], rtol=RTOL,
                                       atol=1e-6, err_msg=key)


@pytest.fixture(scope="module")
def recipe_run(tmp_path_factory):
    """Two steps of the recipe (momentum encoder, queues, eval EMA) on
    itc, itm and mlm in both packages."""
    return _run(tmp_path_factory.mktemp("recipe"), TINY + RECIPE + STEP, 2)


# ------------------------------------------------------------ state updates


def test_ema_and_queue_updates_match_jax():
    """`ema_update` over every parameter at decay 0.995, and `queue_update`
    writing 6 columns at pointer 60 of a 64-wide queue (wrapping to 0-1)."""
    rng = np.random.default_rng(0)
    cfg = VlmoConfig.from_config(load_config(TINY))
    task, ema = VlmoTask(cfg), VlmoTask(cfg)
    task.init_weights(torch.Generator().manual_seed(0))
    ema.init_weights(torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in task.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    e0 = {k: v.detach().clone() for k, v in ema.named_parameters()}
    pstate.ema_update(ema, task, 0.995)
    want = jstate.ema_update(
        {k: v.numpy() for k, v in e0.items()},
        {k: p.detach().numpy() for k, p in task.named_parameters()}, 0.995)
    for name, p in ema.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-9, err_msg=name)

    qi, qt = (rng.normal(size=(ITC_DIM, QUEUE)).astype(np.float32) for _ in range(2))
    fi, ft = (rng.normal(size=(6, ITC_DIM)).astype(np.float32) for _ in range(2))
    wi, wt, wptr = jstate.queue_update(*(jnp.asarray(x) for x in (qi, qt)),
                                       jnp.asarray(60, jnp.int32), jnp.asarray(fi),
                                       jnp.asarray(ft))
    gi, gt = torch.from_numpy(qi.copy()), torch.from_numpy(qt.copy())
    ptr = pstate.queue_update(gi, gt, 60, torch.from_numpy(fi), torch.from_numpy(ft))
    assert ptr == int(wptr) == 2
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gi.numpy()[:, [62, 63, 0, 1]], fi[2:].T)


def test_patch_pooling_matches_jax_and_avg_pool2d():
    """14 x 14 patches pool 3 x 3 windows into 4 x 4 with floor semantics."""
    x = np.random.default_rng(1).normal(size=(2, 196, 8)).astype(np.float32)
    got = plosses.patch_pooling(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 16, 8)
    np.testing.assert_allclose(got, np.asarray(jlosses.patch_pooling(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    t = torch.from_numpy(x).reshape(2, 14, 14, 8).permute(0, 3, 1, 2)
    pooled = F.avg_pool2d(t, 3, stride=3).permute(0, 2, 3, 1).reshape(2, -1, 8)
    np.testing.assert_allclose(got, pooled.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_in_batch_g2l_loss_matches_jax(offset, masked):
    """Globals of a microbatch of 3 (rows `offset`.. of 8) against all 8
    samples' 5 locals, with and without a local mask (each row keeps at
    least one); the value and the gradients at both inputs."""
    rng = np.random.default_rng(2 + offset)
    loc = rng.normal(size=(8, 5, 6)).astype(np.float32)
    glob = rng.normal(size=(3, 6)).astype(np.float32)
    mask = (rng.random((8, 5)) < 0.6).astype(np.int32)
    mask[:, 0] = 1
    temp = 14.285714
    am = mask if masked else None

    def jloss(l, m):
        return jlosses.in_batch_g2l_loss(l, m, temp, None if am is None else jnp.asarray(am),
                                         pos_offset=offset)

    want, (wl, wm) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(loc), jnp.asarray(glob))
    tl, tm = (torch.from_numpy(x).requires_grad_() for x in (loc, glob))
    got = plosses.in_batch_g2l_loss(tl, tm, temp,
                                    None if am is None else torch.from_numpy(am),
                                    pos_offset=offset)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    for g, w in ((tl.grad, wl), (tm.grad, wm)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-3 * np.abs(w).max())


# ------------------------------------------------------- ITC, ITM, features


@pytest.fixture(scope="module")
def model_setup(recipe_run):
    """JAX's initial parameters of the recipe's task (those `recipe_run`
    started from), the port's task with them, and the first batch
    preprocessed (with `image_aug`) in both."""
    jtrainer, init, host = recipe_run[0], recipe_run[1], recipe_run[6][0]
    jb = jax_preprocess({k: jnp.asarray(v) for k, v in host.items() if k != "index"})
    task = VlmoTask(VlmoConfig.from_config(load_config(TINY + RECIPE)))
    task.load_state_dict(from_flax_params(init["params"]), strict=True)
    pb = preprocess_batch({k: torch.from_numpy(v) for k, v in host.items()})
    return jtrainer.task, init["params"], jb, task, pb


def _feats_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("aug", [True, False])
def test_itc_momentum_feats_match_jax(model_setup, aug):
    """The five momentum features, with the augmented view and without it."""
    jtask, params, jb, task, pb = model_setup
    if not aug:
        jb = {k: v for k, v in jb.items() if k != "image_aug"}
        pb = {k: v for k, v in pb.items() if k != "image_aug"}
    want = jax.jit(lambda p, b: jtask.apply({"params": p}, b,
                                            method=JaxTask.itc_momentum_feats))(params, jb)
    with torch.no_grad():
        got = task.itc_momentum_feats(pb)
    _feats_close(got, want)
    assert got["i_feat_l_m"].shape == (BATCH, 4, ITC_DIM)  # a 2 x 2 grid, windows of 1


ITC_KEYS = ("i2t_Loss", "t2i_Loss", "i2i_Loss", "t2t_Loss", "i2i_l_Loss", "t2t_l_Loss",
            "itc_task_loss", "itc_i2t_mean_acc", "itc_t2i_mean_acc")


@functools.cache
def _jax_itc_grad(jtask):
    """JAX's momentum-mode ITC loss and its gradient, jitted once: the
    microbatch's offset is traced, so both offsets share a compile."""
    def itc(p, micro, mfeats, queue, offset):
        out = jtask.apply({"params": p}, micro, True, method=lambda t, b, d: jlosses.compute_itc(
            t, b, d, momentum_feats=mfeats, queue=queue, pos_offset=offset))
        return out["itc_task_loss"], {k: out[k] for k in ITC_KEYS + ("sim_i2t",)}

    return jax.jit(jax.value_and_grad(itc, has_aux=True))


@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("queue", [False, True])
def test_compute_itc_momentum_matches_jax(model_setup, queue, offset):
    """Momentum-mode ITC of a microbatch of 4 (rows 0-3 at offset 0, rows
    4-7 at offset 4) against the full batch's momentum features of jittered
    weights, with and without a queue of 64: every loss, both accuracies,
    the sims' width, and every parameter's gradient of the ITC loss."""
    jtask, params, jb, task, pb = model_setup
    rng = np.random.default_rng(7)
    mparams = jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, 0.02, x.shape).astype(np.float32), params)
    mfeats = jax.device_get(jtask.apply({"params": mparams}, jb,
                                        method=JaxTask.itc_momentum_feats))
    q = None
    if queue:
        qi, qt = (rng.normal(size=(ITC_DIM, QUEUE)).astype(np.float32) for _ in range(2))
        q = {"img": qi / np.linalg.norm(qi, axis=0), "txt": qt / np.linalg.norm(qt, axis=0)}
    rows = BATCH // 2
    jmicro = {k: v[offset:offset + rows] for k, v in jb.items()}
    pmicro = {k: v[offset:offset + rows] for k, v in pb.items()}
    (_, jout), jgrads = _jax_itc_grad(jtask)(
        params, jmicro, {k: jnp.asarray(v) for k, v in mfeats.items()},
        None if q is None else {k: jnp.asarray(v) for k, v in q.items()},
        jnp.asarray(offset, jnp.int32))
    out = plosses.compute_itc(
        task, pmicro, momentum_feats={k: torch.from_numpy(v) for k, v in mfeats.items()},
        queue=None if q is None else {k: torch.from_numpy(v) for k, v in q.items()},
        pos_offset=offset)
    task.zero_grad()
    out["itc_task_loss"].backward()
    assert out["sim_i2t"].shape == jout["sim_i2t"].shape == (rows, BATCH + QUEUE * queue)
    for k in ITC_KEYS:
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=RTOL, err_msg=k)
    want = from_flax_params(jax.device_get(jgrads))
    for name, p in task.named_parameters():
        w = want[name].numpy()
        if p.grad is None:
            assert not w.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)


def test_itm_hard_negatives_take_the_own_columns(model_setup, monkeypatch):
    """With sims of 4 rows against 8 momentum columns and a queue of 64, at
    offset 4, the hard-negative weights of both packages are the softmax
    over columns 4-7 with the diagonal out: the same weights in each."""
    jtask, params, jb, task, pb = model_setup
    rng = np.random.default_rng(9)
    sims = {k: rng.normal(0, 3, (4, BATCH + QUEUE)).astype(np.float32)
            for k in ("sim_i2t", "sim_t2i")}
    seen = {"jax": [], "port": []}

    def categorical(key, logits, axis=-1):
        seen["jax"].append(np.asarray(jax.nn.softmax(logits, axis=axis)))
        return jnp.arange(4)[::-1]

    def multinomial(w, n, generator=None):
        seen["port"].append((w / w.sum(1, keepdim=True)).numpy())
        return torch.arange(4).flip(0)[:, None]

    monkeypatch.setattr(jax.random, "categorical", categorical)
    monkeypatch.setattr(torch, "multinomial", multinomial)
    micro = {k: v[4:] for k, v in jb.items()}
    jtask.apply({"params": params}, micro, method=lambda t, b: jlosses.itm_sample_pairs(
        t, b, {k: jnp.asarray(v) for k, v in sims.items()}, jax.random.key(0),
        pos_offset=4))
    plosses.itm_sample_pairs(task, {k: v[4:] for k, v in pb.items()},
                             {k: torch.from_numpy(v) for k, v in sims.items()},
                             generator=torch.Generator(), pos_offset=4)
    # JAX draws images for each text (sim_t2i) first, the port the same
    for got, want, key in zip(seen["port"], seen["jax"], ("sim_t2i", "sim_i2t")):
        own = np.exp(sims[key][:, 4:8] - sims[key][:, 4:8].max(1, keepdims=True))
        np.fill_diagonal(own, 0.0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got, own / own.sum(1, keepdims=True), rtol=1e-5,
                                   atol=1e-7)


def test_synthetic_batches_carry_the_augmented_view_like_jax(recipe_run):
    """Under vlmo_ema the train split's samples carry `image_aug_u8`, drawn
    right after the image: every key equal to JAX's loader, epochs 0 and 1;
    the val split has no second view in either package."""
    jtrainer, trainer = recipe_run[0], recipe_run[4]
    loader = jtrainer.data.train_loader()
    loader.num_workers = 1
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        for want, got in zip(loader, trainer.loader.epoch(epoch)):
            assert set(got) == set(want) and "image_aug_u8" in got
            for key, w in want.items():
                np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert not np.array_equal(got["image_aug_u8"], got["image_u8"])
    assert "image_aug_u8" not in next(iter(jtrainer.data.val_loader()))
    assert "image_aug_u8" not in next(trainer.val_loader.epoch(0))


# ------------------------------------------------------------ whole steps


def test_recipe_steps_match_jax(recipe_run):
    """Two steps with the momentum encoder, the queues and the eval EMA:
    every metric (i2i, t2t, i2i_l and t2t_l among them) of each step, the
    parameters and both trees after them, the queues and the pointer."""
    _, init, state, jmetrics, trainer, pmetrics, _ = recipe_run
    for key in ("i2i_Loss", "t2t_Loss", "i2i_l_Loss", "t2t_l_Loss"):
        assert key in pmetrics[-1], key
    _check_step(init, state, jmetrics, trainer, pmetrics)
    assert trainer.state.queue_ptr == 2 * BATCH
    st = trainer.state
    assert (st.ema_decay, st.model_ema_decay) == (0.9, 0.99)


def test_evaluate_runs_the_eval_ema_like_jax(recipe_run, monkeypatch):
    """`evaluate` after the steps runs the eval EMA's tree, as JAX's: the
    val split's metrics equal JAX's evaluation of its `model_ema_params`
    (ITM's negatives injected in both), and differ from an evaluation of
    the trained parameters."""
    jtrainer, _, state, _, trainer, _, _ = recipe_run
    _inject(monkeypatch, BATCH)
    monkeypatch.setattr(torch, "multinomial", _port_negatives())
    jtrainer._eval_step = None  # traced anew under the injection
    want = jtrainer.evaluate(state, jtrainer.data.val_loader())
    got = trainer.evaluate()
    _close_metrics(got, want)
    assert trainer.eval_task() is trainer.state.model_ema_task
    monkeypatch.setattr(trainer, "eval_task", lambda: trainer.task)
    plain = trainer.evaluate()
    assert plain["itc_task_loss"] != got["itc_task_loss"]


def _port_negatives():
    """torch.multinomial giving the injected negatives: the image for each
    text first, then the text for each image, as JAX's draws."""
    given = itertools.cycle(NEG[BATCH])
    return lambda w, n, generator=None: torch.as_tensor(next(given))[:, None]


@pytest.mark.parametrize("case", ["momentum", "in_batch"])
def test_accumulation_matches_jax(tmp_path, case):
    """train.accumulation_steps=2, two microbatches of 4. `momentum`: the
    recipe, each microbatch against the full batch's momentum features at
    its row offset; the averaged metrics, the parameters and trees, and the
    queues advanced once by the whole batch. `in_batch`: the in-batch ITC
    (square sims of each microbatch, positives on the plain diagonal) with
    ITM, finite and equal to JAX."""
    extra = RECIPE if case == "momentum" else ["train.loss_names=[itc,itm]"]
    out = _run(tmp_path, TINY + extra + STEP + ["train.accumulation_steps=2"], 1,
               accum_rows=BATCH // 2)
    _check_step(*out[1:6])
    metrics = out[5][0]
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert ("i2i_Loss" in metrics) == (case == "momentum")
    if case == "momentum":
        assert out[4].state.queue_ptr == BATCH


def test_pretrain_txt_accumulation_matches_jax(tmp_path):
    """pretrain_txt (text-only MLM, the attention fixed, the vision side
    frozen) at accumulation_steps=2."""
    out = _run(tmp_path, TINY + STEP + ["train=pretrain_txt", "train.loss_names=[mlm]",
                                        "train.accumulation_steps=2"],
               1, accum_rows=BATCH // 2)
    _check_step(*out[1:6])


# ------------------------------------------------------ checkpoints, config


def test_checkpoint_round_trip_and_warm_start(tmp_path):
    """A full resume restores both trees, the queues and the pointer bit for
    bit; a run without the momentum encoder refuses that checkpoint; a warm
    start (tag mismatch, or a `.pth`) loads the parameters and leaves the
    trees and queues as the run built them (ROADMAP C7, as JAX)."""
    overrides = TINY + RECIPE + [f"exp_dir={tmp_path / 'run'}"]
    trainer = Trainer(load_config(overrides), device="cpu")
    trainer.step()
    path = ckpt_lib.save(str(tmp_path / "run"), trainer.state, trainer.cfg, epoch=0)
    saved = ckpt_lib.state_dict(trainer.state)

    fresh = Trainer(load_config(overrides), device="cpu")
    restored, _ = ckpt_lib.auto_load(str(tmp_path / "run"), fresh.state, fresh.cfg)
    got = ckpt_lib.state_dict(restored)
    for key in ("ema", "model_ema"):
        assert got[key].keys() == saved[key].keys()
        assert all(torch.equal(v, saved[key][k]) for k, v in got[key].items()), key
    assert got["queue"]["ptr"] == saved["queue"]["ptr"] == BATCH
    for key in ("img", "txt"):
        assert torch.equal(got["queue"][key], saved["queue"][key])

    plain = Trainer(load_config(TINY + [f"exp_dir={tmp_path / 'run'}"]), device="cpu")
    with pytest.raises(ValueError, match="ema"):
        ckpt_lib.load_state_dict(plain.state, ckpt_lib.read_checkpoint(path)[0])

    other = Trainer(load_config(overrides + ["tag=other"]), device="cpu")
    init = ckpt_lib.state_dict(other.state)
    init = {"ema": {k: v.clone() for k, v in init["ema"].items()},
            "img": init["queue"]["img"].clone()}
    ckpt_lib.auto_load(str(tmp_path / "run"), other.state, other.cfg)
    now = ckpt_lib.state_dict(other.state)
    assert all(torch.equal(v, saved["model"][k]) for k, v in now["model"].items())
    assert all(torch.equal(v, init["ema"][k]) for k, v in now["ema"].items())
    assert not all(torch.equal(v, saved["ema"][k]) for k, v in now["ema"].items())
    assert torch.equal(now["queue"]["img"], init["img"]) and now["queue"]["ptr"] == 0

    key = "transformer.blocks.0.attn.q_bias"
    pth = tmp_path / "import.pth"
    torch.save({"model": {"blocks.0.attn.q_bias": torch.full((32,), 1.25)}}, str(pth))
    imported = Trainer(load_config(overrides + [f"train.resume={pth}"]), device="cpu")
    before = imported.state.model_ema_task.get_parameter(key).clone()
    ckpt_lib.auto_load(str(tmp_path / "none"), imported.state, imported.cfg)
    assert torch.equal(imported.task.get_parameter(key), torch.full((32,), 1.25))
    assert torch.equal(imported.state.model_ema_task.get_parameter(key), before)


@pytest.mark.parametrize("key", ["vlmo_ema=true", "model_ema=true", "train.neg_queue=true",
                                 "train.accumulation_steps=2", "train.global_reduce=true"])
def test_trainer_accepts_the_recipe_keys(key):
    """Each of the five keys builds a trainer that takes a step; an arrow
    dataset whose tables are absent (no training data) and a loss the port
    has no head for (every loss of the JAX package has one) are refused."""
    trainer = Trainer(load_config(TINY + [key]), device="cpu")
    metrics = trainer.step()
    assert np.isfinite(float(metrics["total_loss"]))
    st = trainer.state
    assert (st.ema_task is not None) == (key == "vlmo_ema=true")
    assert (st.model_ema_task is not None) == (key == "model_ema=true")
    assert (st.img_queue is not None) == (key == "train.neg_queue=true")
    if key == "train.neg_queue=true":  # built, never written without vlmo_ema
        assert st.img_queue.shape == (ITC_DIM, 65536) and st.queue_ptr == 0
        norms = torch.linalg.vector_norm(st.img_queue[:, :8], dim=0)
        torch.testing.assert_close(norms, torch.ones(8))
    with pytest.raises(FileNotFoundError, match="datasets"):
        Trainer(load_config(TINY + [key, "train.datasets=[coco]"]), device="cpu")
    with pytest.raises(NotImplementedError, match="loss_names"):
        Trainer(load_config(TINY + [key, "train.loss_names=[itc,unknown]"]), device="cpu")
