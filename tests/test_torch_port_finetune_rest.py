"""The PyTorch port's last four phases (finetune_caption, finetune_vis,
finetune_ref, finetune_inpainting) and the MPP objective against the JAX
package, on the CPU.

At a small width (vlmo_debug at 32 wide, 2 heads; 32^2 images, 8 tokens,
batch 2) in fp32, with every dropout at 0 (JAX's `deterministic=True`, the
port's `rng=None`): the random and region maskers and the synthetic samples
of each phase bit for bit; the MPP, image-class and box heads and the MPP,
image-class and referring losses and `box_iou_giou`, with their gradients,
within 1e-5 relative; each phase's whole task (losses, and every gradient
within 1e-5 relative L2, a bias's against its layer's weight gradient); the
frozen sets (C9: finetune_caption holds the image side and the fused
experts fixed in both packages); one `Trainer.step` of each phase from
JAX's initial state against JAX's jitted `train_step`, and `evaluate`
after it (`refcoco_mean_score` and every `*_mean_acc` weighed by its
count); each phase through `main` with `device=cpu`.

The whole-step cases take AdamW's eps at 1 and a learning rate of 1e-2,
as `tests/test_torch_port_momentum.py` does and for its reason (the first
AdamW step is lr * sign(g) at the default eps, which a gradient element
near zero could take either way); each parameter's change is compared
within rtol 1e-3 plus 1e-3 of the leaf's largest change.
"""

import functools
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exploremultimodal_tpu.models.dvae as jdvae
from exploremultimodal_tpu.config import load_config as jax_load_config
from exploremultimodal_tpu.data import masking as jmasking
from exploremultimodal_tpu.data.datamodule import MultiTaskData
from exploremultimodal_tpu.models import heads as jheads
from exploremultimodal_tpu.models.task import VlmoTask as JaxTask
from exploremultimodal_tpu.models.task import build_model as jax_build_model
from exploremultimodal_tpu.models.task import total_loss as jax_total_loss
from exploremultimodal_tpu.objectives import losses as jlosses
from exploremultimodal_tpu.ops.preprocess import preprocess_batch as jax_preprocess
from exploremultimodal_tpu.train import optim as joptim
from exploremultimodal_tpu.train.trainer import Trainer as JaxTrainer
import exploremultimodal_torch.models.dvae as pdvae
from exploremultimodal_torch.config import VlmoConfig, load_config
from exploremultimodal_torch.data import masking as pmasking
from exploremultimodal_torch.data.datasets import build_dataset
from exploremultimodal_torch.data.pipeline import Loader
from exploremultimodal_torch.main import main as port_main
from exploremultimodal_torch.models import heads as pheads
from exploremultimodal_torch.models.convert import from_flax_params, load_flax_train_state
from exploremultimodal_torch.models.task import VlmoTask, total_loss
from exploremultimodal_torch.objectives import losses as plosses
from exploremultimodal_torch.ops.preprocess import preprocess_batch
from exploremultimodal_torch.train import optim as poptim
from exploremultimodal_torch.train.trainer import Trainer

BATCH, IMG, TEXT_LEN, WIDTH = 2, 32, 8, 32
TINY = [
    "model=vlmo_debug", f"model.img_size={IMG}", f"model.embed_dim={WIDTH}",
    "model.num_heads=2", f"model.max_text_len={TEXT_LEN}", "compute_dtype=float32",
    "train.datasets=[synthetic]", f"data.batch_size={BATCH}", "data.synthetic_size=4",
    "data.num_mask_patches=2", "data.min_mask_patches_per_block=1",
    "train.discrete_vae_type=random", "model.drop_rate=0.0", "model.attn_drop_rate=0.0",
    "model.drop_path_rate=0.0", "attn_impl=recompute",
]
# the first step at lr 1e-2, AdamW's eps at 1 (the module docstring says why)
STEP = ["train.warmup_steps=1", "train.warmup_lr=1e-2", "train.base_lr=1e-2",
        "train.opt.eps=1.0"]
PHASES = {
    "caption": ["train=finetune_caption"],
    "vis": ["train=finetune_vis"],
    "ref": ["train=finetune_ref"],
    "inpainting": ["train=finetune_inpainting", "data.mask_style=region"],
    "mpp": ["train=pretrain_mum", "train.loss_names=[mpp]"],
}
LOSSES = {"caption": "mlm", "vis": "imgcls", "ref": "refcoco", "inpainting": "mim",
          "mpp": "mpp"}
NARROW = dict(n_hid=16)


def _overrides(phase):
    return TINY + PHASES[phase]


def _jitted_dvae_init(self, rng):
    """JAX's `DalleVAE.init_random` with each module's init under jit (the
    same draws; eagerly, the decoder's 8192-channel input costs seconds)."""
    r1, r2 = jax.random.split(rng)
    dummy = jnp.zeros((1, self.image_size, self.image_size, 3))
    self.encoder_params = jax.jit(self.encoder.init)(r1, dummy)["params"]
    grid = self.image_size // 8
    dummy_z = jnp.zeros((1, grid, grid, self.encoder.vocab_size))
    self.decoder_params = jax.jit(self.decoder.init)(r2, dummy_z)["params"]


def _jitted_init(init):
    """flax's `Module.init` under one jit (JAX's trainer initializes
    eagerly, op by op, which costs seconds of compiles), as
    `tests/test_torch_port_momentum.py` does."""
    jitted = jax.jit(lambda self, r, a, method: init(self, r, *a, method=method),
                     static_argnums=(0, 3))
    return lambda self, rngs, *args, method=None: jitted(self, rngs, args, method)


@pytest.fixture(autouse=True, scope="module")
def _setting():
    """Both packages' random dVAE at n_hid 16 (the inpainting trainer's
    MIM labels come from it; its full width costs seconds to build), JAX's
    inits jitted, and two torch threads (beside the other test processes,
    one thread per core oversubscribes the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdvae, "DalleEncoder", functools.partial(pdvae.DalleEncoder, **NARROW))
        mp.setattr(jdvae, "DalleEncoder", functools.partial(jdvae.DalleEncoder, **NARROW))
        mp.setattr(jdvae, "DalleDecoder", functools.partial(jdvae.DalleDecoder, **NARROW))
        mp.setattr(JaxTask, "init", _jitted_init(JaxTask.init))
        mp.setattr(jdvae.DalleVAE, "init_random", _jitted_dvae_init)
        yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("size,budget", [(2, 2), (14, 75), ((6, 9), 20), (14, 1)])
def test_maskers_match_jax(size, budget):
    """`RandomMaskingGenerator` and `RegionMaskingGenerator` give JAX's mask
    bit for bit from the same generator state, over 20 draws of one
    generator, and leave it in the same state. A region is one rectangle
    within the budget; its area is not asserted to reach it (ROADMAP C4:
    the draw favours thin regions)."""
    for pcls, jcls, arg in ((pmasking.RandomMaskingGenerator,
                             jmasking.RandomMaskingGenerator, min(budget, 4)),
                            (pmasking.RegionMaskingGenerator,
                             jmasking.RegionMaskingGenerator, budget)):
        mine, ref = pcls(size, arg), jcls(size, arg)
        prng, jrng = np.random.default_rng(3), np.random.default_rng(3)
        for _ in range(20):
            got, want = mine(prng), ref(jrng)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
        assert prng.integers(1 << 30) == jrng.integers(1 << 30)
    rows, cols = np.nonzero(got)
    assert 1 <= got.sum() <= max(1, budget)
    assert got.sum() == (np.ptp(rows) + 1) * (np.ptp(cols) + 1)


@pytest.mark.parametrize("phase", list(PHASES))
def test_synthetic_samples_match_jax(phase):
    """The port's `build_dataset` gives the samples of JAX's
    `MultiTaskData` for each phase, train and test split, bit for bit: the
    same keys (`label`, `image_labels_mpp`, `ref_box`, the region masks),
    drawn in JAX's order, dtypes and values."""
    cfg = _overrides(phase)
    data = MultiTaskData(jax_load_config(cfg))
    for split in ("train", "test"):
        mine = build_dataset(load_config(cfg), split)
        assert len(mine) == len(data.datasets[split]) == 4
        for i in range(len(mine)):
            got, want = mine[i], data.datasets[split][i]
            assert set(got) == set(want)
            for key, w in want.items():
                assert np.asarray(got[key]).dtype == np.asarray(w).dtype, key
                np.testing.assert_array_equal(got[key], w, err_msg=key)
    new = {"caption": set(), "vis": {"label"}, "ref": {"ref_box"},
           "inpainting": {"image4dalle_u8"}, "mpp": {"image_labels_mpp"}}[phase]
    assert new <= set(got)
    if phase == "inpainting":  # one rectangle a sample
        m = got["image_bool_masked_pos"].reshape(2, 2)
        rows, cols = np.nonzero(m)
        assert m.sum() == (np.ptp(rows) + 1) * (np.ptp(cols) + 1)
    if phase == "mpp":
        lab = got["image_labels_mpp"]
        masked = got["image_bool_masked_pos"] > 0
        assert (lab[~masked] == -100).all() and (lab[masked] >= 0).all()


# ----------------------------------------------------------- heads, losses


def _jittered(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + rng.normal(0, 0.05, x.shape).astype(np.float32),
        jax.device_get(tree))


@pytest.mark.parametrize("name", ["mpp", "imgcls", "ref"])
def test_heads_match_jax(name):
    """MPPHead, ImgClsHead and RefHead with flax's leaf names: outputs and
    the gradients of a weighted sum, for the input and every parameter,
    within 1e-5 relative to each array's largest magnitude (fp32 sums in
    another order)."""
    jmod, pmod = {
        "mpp": (jheads.MPPHead(dim=WIDTH, norm_eps=1e-12),
                pheads.MPPHead(WIDTH, 1e-12, torch.float32)),
        "imgcls": (jheads.ImgClsHead(num_classes=10), pheads.ImgClsHead(WIDTH, 10,
                                                                       torch.float32)),
        "ref": (jheads.RefHead(dim=WIDTH, norm_eps=1e-12),
                pheads.RefHead(WIDTH, 1e-12, torch.float32)),
    }[name]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, WIDTH) if name == "mpp" else (3, WIDTH)).astype(np.float32)
    params = _jittered(jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(x))["params"], 2)
    pmod.load_state_dict(from_flax_params(params), strict=True)
    out_shape = jax.eval_shape(lambda: jmod.apply({"params": params}, x)).shape
    w = rng.normal(size=out_shape).astype(np.float32)

    def f(p, xx):
        y = jmod.apply({"params": p}, xx)
        return (y * w).sum(), y

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pmod(xt)
    (got * torch.from_numpy(w)).sum().backward()
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(out_shape)

    def close(a, b, what):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max(), err_msg=what)

    close(got.detach().numpy(), want, "out")
    close(xt.grad.numpy(), gx, "input grad")
    for k, g in from_flax_params(jax.device_get(gp)).items():
        close(pmod.get_parameter(k).grad.numpy(), g.numpy(), k)
    if name == "ref":
        assert ((got > 0) & (got < 1)).all()


BOXES = {
    # JAX's own cases (tests/test_refcoco.py): identical, disjoint, half overlap
    "perfect": ([[0.5, 0.5, 0.4, 0.4]], [[0.5, 0.5, 0.4, 0.4]], True),
    "disjoint": ([[0.5, 0.5, 0.4, 0.4]], [[0.1, 0.1, 0.1, 0.1]], True),
    "half": ([[0.0, 0.0, 1.0, 1.0]], [[0.5, 0.0, 1.5, 1.0]], False),
    "random": (None, None, True),
}


@pytest.mark.parametrize("case", list(BOXES))
def test_box_iou_giou_matches_jax(case):
    """`box_iou_giou` (after `_cxcywh_to_xyxy` for cx-cy-w-h boxes) on
    JAX's perfect, disjoint and half-overlap cases and on 16 random pairs:
    IoU and GIoU, and their gradients for the first boxes, within 1e-5."""
    a, b, cxcywh = BOXES[case]
    if a is None:
        rng = np.random.default_rng(4)
        a = np.concatenate([rng.uniform(0.2, 0.8, (16, 2)), rng.uniform(0.05, 0.4, (16, 2))], 1)
        b = np.concatenate([rng.uniform(0.2, 0.8, (16, 2)), rng.uniform(0.05, 0.4, (16, 2))], 1)
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)

    def jfn(x):
        if cxcywh:
            return jlosses.box_iou_giou(jlosses._cxcywh_to_xyxy(x), jlosses._cxcywh_to_xyxy(b))
        return jlosses.box_iou_giou(x, b)

    jiou, jgiou = jax.jit(jfn)(a)
    gi = jax.jit(jax.grad(lambda x: (jfn(x)[0] + 2 * jfn(x)[1]).sum()))(a)
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b)
    if cxcywh:
        iou, giou = plosses.box_iou_giou(plosses._cxcywh_to_xyxy(at),
                                         plosses._cxcywh_to_xyxy(bt))
    else:
        iou, giou = plosses.box_iou_giou(at, bt)
    (iou + 2 * giou).sum().backward()
    np.testing.assert_allclose(iou.detach().numpy(), np.asarray(jiou), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(giou.detach().numpy(), np.asarray(jgiou), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(gi), rtol=1e-5, atol=1e-6)
    if case == "perfect":
        np.testing.assert_allclose(iou.detach().numpy(), [1.0], atol=1e-6)
        np.testing.assert_allclose(giou.detach().numpy(), [1.0], atol=1e-6)
    if case == "disjoint":
        assert float(iou[0]) == 0.0 and float(giou[0]) < 0.0
    if case == "half":
        np.testing.assert_allclose(iou.detach().numpy(), [1 / 3], atol=1e-6)


def _double(feats, batch_keys, heads):
    """Task doubles for the `compute_*` functions of both packages: `infer`
    returns the given features; the heads are the given functions."""
    jtask = SimpleNamespace(
        infer=lambda batch, infer_mode, mask_img=False, deterministic=True: feats["jax"],
        **heads["jax"])
    ptask = SimpleNamespace(
        infer=lambda batch, mode, mask_img=False, rng=None: feats["port"], **heads["port"])
    return jtask, ptask


@pytest.mark.parametrize("loss", ["mpp", "imgcls", "refcoco"])
def test_losses_match_jax(loss):
    """`compute_mpp`, `compute_imgcls` and `compute_refcoco` on the same
    features (a task double's `infer`) and targets: the loss and every
    metric, and the loss's gradient for the features, within 1e-5."""
    rng = np.random.default_rng(8)
    b = 4
    if loss == "mpp":
        x = rng.normal(0, 2, (b, 5, 768)).astype(np.float32)
        labels = rng.integers(0, 256, (b, 4, 3)).astype(np.int32)
        labels[rng.random((b, 4)) < 0.4] = -100
        batch = {"image_labels_mpp": labels}
        key, heads = "img_feats", {"jax": {"mpp_logits": lambda h: h},
                                   "port": {"mpp_logits": lambda h: h}}
    elif loss == "imgcls":
        x = rng.normal(0, 2, (b, 7)).astype(np.float32)
        batch = {"label": rng.integers(0, 7, b).astype(np.int32),
                 "text_ids": np.zeros((b, 3), np.int32)}
        key, heads = "cls_feats", {"jax": {"imgcls_logits": lambda h: h},
                                   "port": {"imgcls_logits": lambda h: h}}
    else:
        x = rng.normal(0, 1, (b, 4)).astype(np.float32)
        target = np.concatenate([rng.uniform(0.3, 0.7, (b, 2)), rng.uniform(0.1, 0.5, (b, 2))], 1)
        batch = {"ref_box": target.astype(np.float32)}
        key, heads = "cls_feats", {"jax": {"ref_box": jax.nn.sigmoid},
                                   "port": {"ref_box": torch.sigmoid}}
    fn = {"mpp": "compute_mpp", "imgcls": "compute_imgcls", "refcoco": "compute_refcoco"}[loss]

    def jloss(xx):
        jtask, _ = _double({"jax": {key: xx}, "port": None}, batch, heads)
        out = getattr(jlosses, fn)(jtask, {k: jnp.asarray(v) for k, v in batch.items()})
        return out[f"{loss}_task_loss"], out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    _, ptask = _double({"jax": None, "port": {key: xt}}, batch, heads)
    out = getattr(plosses, fn)(ptask, {k: torch.from_numpy(v) for k, v in batch.items()})
    out[f"{loss}_task_loss"].backward()
    assert set(out) == set(jout)
    for k in out:
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)
    if loss == "mpp":
        assert float(out["mpp_count"]) == (labels != -100).sum()


# -------------------------------------------------------------- the steps


def _parts(state):
    return jax.device_get({"params": state.params})


@functools.cache
def _runs(phase):
    """One step of JAX's Trainer and the port's from JAX's initial state on
    the port's first batch (the inpainting labels from JAX's dVAE in both),
    then `evaluate` on the val split in both: (JAX trainer, state before,
    state after, its metrics, its evaluation, the port's trainer, its
    metrics, its evaluation, the batch)."""
    import tempfile

    tmp = tempfile.mkdtemp()
    overrides = _overrides(phase) + STEP
    jtrainer = JaxTrainer(jax_load_config(overrides + [f"exp_dir={tmp}/jax"]))
    trainer = Trainer(load_config(overrides + [f"exp_dir={tmp}/port"]), device="cpu")
    batch = trainer.next_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jtrainer.init_state(jbatch)
    init = _parts(state)
    load_flax_train_state(trainer.state, init)
    labels = None
    if jtrainer.dvae is not None:
        image = jax_preprocess({k: v for k, v in jbatch.items() if k != "index"})["image4dalle"]
        labels = torch.from_numpy(np.array(jax.jit(jtrainer.dvae.get_codebook_indices)(image)))
    state, jm = jtrainer.make_train_step()(state, jbatch, jnp.asarray(0.0))
    pm = trainer.step(batch, mim_labels=labels)
    jeval = pev = None
    if phase == "ref":
        jeval = jtrainer.evaluate(state, jtrainer.data.val_loader())
        pev = trainer.evaluate()
    return jtrainer, init, jax.device_get(state), jax.device_get(jm), jeval, trainer, pm, pev


@pytest.mark.parametrize("phase", ["caption", "vis", "ref", "inpainting"])
def test_trainer_step_matches_jax(phase):
    """One `Trainer.step` from JAX's initial parameters against JAX's
    jitted `train_step`: every metric (the loss within 1e-5, grad_norm
    within 1e-4), and each trained parameter's change within rtol 1e-3
    plus 1e-3 of the leaf's largest change; the frozen leaves unmoved in
    both."""
    _, init, state, jm, _, trainer, pm, _ = _runs(phase)
    assert set(pm) == set(jm) and f"{LOSSES[phase]}_task_loss" in pm
    for k, w in jm.items():
        np.testing.assert_allclose(float(pm[k]), float(w), atol=1e-7, err_msg=k,
                                   rtol=1e-4 if k == "grad_norm" else 1e-5)
    want, before = from_flax_params(state.params), from_flax_params(init["params"])
    moved = 0
    for name, p in trainer.task.named_parameters():
        d_want = want[name].numpy() - before[name].numpy()
        d_got = p.detach().numpy() - before[name].numpy()
        if not p.requires_grad:
            assert not d_got.any() and not d_want.any(), name
            continue
        moved += bool(d_got.any())
        np.testing.assert_allclose(d_got, d_want, rtol=1e-3,
                                   atol=1e-3 * np.abs(d_want).max(), err_msg=name)
    assert moved > 0


def test_evaluate_matches_jax():
    """finetune_ref's `evaluate` after the step against JAX's
    `Trainer.evaluate` of the stepped state: the same keys, the loss, and
    `refcoco_mean_acc` and `refcoco_mean_score` weighed by
    `refcoco_count`, within 1e-5."""
    jeval, pev = _runs("ref")[4], _runs("ref")[7]
    assert set(pev) == set(jeval)
    for k, w in jeval.items():
        np.testing.assert_allclose(pev[k], w, rtol=1e-5, atol=1e-7, err_msg=k)
    assert {"refcoco_mean_score", "refcoco_mean_acc"} <= set(pev)


C9_FROZEN = {"transformer/patch_embed/weight", "transformer/pos_embed",
             "transformer/img_cls_token", "transformer/img_mask_token",
             "transformer/blocks_0/mlp_v/fc1/weight", "transformer/blocks_1/mlp_vl/fc1/weight",
             "transformer/pooler/dense/weight"}


@pytest.mark.parametrize("phase", list(PHASES))
def test_frozen_sets_match_jax(phase):
    """The trainer's frozen parameters are the leaves JAX's
    `phase_frozen_predicate` freezes for the phase. For finetune_caption
    (C9) that is the image side, the image mask token, the fused experts
    and the pooler in both packages, although its MLM runs the fused
    stream on image-text pairs; the other phases freeze the image mask
    token alone (MPP and inpainting: nothing of the image side)."""
    trainer = Trainer(load_config(_overrides(phase)), device="cpu")
    t = trainer.cfg["train"]
    args = (tuple(t["loss_names"]), t["phase"], t.get("mim_head_pos", "img"))
    jfrozen, pfrozen = joptim.phase_frozen_predicate(*args), poptim.phase_frozen_predicate(*args)
    named = {poptim.flax_path(n): p for n, p in trainer.task.named_parameters()}
    for path, p in named.items():
        want = jfrozen is not None and jfrozen(path)
        assert (pfrozen is not None and pfrozen(path)) == want, path
        assert p.requires_grad != want, path
    frozen = {p for p, v in named.items() if not v.requires_grad}
    if phase == "caption":
        assert C9_FROZEN <= frozen
        assert not any("mlp_l/" in p or "txt_embeddings" in p for p in frozen)
    elif phase in ("mpp", "inpainting"):  # the pooler alone
        assert frozen == {"transformer/pooler/dense/weight", "transformer/pooler/dense/bias"}
    else:
        assert frozen == {"transformer/img_mask_token"}


@pytest.mark.parametrize("phase", ["caption", "vis", "ref", "inpainting"])
def test_main_trains_each_phase(tmp_path, phase, monkeypatch):
    """`main` with `device=cpu` trains each newly registered phase for one
    epoch with its evaluation and checkpoint, dropout on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    off = ("model.attn_drop_rate", "model.drop_path_rate", "model.drop_rate")
    overrides = [x for x in _overrides(phase) if x.split("=")[0] not in off] + [
        "train.epochs=1", "device=cpu", f"output_dir={tmp_path}"]
    assert port_main(overrides) == 0
    exp = tmp_path / PHASES[phase][0].split("=")[1] / "vlmo_debug" / "default"
    (run,) = os.listdir(exp)
    assert os.path.isdir(exp / run / "checkpoint-0")
    (line,) = [json.loads(x) for x in open(exp / run / "log_stats.json")]
    assert all(np.isfinite(v) for v in line.values())
    assert f"val_{LOSSES[phase]}_task_loss" in line


@pytest.mark.parametrize("phase", list(PHASES))
def test_whole_task_losses_and_gradients_match_jax(phase):
    """The port's `VlmoTask.forward` against `jax.value_and_grad` of JAX's
    `VlmoTask.__call__` with JAX's initial parameters, every leaf jittered
    (so each conversion shows), on the second epoch's first batch: the loss within 1e-5 relative and every gradient within
    1e-5 relative L2 (a bias against its layer's weight gradient, whose sum
    over rows can cancel)."""
    cfg = load_config(_overrides(phase))
    loader = Loader(build_dataset(cfg), BATCH, seed=0)
    host = {k: v for k, v in next(loader.epoch(1)).items() if k != "index"}
    mb = {k: v.numpy() for k, v in preprocess_batch(
        {k: torch.from_numpy(v) for k, v in host.items()}).items()}
    if "image4dalle" in mb:
        mb["mim_labels"] = np.random.default_rng(2).integers(
            0, 8192, mb["image_bool_masked_pos"].shape).astype(np.int32)
    jb = {k: jnp.asarray(v) for k, v in mb.items()}
    jtask = jax_build_model(jax_load_config(_overrides(phase)))
    params = _jittered(jtask.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                                  jb, method=JaxTask.init_streams)["params"], 5)

    def loss_fn(p):
        out = jtask.apply({"params": p}, jb, deterministic=True,
                          rngs={"sample": jax.random.key(2)})
        return jax_total_loss(out)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    task = VlmoTask(VlmoConfig.from_config(cfg))
    task.load_state_dict(from_flax_params(params), strict=True)
    loss = total_loss(task({k: torch.from_numpy(v) for k, v in mb.items()}))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, err_msg=phase)
    want = from_flax_params(jax.device_get(jg))
    for name, p in task.named_parameters():
        w = want[name].numpy()
        if p.grad is None:
            assert not w.any(), (phase, name)
            continue
        scale = np.linalg.norm(w)
        weight = name[: -len("bias")] + "weight"
        if name.endswith(".bias") and weight in want:
            scale = max(scale, np.linalg.norm(want[weight].numpy()))
        err = np.linalg.norm(p.grad.numpy() - w) / max(scale, 1e-30)
        assert err <= 1e-5, (phase, name, err)
