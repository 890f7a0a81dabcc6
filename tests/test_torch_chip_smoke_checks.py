"""`chip_smoke.py`'s training comparison (`compare_step`), on the CPU.

On the card the script steps a CUDA trainer beside a CPU one; here a second
CPU trainer at vlmo_debug size stands in for the card. The tests show that
the check of `itc_temp`'s gradient, taken at the card's own ITC features,
passes a sound step and refuses a wrong gradient, and that its closed form
is the gradient autograd gives.
"""

import copy

import pytest
import torch

import chip_smoke
from exploremultimodal_torch.config import load_config
from exploremultimodal_torch.train.trainer import Trainer

OVERRIDES = [
    "model=vlmo_debug", "train=pretrain_mum", "compute_dtype=bfloat16",
    "train.datasets=[synthetic]", "train.discrete_vae_type=random",
    "data.batch_size=2", "model.drop_rate=0.0", "model.drop_path_rate=0.0",
]
NAMES = ("transformer.blocks.0.attn.qkv.weight", "itc_temp")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads while this file runs, the count restored after:
    beside the other test processes, one thread per core oversubscribes
    the cores and the bf16 steps here slow down tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base():
    """One seeded trainer and a batch; each test steps copies of the
    trainer, taken before its loader started (a generator cannot be
    copied)."""
    trainer = Trainer(load_config(OVERRIDES), device="cpu")
    return copy.deepcopy(trainer), trainer.next_batch()


def _step_kw(trainer, batch):
    b = 2
    return {"negatives": (torch.arange(1, b + 1) % b, torch.arange(b - 1, 2 * b - 1) % b),
            "mim_labels": trainer.model_batch(batch)["mim_labels"]}


@pytest.mark.parametrize("factor", [1.0, 2.0, 0.5, -1.0, 100.0])
def test_compare_step_refuses_a_scaled_itc_temp_gradient(monkeypatch, base, factor):
    """The stand-in's itc_temp gradient scaled by `factor` (1: a sound
    step) is held within GRAD_REL_TOL: every scale of 2, 1/2, -1 or 100
    fails, and the same step passes."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    (card, cpu), batch = (copy.deepcopy(base[0]) for _ in range(2)), base[1]
    card.task.itc_temp.register_hook(lambda g: g * factor)
    kw = _step_kw(cpu, batch)
    if factor == 1.0:
        result = chip_smoke.compare_step("t", card, cpu, batch, NAMES, **kw)
        assert result["itc_temp"]["grad_rel_err_at_gpu_features"] == 0.0
        assert result["itc_temp"]["feature_rel_err"] == 0.0
    else:
        with pytest.raises(RuntimeError, match="gradients differ"):
            chip_smoke.compare_step("t", card, cpu, batch, NAMES, **kw)


def test_itc_temp_closed_form_is_the_autograd_gradient(base):
    """pretrain_mum clips nothing and weighs ITC by 1, so the closed form
    from the step's own ITC features is itc_temp's gradient, up to the fp32
    rounding of a sum that cancels (well within GRAD_REL_TOL)."""
    trainer, batch = copy.deepcopy(base[0]), base[1]
    feats = {}
    trainer.task.itc_head.register_forward_hook(
        lambda mod, args, out: feats.__setitem__(args[1], out.detach().double()))
    log_temp = float(trainer.task.itc_temp)
    trainer.step(batch, **_step_kw(trainer, batch))
    want = chip_smoke.itc_temp_closed_form(feats, log_temp)
    got = float(trainer.task.itc_temp.grad)
    assert want != 0.0 and abs(got - want) <= 1e-2 * abs(want)


RETRIEVAL = [o for o in OVERRIDES if not o.startswith("train=")] + ["train=finetune_retrieval"]
RETRIEVAL_NAMES = ("transformer.patch_embed.weight", "transformer.blocks.0.attn.qkv.weight",
                   "itc_head.dense_v.weight", "rank_output.fc.weight")


@pytest.mark.parametrize("fed", [True, False])
def test_compare_step_feeds_the_cpu_itc_feature_gradient(monkeypatch, fed):
    """finetune_retrieval's check: with `itc_grad_from_cpu` the card's
    backward takes the CPU's gradient at the ITC features, so a card whose
    own gradient there is off (scaled by 3 here) still has its towers'
    backward held, and that error is reported; without it the same card is
    refused."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    trainer = Trainer(load_config(RETRIEVAL), device="cpu")
    card, cpu = copy.deepcopy(trainer), copy.deepcopy(trainer)
    batch = trainer.next_batch()

    def off_by_3(mod, args, out):
        out.register_hook(lambda g: g * 3.0)

    card.task.itc_head.register_forward_hook(off_by_3)
    if fed:
        result = chip_smoke.compare_step("t", card, cpu, batch, RETRIEVAL_NAMES,
                                         itc_grad_from_cpu=True)
        assert max(result["grad_rel_err"].values()) == 0.0
        assert result["own_feature_grad_rel_err"] == pytest.approx({"v": 2.0, "l": 2.0}, rel=1e-2)
    else:
        with pytest.raises(RuntimeError, match="gradients differ"):
            chip_smoke.compare_step("t", card, cpu, batch, RETRIEVAL_NAMES)


# phase 23's comparison: pretrain_mum's recipe (momentum encoder, a queue of
# 16 columns, the eval EMA) at accumulation_steps=2, two microbatches of 2
MOMENTUM = OVERRIDES + ["vlmo_ema=true", "train.neg_queue=true", "train.queue_size=16",
                        "model_ema=true", "train.accumulation_steps=2", "data.batch_size=4"]


@pytest.fixture(scope="module")
def momentum_base():
    trainer = Trainer(load_config(MOMENTUM), device="cpu")
    return copy.deepcopy(trainer), trainer.next_batch()


def test_momentum_itc_temp_grad_is_the_autograd_gradient(momentum_base):
    """`momentum_itc_temp_grad`, from the step's own features (both
    microbatches' globals, the momentum features and the queue it
    contrasted them with), is itc_temp's gradient autograd gives, up to
    the fp32 rounding of the step's sums."""
    trainer, batch = copy.deepcopy(momentum_base[0]), momentum_base[1]
    feats, branches = {}, {}
    trainer.task.itc_head.register_forward_hook(
        lambda mod, args, out: feats.setdefault(args[1], []).append(out.detach().double()))
    chip_smoke.record_momentum_branch(trainer, branches, "cpu")
    log_temp = float(trainer.task.itc_temp)
    trainer.step(batch)
    assert len(feats["v"]) == len(feats["l"]) == 2
    want = chip_smoke.momentum_itc_temp_grad(feats, branches["cpu"], log_temp)
    got = float(trainer.task.itc_temp.grad)
    assert want != 0.0 and abs(got - want) <= 1e-3 * abs(want)


@pytest.mark.parametrize("factor", [1.0, 2.0])
def test_compare_step_holds_the_momentum_step(monkeypatch, momentum_base, factor):
    """Phase 23's comparison on a stand-in card: a sound step passes with
    itc_temp held at each device's own momentum features; the card's
    itc_temp gradient doubled fails."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    (card, cpu), batch = (copy.deepcopy(momentum_base[0]) for _ in range(2)), momentum_base[1]
    card.task.itc_temp.register_hook(lambda g: g * factor)
    branches = {}
    for d, tr in (("gpu", card), ("cpu", cpu)):
        chip_smoke.record_momentum_branch(tr, branches, d)
    kw = {"negatives": (torch.tensor([1, 0]), torch.tensor([1, 0])),
          "itc_temp_grad": lambda d, f, lt: chip_smoke.momentum_itc_temp_grad(
              f, branches[d], lt)}
    if factor == 1.0:
        result = chip_smoke.compare_step("t", card, cpu, batch, NAMES, **kw)
        assert result["itc_temp"]["grad_rel_err_at_gpu_features"] == 0.0
        assert "i2i_l_Loss" in result["losses_gpu_cpu"]
    else:
        with pytest.raises(RuntimeError, match="gradients differ"):
            chip_smoke.compare_step("t", card, cpu, batch, NAMES, **kw)


def test_momentum_feature_gaps_read_the_devices_and_the_controls(monkeypatch,
                                                                momentum_base):
    """`momentum_feature_gaps` on a stand-in card: the momentum tree drawn
    anew from each seed on both trainers, so two CPU trainers read a gap
    of exactly 0; each control (the momentum forward with its attention
    dropout on, the tree's weights rounded to e4m3) reads a gap."""
    monkeypatch.setattr(chip_smoke, "MOMENTUM_GAP_SEEDS", (1, 2))
    card, cpu = (copy.deepcopy(momentum_base[0]) for _ in range(2))
    labels = cpu.model_batch(momentum_base[1])["mim_labels"]
    gaps = chip_smoke.momentum_feature_gaps(card, cpu, labels)
    assert set(gaps) == {"seed_1", "seed_2"}
    for g in gaps.values():
        assert g["gap"] == {"img_queue": 0.0, "txt_queue": 0.0}
        assert min(g["dropout"].values()) > 0.0 and min(g["e4m3_weights"].values()) > 0.0
    assert "infer" not in vars(card.state.ema_task)


def test_alternated_steps_time_both_trainers_in_turn(monkeypatch, momentum_base, base):
    """`alternated_steps` steps the recipe and plain pretrain_mum in turn,
    after a warm-up step of each: one time per step, and the added time
    of each pair."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "ALTERNATED_PAIRS", 2)
    recipe, plain = copy.deepcopy(momentum_base[0]), copy.deepcopy(base[0])
    out = chip_smoke.alternated_steps(recipe, plain)
    assert recipe.state.step == plain.state.step == 3
    assert all(len(v) == 2 for v in out["ms_per_step"].values())
    assert out["pairs"] == 2 and len(out["added_ms_per_step_quartiles"]) == 2


# ------------------------------------------------- caption and inpaint serving

SERVE_TINY = ["model=vlmo_debug", "model.img_size=32", "model.embed_dim=32",
              "model.num_heads=2", "model.max_text_len=10", "compute_dtype=float32"]


def _predictor(train, seed=0, jitter=0.0):
    from exploremultimodal_torch.infer import Predictor
    from exploremultimodal_torch.models import build_model

    cfg = load_config(SERVE_TINY + [f"train={train}"])
    state = build_model(cfg, device="cpu", seed=seed).state_dict()
    gen = torch.Generator().manual_seed(1)
    state = {k: v + jitter * torch.randn(v.shape, generator=gen) if v.is_floating_point()
             else v for k, v in state.items()}
    return Predictor(cfg, state, device="cpu")


def _images(n):
    import numpy as np

    return np.random.default_rng(3).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


@pytest.mark.parametrize("n_iter", [1, 3])
def test_serving_launch_formulas_count_the_blocks(monkeypatch, n_iter):
    """`caption_launches` (f + n_iter d) and `inpaint_launches` (f + d) are
    the blocks a `caption_ids` and an `inpaint_ids` request run, each block
    one attention and one FFN call: counted here by wrapping
    `Block.forward` on the CPU."""
    import functools

    from exploremultimodal_torch.config import VlmoConfig
    from exploremultimodal_torch.models import dvae, vlmo

    monkeypatch.setattr(dvae, "DalleEncoder", functools.partial(dvae.DalleEncoder, n_hid=16))
    monkeypatch.setattr(dvae, "DalleDecoder", functools.partial(dvae.DalleDecoder, n_hid=16,
                                                                n_init=8))
    calls = []
    forward = vlmo.Block.forward
    monkeypatch.setattr(vlmo.Block, "forward",
                        lambda self, *a, **k: calls.append(1) or forward(self, *a, **k))
    cap = _predictor("finetune_caption")
    cfg = VlmoConfig.from_config(cap.cfg)
    ids, mask = chip_smoke.caption_rows(2, 10, tokens=6)
    cap.caption_ids(_images(2), ids, mask, n_iter, chip_smoke.MASK_ID)
    assert len(calls) == chip_smoke.caption_launches(cfg, n_iter) \
        == cfg.fusion_layer + n_iter * cfg.depth
    calls.clear()
    inp = _predictor("finetune_inpainting")
    inp.inpaint_ids(_images(2), [[1, 0, 0, 1], [0, 1, 0, 0]], ids, mask)
    assert len(calls) == chip_smoke.inpaint_launches(cfg) == cfg.fusion_layer + cfg.depth


def test_caption_teacher_forcing_holds_the_rule_to_the_cards_logits(monkeypatch):
    """`caption_teacher_forced` with a CPU predictor standing in for the
    card: against itself every iteration's logits agree exactly, the next
    ids follow the keep/re-mask rule and the replay ends in `caption_ids`'s
    ids; with jittered weights on the stand-in the logits differ and the
    rule still holds (it is applied to the card's own logits); a card that
    keeps one position more than the rule at every iteration is caught."""
    import numpy as np

    cpu = _predictor("finetune_caption")
    ids, mask = chip_smoke.caption_rows(3, 10, tokens=6)
    img = _images(3)
    same = chip_smoke.caption_teacher_forced(cpu, cpu, img, ids, mask, 3, 2)
    assert same["logit_err"] == [0.0] * 3 and all(same["rule_equal"])
    np.testing.assert_array_equal(same["ids"], cpu.caption_ids(img, ids, mask, 3,
                                                                chip_smoke.MASK_ID))
    other = _predictor("finetune_caption", jitter=1e-3)
    near = chip_smoke.caption_teacher_forced(other, cpu, img, ids, mask, 3, 2)
    assert min(near["logit_err"]) > 0 and all(near["rule_equal"])
    step, seen = chip_smoke.mask_predict_step, []

    def card_keeps_one_more(logits, ids_, gen, n_gen, it, n_iter, mask_id):
        seen.append(1)
        if len(seen) % 2:  # the card's call; the rule's on the CPU follows it
            return step(logits, ids_, gen, n_gen + 1, it, n_iter, mask_id)
        return step(logits, ids_, gen, n_gen, it, n_iter, mask_id)

    monkeypatch.setattr(chip_smoke, "mask_predict_step", card_keeps_one_more)
    bad = chip_smoke.caption_teacher_forced(cpu, cpu, img, ids, mask, 3, 2)
    assert not all(bad["rule_equal"])
