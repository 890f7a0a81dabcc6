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
