"""Configuration: presets as Python dicts, `group=name` / `a.b=value` overrides.

Counterpart of `exploremultimodal_tpu/config` + `configs/*.yaml` and of
`VlmoConfig` in `exploremultimodal_tpu/models/task.py`. The presets are plain
dicts, copied from the YAML files, because the serving machine has no PyYAML;
`tests/test_torch_port_ops.py` holds each one equal to what the JAX loader
reads. Every model and train preset of the YAML is here, and the base
keys the serving path, the training step and the run around it (the
directories, evaluation, throughput mode, logging) read. Keys the JAX code
reads with a default (`data.synthetic_size`, `train.mlm_gather_cap`,
`train.resume_sha256`, ...) are read with the same default here.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Iterable

import torch

# `model.quantize` values (exploremultimodal_tpu/ops/quant.py `dense` and
# `site_mode`); any other raises, as JAX's `dense` does
QUANTIZE_MODES = ("none", "w8a8", "w8a8_pallas", "w8a8_pallas_mlp",
                  "w8a8_pallas_noproj")

# base.yaml: the keys the serving path, the training step and the run
# around it read (data.img_size and data.patch_size are the model's, as
# base.yaml's interpolations make them; wandb.name is `${tag}` there, and
# `load_config` resolves it the same way)
BASE: dict[str, Any] = {
    "data": {
        "batch_size": 256,
        "eval_batch_size": None,
        "mask_style": "block",
        "num_mask_patches": 75,
        "max_mask_patches_per_block": None,
        "min_mask_patches_per_block": 16,
        "tokenizer": "bert-base-uncased",
        "tokenizer_dir": "resource",
        "whole_word_masking": True,
        "mlm_prob": 0.15,
        "vqav2_label_size": 3129,
    },
    "wandb": {
        "enable": False,
        "project": "vlmo_tpu",
        "mode": "offline",
        "name": "${tag}",
        "alert": False,
        "watch": False,
    },
    "exp_dir": None,
    "run_dir": None,
    "output_dir": "output",
    "tag": "default",
    "seed": 0,
    "eval_mode": False,
    "throughput_mode": False,
    "log_level": "info",
    "compute_dtype": "bfloat16",
    "vlmo_ema": False,
    "vlmo_ema_decay": 0.995,
    "model_ema": False,
    "model_ema_decay": 0.9999,
    "minimize_metric": None,
    "attn_impl": "auto",
    "profile_steps": 0,
}

_MODEL_COMMON: dict[str, Any] = {
    "type": "VLMO",
    "itc_temp": 0.07,
    "itc_dim": 256,
    "img_vocab_size": 8192,
    "vocab_size": 30522,
    "max_text_len": 40,
    "img_size": 224,
    "patch_size": 16,
    "in_chans": 3,
    "num_classes": 0,
    "mlp_ratio": 4.0,
    "qkv_bias": True,
    "drop_rate": 0.1,
    "attn_drop_rate": 0.1,
    "drop_path_rate": 0.1,
    "norm_eps": 1e-12,
    "init_values": 0.1,
}


def _model(name: str, embed_dim: int, depth: int, num_heads: int,
           fusion_layer: int, **extra) -> dict[str, Any]:
    return {**_MODEL_COMMON, "name": name, "embed_dim": embed_dim, "depth": depth,
            "num_heads": num_heads, "fusion_layer": fusion_layer, **extra}


# configs/model/*.yaml. Rows 6 and 7 (`mlp_impl: fused` on the card) are
# built at width 768 only: vlmo_tiny and vlmo_small under `fused` raise at
# the kernel's shape check on the card (ops/mlp_fused.py `OUT_DIMS`);
# vlmo_large and vlmo_huge fail `fits_vmem` and take the plain chain, as in
# JAX
MODEL_PRESETS: dict[str, dict[str, Any]] = {
    "vlmo_tiny": _model("vlmo_tiny", 192, 12, 3, 6),
    "vlmo_small": _model("vlmo_small", 384, 12, 6, 6),
    "vlmo_base": _model("vlmo_base", 768, 12, 12, 6, quantize="none", mlp_impl="xla"),
    "vlmo_large": _model("vlmo_large", 1024, 24, 16, 12, init_values=1e-5),
    "vlmo_huge": _model("vlmo_huge", 1024, 24, 16, 12, init_values=1e-5),
    "vlmo_debug": _model("vlmo_debug", 96, 2, 3, 1),
}


def _train(phase: str, loss_names: list[str], datasets: list[str], *,
           base_lr: float = 3.0e-6, lr_mult_head: float = 50,
           lr_mult_fusion: float = 5, warmup_steps: int = 2500,
           **extra) -> dict[str, Any]:
    """A configs/train/*.yaml: the phase's own keys over the schedule,
    optimizer and run keys every train preset carries."""
    return {
        "phase": phase,
        "loss_names": loss_names,
        "datasets": datasets,
        **extra,
        "start_epoch": 0,
        "epochs": 10,
        "cur_epoch": 0,
        "warmup_epochs": 3,
        "warmup_steps": warmup_steps,
        "weight_decay": 0.01,
        "weight_decay_end": 0.01,
        "base_lr": base_lr,
        "warmup_lr": 5.0e-7,
        "min_lr": 5.0e-6,
        "lr_mult_head": lr_mult_head,
        "lr_mult_fusion": lr_mult_fusion,
        "flat_loss": False,
        "clip_grad": None,
        "auto_resume": True,
        "resume": "",
        "accumulation_steps": 1,
        "save_freq": 1,
        "print_freq": 300,
        "print_stat_level": 2,
        "lr_scheduler": {"name": "linear", "decay_epochs": 30, "decay_rate": 0.1},
        "opt": {"name": "adamw", "eps": 1.0e-8, "betas": [0.9, 0.98],
                "momentum": 0.9},
    }


_PRETRAIN = {"base_lr": 2.0e-4, "lr_mult_head": 1, "lr_mult_fusion": 1}
_DALLE = {"discrete_vae_weight_path": "weight/dalle/", "discrete_vae_type": "dall-e"}

# configs/train/*.yaml, whole
TRAIN_PRESETS: dict[str, dict[str, Any]] = {
    "pretrain_mum": _train(
        "pretrain_mum", ["mlm", "itc", "itm", "mim"],
        ["vg", "coco", "gcc", "sbu", "f30k"], **_PRETRAIN,
        global_reduce=False, neg_queue=False, queue_size=65536, **_DALLE,
        mim_head_pos="img"),
    # text-only MLM; BERT-length text with model.max_text_len=512; the
    # shared attention and norms at 0x lr: the 'l' experts train
    "pretrain_txt": _train(
        "pretrain_txt", ["mlm"], ["book", "wiki"], base_lr=2.0e-4,
        lr_mult_head=5, lr_mult_fusion=5, warmup_steps=10000, fixed_attn=True),
    "pretrain_vis": _train(
        "pretrain_vis", ["mim"], ["coco", "vg", "gcc", "sbu", "f30k"], **_PRETRAIN,
        **_DALLE, mim_head_pos="img"),
    # kl_alpha: R-Drop (a second stochastic forward + symmetric KL);
    # isda_lambda: implicit semantic data augmentation
    "finetune_vqa": _train("finetune_vqa", ["vqa"], ["vqa"], kl_alpha=0.0,
                           isda_lambda=0),
    "finetune_nlvr2": _train("finetune_nlvr2", ["nlvr2"], ["nlvr2"]),
    "finetune_retrieval": _train("finetune_retrieval", ["itc", "irtr"], ["coco"],
                                 draw_false_text=3),
    "finetune_caption": _train("finetune_caption", ["mlm"], ["coco"]),
    "finetune_ref": _train("finetune_ref", ["refcoco"], ["refcoco"]),
    "finetune_inpainting": _train("finetune_inpainting", ["mim"], ["coco"],
                                  mim_head_pos="mum"),
    "finetune_vis": _train("finetune_vis", ["imgcls"], ["imgcls"]),
}

_PRESETS = {"model": MODEL_PRESETS, "train": TRAIN_PRESETS}
# base.yaml's defaults
DEFAULT_GROUPS = {"model": "vlmo_debug", "train": "pretrain_mum"}


def parse_value(text: str) -> Any:
    """An override value with the YAML scalar rules the configs use."""
    s = text.strip()
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "~", "none", ""):
        return None
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [parse_value(p) for p in inner.split(",")] if inner else []
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def load_config(overrides: Iterable[str] = ()) -> dict[str, Any]:
    """Compose base + model + train presets, then dotted leaf overrides.

    `model=vlmo_base` / `train=finetune_vqa` pick a preset; `a.b.c=value`
    sets a leaf, as `exploremultimodal_tpu.config.load_config` does.
    """
    groups = dict(DEFAULT_GROUPS)
    leaves: list[tuple[str, Any]] = []
    for ov in overrides:
        key, sep, raw = ov.partition("=")
        if not sep:
            raise ValueError(f"override {ov!r} must be key=value")
        key = key.strip()
        if key in _PRESETS:
            groups[key] = raw.strip()
        else:
            leaves.append((key, parse_value(raw)))

    cfg = copy.deepcopy(BASE)
    for group, name in groups.items():
        presets = _PRESETS[group]
        if name not in presets:
            raise ValueError(
                f"no {group} preset {name!r}; available: {sorted(presets)}")
        cfg[group] = copy.deepcopy(presets[name])
    for key, value in leaves:
        node = cfg
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    if cfg["wandb"].get("name") == "${tag}":
        cfg["wandb"]["name"] = cfg["tag"]
    return cfg


@dataclasses.dataclass(frozen=True)
class VlmoConfig:
    """Static model + task configuration (the subset of the JAX VlmoConfig
    that serving and the ported phases read, same field names and
    defaults; `train.draw_false_text` is read by the dataset, as in JAX)."""

    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    drop_rate: float = 0.1
    attn_drop_rate: float = 0.1
    drop_path_rate: float = 0.1
    norm_eps: float = 1e-12
    init_values: float | None = 0.1
    vocab_size: int = 30522
    max_text_len: int = 40
    fusion_layer: int = 6
    img_vocab_size: int = 8192
    itc_dim: int = 256
    itc_temp: float = 0.07
    phase: str | None = None
    loss_names: tuple[str, ...] = ()
    vqa_label_size: int = 3129
    mim_head_pos: str = "img"
    global_reduce: bool = False
    mlm_gather_cap: float = 0.375
    mim_gather_cap: float = 0.4
    dtype_name: str = "float32"
    attn_impl: str = "xla"
    quantize: str = "none"
    mlp_impl: str = "xla"
    kl_alpha: float = 0.0
    isda_lambda: float = 0.0

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    @classmethod
    def from_config(cls, cfg: dict[str, Any]) -> "VlmoConfig":
        m, t = cfg["model"], cfg["train"]
        quantize = str(m.get("quantize") or "none")  # `=none` parses as None
        if quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown model.quantize={quantize!r} "
                             f"({'|'.join(QUANTIZE_MODES)})")
        return cls(
            img_size=m["img_size"],
            patch_size=m["patch_size"],
            embed_dim=m["embed_dim"],
            depth=m["depth"],
            num_heads=m["num_heads"],
            mlp_ratio=float(m["mlp_ratio"]),
            drop_rate=m["drop_rate"],
            attn_drop_rate=m["attn_drop_rate"],
            drop_path_rate=m["drop_path_rate"],
            norm_eps=m.get("norm_eps", 1e-12),
            init_values=m["init_values"],
            vocab_size=m["vocab_size"],
            max_text_len=m["max_text_len"],
            fusion_layer=m["fusion_layer"],
            img_vocab_size=m["img_vocab_size"],
            itc_dim=m["itc_dim"],
            itc_temp=m["itc_temp"],
            phase=t["phase"],
            loss_names=tuple(t["loss_names"]),
            vqa_label_size=cfg["data"].get("vqav2_label_size", 3129),
            mim_head_pos=t.get("mim_head_pos", "img"),
            global_reduce=bool(t.get("global_reduce", False)),
            mlm_gather_cap=float(t.get("mlm_gather_cap", 0.375)),
            mim_gather_cap=float(t.get("mim_gather_cap", 0.4)),
            dtype_name=cfg.get("compute_dtype", "float32"),
            attn_impl=cfg.get("attn_impl", "xla"),
            quantize=quantize,
            mlp_impl=str(m.get("mlp_impl", "xla")),
            kl_alpha=float(t.get("kl_alpha", 0.0)),
            isda_lambda=float(t.get("isda_lambda", 0.0)),
        )
