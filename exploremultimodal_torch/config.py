"""Configuration: presets as Python dicts, `group=name` / `a.b=value` overrides.

Counterpart of `exploremultimodal_tpu/config` + `configs/*.yaml` and of
`VlmoConfig` in `exploremultimodal_tpu/models/task.py`. The presets are plain
dicts, copied from the YAML files, because the serving machine has no PyYAML;
`tests/test_torch_port_ops.py` holds each one equal to what the JAX loader
reads. Only the presets and keys the VQA serving path and the pretrain_mum
and finetune_vqa training steps read are here. Keys the JAX code reads with a default
(`data.synthetic_size`, `train.mlm_gather_cap`, ...) are read with the same
default here.
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

# base.yaml: the keys the serving path and the training step read
# (data.img_size and data.patch_size are the model's, as base.yaml's
# interpolations make them)
BASE: dict[str, Any] = {
    "data": {
        "batch_size": 256,
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
    "seed": 0,
    "compute_dtype": "bfloat16",
    "vlmo_ema": False,
    "model_ema": False,
    "attn_impl": "auto",
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

MODEL_PRESETS: dict[str, dict[str, Any]] = {
    # configs/model/vlmo_base.yaml
    "vlmo_base": {
        **_MODEL_COMMON,
        "name": "vlmo_base",
        "embed_dim": 768,
        "depth": 12,
        "num_heads": 12,
        "fusion_layer": 6,
        "quantize": "none",
        "mlp_impl": "xla",
    },
    # configs/model/vlmo_debug.yaml
    "vlmo_debug": {
        **_MODEL_COMMON,
        "name": "vlmo_debug",
        "embed_dim": 96,
        "depth": 2,
        "num_heads": 3,
        "fusion_layer": 1,
    },
}

# configs/train/*.yaml, whole
TRAIN_PRESETS: dict[str, dict[str, Any]] = {
    "finetune_vqa": {
        "phase": "finetune_vqa",
        "loss_names": ["vqa"],
        "datasets": ["vqa"],
        "kl_alpha": 0.0,  # R-Drop: a second stochastic forward + symmetric KL
        "isda_lambda": 0,  # implicit semantic data augmentation
        "start_epoch": 0,
        "epochs": 10,
        "cur_epoch": 0,
        "warmup_epochs": 3,
        "warmup_steps": 2500,
        "weight_decay": 0.01,
        "weight_decay_end": 0.01,
        "base_lr": 3.0e-6,
        "warmup_lr": 5.0e-7,
        "min_lr": 5.0e-6,
        "lr_mult_head": 50,
        "lr_mult_fusion": 5,
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
    },
    "pretrain_mum": {
        "phase": "pretrain_mum",
        "loss_names": ["mlm", "itc", "itm", "mim"],
        "datasets": ["vg", "coco", "gcc", "sbu", "f30k"],
        "global_reduce": False,
        "neg_queue": False,
        "queue_size": 65536,
        "discrete_vae_weight_path": "weight/dalle/",
        "discrete_vae_type": "dall-e",
        "mim_head_pos": "img",
        "start_epoch": 0,
        "epochs": 10,
        "cur_epoch": 0,
        "warmup_epochs": 3,
        "warmup_steps": 2500,
        "weight_decay": 0.01,
        "weight_decay_end": 0.01,
        "base_lr": 2.0e-4,
        "warmup_lr": 5.0e-7,
        "min_lr": 5.0e-6,
        "lr_mult_head": 1,
        "lr_mult_fusion": 1,
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
    },
    # text-only MLM; BERT-length text with model.max_text_len=512
    "pretrain_txt": {
        "phase": "pretrain_txt",
        "loss_names": ["mlm"],
        "datasets": ["book", "wiki"],
        "fixed_attn": True,  # shared attention and norms at 0x lr: the 'l' experts train
        "start_epoch": 0,
        "epochs": 10,
        "cur_epoch": 0,
        "warmup_epochs": 3,
        "warmup_steps": 10000,
        "weight_decay": 0.01,
        "weight_decay_end": 0.01,
        "base_lr": 2.0e-4,
        "warmup_lr": 5.0e-7,
        "min_lr": 5.0e-6,
        "lr_mult_head": 5,
        "lr_mult_fusion": 5,
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
    },
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
    return cfg


@dataclasses.dataclass(frozen=True)
class VlmoConfig:
    """Static model + task configuration (the subset of the JAX VlmoConfig
    that serving, pretrain_mum and finetune_vqa read, same field names and
    defaults)."""

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
