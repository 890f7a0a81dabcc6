"""BEiT and VLMo `.pth` state dicts onto the port's `VlmoTask` (counterpart
of `exploremultimodal_tpu/models/import_torch.py`).

  detect_beit             a BEiT checkpoint has no `.mlp.{v,l,vl}` keys
  beit_to_vlmo_names      `.mlp.` -> the vision expert, cls_token ->
                          img_cls_token, mask_token -> img_mask_token,
                          lm_head -> the MIM head
  normalize_legacy_names  `.mlp.{v,l,vl}_mlp` -> `.mlp.{v,l,vl}`
  interpolate_pos_embed   bicubic resize of the patch grid, the CLS row kept
                          (the same weights as `jax.image.resize`'s
                          antialiased Keys cubic), and the text position
                          table cut to `max_text_len`

The torch names map onto the flax paths of the JAX table, and those onto
the port's names as `models.convert` renames them. The torch layouts
(Linear (out, in), Conv OIHW) are the port's, so no tensor is transposed.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch


def _to_np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def detect_beit(state: Mapping[str, Any]) -> bool:
    return not any(".mlp.v" in k or ".mlp.l" in k or ".mlp.vl" in k for k in state)


def normalize_legacy_names(state: Mapping[str, Any]) -> dict:
    """`.mlp.{v,l,vl}_mlp` -> `.mlp.{v,l,vl}`."""
    out = {}
    for k, v in state.items():
        for old, new in ((".mlp.v_mlp", ".mlp.v"), (".mlp.l_mlp", ".mlp.l"),
                         (".mlp.vl_mlp", ".mlp.vl")):
            if old in k:
                k = k.replace(old, new)
        out[k] = v
    return out


def beit_to_vlmo_names(state: Mapping[str, Any]) -> dict:
    out = {}
    for k, v in state.items():
        if ".mlp." in k:
            k = k.replace(".mlp.", ".mlp.v.")
        if "cls_token" in k and "img_cls_token" not in k:
            k = k.replace("cls_token", "img_cls_token")
        if "mask_token" in k and "img_mask_token" not in k:
            k = k.replace("mask_token", "img_mask_token")
        if "lm_head" in k:
            k = k.replace("lm_head", "mim_head.fc")
        out[k] = v
    return out


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) fp32 weights of an antialiased Keys-cubic resize."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x.astype(f32)).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def interpolate_pos_embed(pos: np.ndarray, target_len: int) -> np.ndarray:
    """(1, 1 + g^2, D) -> (1, target_len, D): the CLS row kept, the g x g
    patch grid resized bicubically to the target's grid."""
    if pos.shape[1] == target_len:
        return pos
    orig = int(round((pos.shape[1] - 1) ** 0.5))
    new = int(round((target_len - 1) ** 0.5))
    grid = pos[0, 1:].reshape(orig, orig, -1).astype(np.float32)
    w = _resize_weights(orig, new)
    resized = np.einsum("hwd,hH,wW->HWd", grid, w, w).astype(pos.dtype)
    return np.concatenate([pos[:, :1], resized.reshape(1, new * new, -1)], axis=1)


# torch name -> flax path (JAX's table) ------------------------------------

_BLOCK_LEAF = {
    "norm1.weight": ("norm1", "scale"),
    "norm1.bias": ("norm1", "bias"),
    "norm2.weight": ("norm2", "scale"),
    "norm2.bias": ("norm2", "bias"),
    "attn.qkv.weight": ("attn", "qkv", "kernel"),
    "attn.q_bias": ("attn", "q_bias"),
    "attn.v_bias": ("attn", "v_bias"),
    "attn.proj.weight": ("attn", "proj", "kernel"),
    "attn.proj.bias": ("attn", "proj", "bias"),
    "gamma_1": ("gamma_1",),
    "gamma_2": ("gamma_2",),
}

_TOP = {
    "transformer.pos_embed": ("transformer", "pos_embed"),
    "transformer.img_cls_token": ("transformer", "img_cls_token"),
    "transformer.img_mask_token": ("transformer", "img_mask_token"),
    "transformer.patch_embed.proj.weight": ("transformer", "patch_embed", "kernel"),
    "transformer.patch_embed.proj.bias": ("transformer", "patch_embed", "bias"),
    "transformer.token_type_embeddings.weight": (
        "transformer", "token_type_embeddings", "embedding"),
    "transformer.nlvr2_embedding.weight": (
        "transformer", "token_type_embeddings", "embedding"),
    "transformer.txt_embeddings.word_embeddings.weight": (
        "transformer", "txt_embeddings", "word_embeddings", "embedding"),
    "transformer.txt_embeddings.position_embeddings.weight": (
        "transformer", "txt_embeddings", "position_embeddings", "embedding"),
    "transformer.txt_embeddings.token_type_embeddings.weight": (
        "transformer", "txt_embeddings", "token_type_embeddings", "embedding"),
    "transformer.txt_embeddings.LayerNorm.weight": (
        "transformer", "txt_embeddings", "LayerNorm", "scale"),
    "transformer.txt_embeddings.LayerNorm.bias": (
        "transformer", "txt_embeddings", "LayerNorm", "bias"),
    "transformer.norm.weight": ("transformer", "norm", "scale"),
    "transformer.norm.bias": ("transformer", "norm", "bias"),
    "transformer.pooler.dense.weight": ("transformer", "pooler", "dense", "kernel"),
    "transformer.pooler.dense.bias": ("transformer", "pooler", "dense", "bias"),
    "mlm_head.transform.dense.weight": ("mlm_head", "transform_dense", "kernel"),
    "mlm_head.transform.dense.bias": ("mlm_head", "transform_dense", "bias"),
    "mlm_head.transform.LayerNorm.weight": ("mlm_head", "transform_ln", "scale"),
    "mlm_head.transform.LayerNorm.bias": ("mlm_head", "transform_ln", "bias"),
    "mlm_head.bias": ("mlm_head", "bias"),
    "itc_temp": ("itc_temp",),
    "itc_head.dense.v.weight": ("itc_head", "dense_v", "kernel"),
    "itc_head.dense.v.bias": ("itc_head", "dense_v", "bias"),
    "itc_head.dense.l.weight": ("itc_head", "dense_l", "kernel"),
    "itc_head.dense.l.bias": ("itc_head", "dense_l", "bias"),
    "itm_head.fc.weight": ("itm_head", "fc", "kernel"),
    "itm_head.fc.bias": ("itm_head", "fc", "bias"),
    "mim_head.fc.weight": ("mim_head", "fc", "kernel"),
    "mim_head.fc.bias": ("mim_head", "fc", "bias"),
    "rank_output.weight": ("rank_output", "fc", "kernel"),
    "rank_output.bias": ("rank_output", "fc", "bias"),
    "vqa_classifier.0.weight": ("vqa_classifier", "fc1", "kernel"),
    "vqa_classifier.0.bias": ("vqa_classifier", "fc1", "bias"),
    "vqa_classifier.1.weight": ("vqa_classifier", "ln", "scale"),
    "vqa_classifier.1.bias": ("vqa_classifier", "ln", "bias"),
    "vqa_classifier.3.weight": ("vqa_classifier", "fc2", "kernel"),
    "vqa_classifier.3.bias": ("vqa_classifier", "fc2", "bias"),
    "nlvr2_classifier.0.weight": ("nlvr2_classifier", "fc1", "kernel"),
    "nlvr2_classifier.0.bias": ("nlvr2_classifier", "fc1", "bias"),
    "nlvr2_classifier.1.weight": ("nlvr2_classifier", "ln", "scale"),
    "nlvr2_classifier.1.bias": ("nlvr2_classifier", "ln", "bias"),
    "nlvr2_classifier.3.weight": ("nlvr2_classifier", "fc2", "kernel"),
    "nlvr2_classifier.3.bias": ("nlvr2_classifier", "fc2", "bias"),
}


def _flax_path(torch_key: str) -> tuple | None:
    key = torch_key
    if key in _TOP:
        return _TOP[key]
    if "transformer." + key in _TOP:
        return _TOP["transformer." + key]
    for prefix in ("transformer.blocks.", "blocks."):
        if key.startswith(prefix):
            idx, _, leaf = key[len(prefix):].partition(".")
            if leaf in _BLOCK_LEAF:
                return ("transformer", f"blocks_{idx}") + _BLOCK_LEAF[leaf]
            parts = leaf.split(".")  # mlp.v.fc1.weight -> mlp_v/fc1/kernel
            if parts[0] == "mlp" and len(parts) == 4:
                _, route, fc, wb = parts
                return ("transformer", f"blocks_{idx}", f"mlp_{route}", fc,
                        "kernel" if wb == "weight" else "bias")
            return None
    for bare in ("pos_embed", "img_cls_token", "img_mask_token"):
        if key == bare:
            return ("transformer", bare)
    if key.startswith("patch_embed.proj."):
        return _TOP["transformer." + key]
    return None


_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _port_name(flax_path: tuple) -> str:
    """A flax path as the port's state_dict key (`convert.from_flax_params`'s
    renames)."""
    *mods, leaf = flax_path
    mods = [m.replace("blocks_", "blocks.") if m.startswith("blocks_") else m
            for m in mods]
    return ".".join(mods + [_LEAF.get(leaf, leaf)])


def _flax_path_of(port_key: str, tensor: torch.Tensor) -> str:
    """A port state_dict key as JAX's `/`-joined flax path, a `weight` named
    as flax names it for its module: `embedding` for an embedding table,
    `scale` for a LayerNorm, `kernel` for a Dense or Conv."""
    *mods, leaf = re.sub(r"blocks\.(\d+)", r"blocks_\1", port_key).split(".")
    if leaf == "weight":
        if tensor.ndim == 1:
            leaf = "scale"
        elif tensor.ndim == 2 and mods[-1].endswith("embeddings"):
            leaf = "embedding"
        else:
            leaf = "kernel"
    return "/".join(mods + [leaf])


def import_torch_state(state: Mapping[str, Any], target: Mapping[str, torch.Tensor], *,
                       max_text_len: int | None = None
                       ) -> tuple[dict[str, torch.Tensor], list[str], list[str]]:
    """Map a torch state dict onto a copy of the port's `target` state dict.

    Returns (new state dict, the loaded torch keys, the missing flax paths),
    as JAX's importer returns them. Unknown torch keys and those of another
    shape are skipped; target tensors without a source keep their values."""
    state = {k: _to_np(v) for k, v in normalize_legacy_names(state).items()}
    if detect_beit(state):
        state = beit_to_vlmo_names(state)
    state = {k.removeprefix("module."): v for k, v in state.items()}

    pe_key = next((k for k in ("transformer.pos_embed", "pos_embed") if k in state), None)
    if pe_key and "transformer.pos_embed" in target:
        state[pe_key] = interpolate_pos_embed(
            state[pe_key], target["transformer.pos_embed"].shape[1])
    tpe = "transformer.txt_embeddings.position_embeddings.weight"
    if tpe in state and max_text_len:
        state[tpe] = state[tpe][:max_text_len]
    state.pop("transformer.txt_embeddings.position_ids", None)

    new = {k: v.clone() for k, v in target.items()}
    loaded: list[str] = []
    loaded_paths: set[str] = set()
    for k, arr in state.items():
        path = _flax_path(k)
        if path is None:
            continue
        name = _port_name(path)
        if name not in new or tuple(arr.shape) != tuple(new[name].shape):
            continue
        new[name] = torch.as_tensor(np.ascontiguousarray(arr)).to(new[name].dtype)
        loaded.append(k)
        loaded_paths.add("/".join(path))
    missing = sorted({_flax_path_of(k, v) for k, v in target.items()} - loaded_paths)
    return new, loaded, missing


def load_torch_checkpoint(path: str) -> dict:
    """`torch.load` of a `.pth` ({'model': sd} and {'module': sd} wrappers,
    or a pickled module, taken apart)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("model", "module", "state_dict"):
            if key in obj and isinstance(obj[key], dict):
                return obj[key]
        return obj
    return obj.state_dict()
