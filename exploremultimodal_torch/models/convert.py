"""Flax parameter tree -> state_dict of `VlmoTask`.

The torch modules carry the flax module names, so the map is a rename of
the leaf, `blocks_<i>` -> `blocks.<i>`, and a transpose of each kernel:
  Dense `kernel` (in, out)      -> Linear `weight` (out, in)
  Conv  `kernel` HWIO           -> Conv2d `weight` OIHW
  Embed `embedding`             -> `weight`
  LayerNorm `scale`             -> `weight`
  `bias`, `q_bias`, `v_bias`, `gamma_1`, `gamma_2`, `pos_embed`,
  `img_cls_token`, `img_mask_token` keep their names.
The Dense and `DenseParams` trees (fused MLP) have the same names, so one
map covers both `mlp_impl`s. Load the result with `strict=True`.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_LEAF = {"embedding": "weight", "scale": "weight"}


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def from_flax_params(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`params`: the flax `params` collection as nested dicts of arrays."""
    out = {}
    for path, leaf in _flatten(params):
        arr = np.array(leaf, dtype=np.float32)
        *mods, name = path
        if name == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"kernel {'/'.join(path)} has rank {arr.ndim}")
            name = "weight"
        name = _LEAF.get(name, name)
        key = ".".join([re.sub(r"^blocks_(\d+)$", r"blocks.\1", m) for m in mods]
                       + [name])
        # copy() keeps 0-d leaves (itc_temp) 0-d; ascontiguousarray would not
        out[key] = torch.from_numpy(arr.copy())
    return out
