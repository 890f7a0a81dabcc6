"""Flax parameter tree -> state_dict of `VlmoTask`; a JAX `TrainState`'s
trees and queues -> the port's `TrainState` (`load_flax_train_state`).

The torch modules carry the flax module names, so the map is a rename of
the leaf, `blocks_<i>` -> `blocks.<i>`, and a transpose of each kernel:
  Dense `kernel` (in, out)      -> Linear `weight` (out, in)
  Conv  `kernel` HWIO           -> Conv2d `weight` OIHW
  ConvTranspose `kernel` HWIO   -> ConvTranspose2d `weight` (I, O, H, W),
                                   flipped in H and W (`DiscreteVAE`'s
                                   `dec_convs_<i>`: flax correlates with
                                   the kernel as it is, torch flips it)
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

from exploremultimodal_torch.parallel.partitioning import load_model_state_dict

_LEAF = {"embedding": "weight", "scale": "weight"}
# modules that are flax `ConvTranspose`s (transpose_kernel=False)
_CONV_TRANSPOSE = re.compile(r"^dec_convs_\d+$")


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
            elif arr.ndim == 4 and mods and _CONV_TRANSPOSE.match(mods[-1]):
                arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
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


def load_flax_train_state(state, parts: Mapping[str, Any]) -> None:
    """Carry the fields of a JAX `TrainState` into the port's `TrainState`
    in place. `parts` maps JAX's field names to host values (numpy leaves,
    e.g. from `jax.device_get`); any subset of:
      params            -> state.task
      ema_params        -> state.ema_task (the momentum encoder)
      model_ema_params  -> state.model_ema_task (the eval EMA)
      img_queue, txt_queue  -> the queues, (itc_dim, Q) each
      queue_ptr         -> state.queue_ptr
    A field the port's state was not built with raises ValueError."""
    unknown = set(parts) - {"params", "ema_params", "model_ema_params", "img_queue",
                            "txt_queue", "queue_ptr"}
    if unknown:
        raise ValueError(f"not fields of a JAX TrainState: {sorted(unknown)}")
    trees = {"params": state.task, "ema_params": state.ema_task,
             "model_ema_params": state.model_ema_task}
    for name, tree in trees.items():
        if name not in parts:
            continue
        if tree is None:
            raise ValueError(f"{name} given, but the port's state has no such tree")
        # in place: the tensors keep their addresses (this rank's shares
        # where the tree is split or sharded)
        load_model_state_dict(tree, from_flax_params(parts[name]), strict=True)
    for name in ("img_queue", "txt_queue"):
        if name in parts:
            queue = getattr(state, name)
            if queue is None:
                raise ValueError(f"{name} given, but the port's state has no queues")
            queue.copy_(torch.from_numpy(np.array(parts[name], dtype=np.float32)))
    if "queue_ptr" in parts:
        state.queue_ptr = int(np.asarray(parts["queue_ptr"]))
