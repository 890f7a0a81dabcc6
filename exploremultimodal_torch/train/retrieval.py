"""Image-text retrieval evaluation: recall@K (counterpart of
`exploremultimodal_tpu/train/retrieval.py`).

Every image and text of a split is encoded with the single-modality
streams and the ITC projection heads; the full similarity matrix of the
unit-norm features ranks them, and recall@{1,5,10} is reported both ways,
row i's image matching row i's text.
"""

from __future__ import annotations

import numpy as np
import torch

from exploremultimodal_torch.data.pipeline import ShardedLoader, to_device
from exploremultimodal_torch.ops.preprocess import normalize_image


@torch.no_grad()
def encode_split(task, loader: ShardedLoader, device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """(image features (N, D), text features (N, D)), unit-norm and
    row-aligned, fp32 on the host, for the batches of `loader` in order."""
    i_all, t_all = [], []
    for batch in loader.epoch(0):
        b = to_device({k: batch[k] for k in ("image_u8", "text_ids", "text_mask")}, device)
        b["image"] = normalize_image(b.pop("image_u8"))
        # the single-modality streams' projected CLS features, through the
        # task's `__call__` (a sharded task gathers its parameters there)
        feats = task(b, method="itc_momentum_feats")
        i_all.append(feats["i_feat_m"].float().cpu().numpy())
        t_all.append(feats["t_feat_m"].float().cpu().numpy())
    return np.concatenate(i_all), np.concatenate(t_all)


def recall_at_k(img_feats: np.ndarray, txt_feats: np.ndarray,
                ks: tuple[int, ...] = (1, 5, 10)) -> dict[str, float]:
    """i2t and t2i recall@k of the similarity matrix, the ground truth on
    its diagonal, and their mean."""
    sim = img_feats @ txt_feats.T
    gt = np.arange(sim.shape[0])
    rank_i2t = np.argmax(np.argsort(-sim, axis=1) == gt[:, None], axis=1)
    rank_t2i = np.argmax(np.argsort(-sim.T, axis=1) == gt[:, None], axis=1)
    out = {}
    for k in ks:
        out[f"i2t_recall@{k}"] = float((rank_i2t < k).mean())
        out[f"t2i_recall@{k}"] = float((rank_t2i < k).mean())
    out["recall_mean"] = float(np.mean([out[f"i2t_recall@{k}"] for k in ks]
                                       + [out[f"t2i_recall@{k}"] for k in ks]))
    return out


def evaluate_retrieval(trainer, loader: ShardedLoader | None = None) -> dict[str, float]:
    """Recall@K of the trainer's current weights over `loader` (its val
    split by default)."""
    if "itc" not in trainer.task.config.loss_names:
        raise ValueError("retrieval recall needs the ITC projection heads")
    loader = trainer.val_loader if loader is None else loader
    return recall_at_k(*encode_split(trainer.task, loader, trainer.device))
