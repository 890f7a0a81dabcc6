"""VQAv2 answer vocabulary from the cached `resource/vqa_dict.json`
(the loading half of `exploremultimodal_tpu/data/vqa_vocab.py`)."""

from __future__ import annotations

import json
import os

RESOURCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "resource",
)


def load_vqa_vocab(cache_path: str | None = None) -> dict:
    """Returns {'answer2id', 'id2answer' (int keys), 'num_class'}."""
    cache_path = cache_path or os.path.join(RESOURCE_DIR, "vqa_dict.json")
    with open(cache_path) as f:
        d = json.load(f)
    ans2id = d.get("answer2id") or d.get("ans2id") or d
    id2ans = d.get("id2answer") or d.get("id2ans")
    if id2ans is None:
        id2ans = {str(v): k for k, v in ans2id.items()}
    return {
        "answer2id": ans2id,
        "id2answer": {int(k): v for k, v in id2ans.items()},
        "num_class": d.get("num_class", len(ans2id)),
    }
