"""The VQAv2 answer vocabulary (counterpart of
`exploremultimodal_tpu/data/vqa_vocab.py`): loaded from the cached
`resource/vqa_dict.json`, or built from the answer columns of VQA arrow
tables (the `num_classes` most frequent answers) and cached there."""

from __future__ import annotations

import json
import os
from collections import Counter

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


def load_or_build_vqa_vocab(tables=None, cache_path: str | None = None,
                            num_classes: int = 3129) -> dict:
    """The cached vocabulary where `cache_path` (default
    `resource/vqa_dict.json`) exists; else one built from the `answers`
    column of `tables` (pyarrow tables; an answer, a list of them, or a
    list of lists per row), ids by falling count, written to `cache_path`."""
    cache_path = cache_path or os.path.join(RESOURCE_DIR, "vqa_dict.json")
    if os.path.exists(cache_path):
        return load_vqa_vocab(cache_path)
    if tables is None:
        raise FileNotFoundError(f"no cached vocab at {cache_path} and no tables to build from")
    counter: Counter = Counter()
    for table in tables:
        for answers in table["answers"].to_pylist():
            for group in answers if isinstance(answers, list) else [answers]:
                for a in group if isinstance(group, list) else [group]:
                    counter[a] += 1
    ans2id = {a: i for i, (a, _) in enumerate(counter.most_common(num_classes))}
    vocab = {"answer2id": ans2id, "id2answer": {i: a for a, i in ans2id.items()},
             "num_class": len(ans2id)}
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    with open(cache_path, "w") as f:
        json.dump({"answer2id": ans2id,
                   "id2answer": {str(k): v for k, v in vocab["id2answer"].items()},
                   "num_class": vocab["num_class"]}, f)
    return vocab
