"""Experiment metric sink with W&B's surface (counterpart of
`exploremultimodal_tpu/utils/experiment_log.py`).

With `wandb.enable` set, `wandb` is imported where it is installed (its
files under the output dir); its absence or failure never fails the run.
Otherwise metrics go to `<output_dir>/metrics.jsonl`, alerts to
`alerts.jsonl` and the min/max summary to `summary.json`. With `enable`
false (every process of a group but rank 0) it writes nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


def _summary_mode(key: str) -> str | None:
    if "loss" in key:
        return "min"
    if "acc" in key or "score" in key:
        return "max"
    return None


class ExperimentLogger:
    def __init__(self, cfg: dict, output_dir: str | None = None, enable: bool = True):
        self.enable = enable
        self.output_dir = output_dir or "."
        self.step = 0
        self._summary: dict[str, float] = {}
        self._wandb = None
        self._path = os.path.join(self.output_dir, "metrics.jsonl")
        if not enable:
            return
        os.makedirs(self.output_dir, exist_ok=True)
        w = cfg.get("wandb") or {}
        if not w.get("enable"):
            return
        try:
            import wandb

            self._wandb = wandb.init(project=w.get("project", "vlmo_tpu"),
                                     name=w.get("name", "run"),
                                     mode=w.get("mode", "offline"), config=dict(cfg),
                                     dir=self.output_dir)
        except Exception:
            self._wandb = None

    def log(self, head: str = "train", step: int | None = None, **metrics: float) -> None:
        if not self.enable:
            return
        if step is None:
            step, self.step = self.step, self.step + 1
        record: dict[str, Any] = {"_step": step, "_time": time.time()}
        for k, v in metrics.items():
            if v is None:
                continue
            key, v = f"{head}/{k}", float(v)
            record[key] = v
            mode = _summary_mode(k)
            if mode == "min":
                self._summary[key] = min(self._summary.get(key, v), v)
            elif mode == "max":
                self._summary[key] = max(self._summary.get(key, v), v)
            else:
                self._summary[key] = v
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if not k.startswith("_")},
                            step=step)
        else:
            with open(self._path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def alert(self, title: str, text: str) -> None:
        """An end-of-phase or anomaly alert; without a wandb client it is
        appended to `<output_dir>/alerts.jsonl`."""
        if not self.enable:
            return
        if self._wandb is not None:
            try:
                import wandb

                self._wandb.alert(title=title, text=text,
                                  level=wandb.AlertLevel.INFO, wait_duration=10)
                return
            except Exception:
                pass
        with open(os.path.join(self.output_dir, "alerts.jsonl"), "a") as f:
            f.write(json.dumps({"_time": time.time(), "title": title,
                                "text": text}) + "\n")

    def finish(self) -> None:
        if not self.enable:
            return
        if self._wandb is not None:
            self._wandb.finish()
        else:
            with open(os.path.join(self.output_dir, "summary.json"), "w") as f:
                json.dump(self._summary, f, indent=2)
