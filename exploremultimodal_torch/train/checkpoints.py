"""Checkpoint save, retention and auto-resume (counterpart of
`exploremultimodal_tpu/train/checkpoints.py`).

  save        `checkpoint-{epoch}/` under the run dir, holding `state.pt`
              (one `torch.save` of the train state) and `meta.json`
              {phase, tag, epoch, step, best}, renamed into place whole
  auto_load   the newest `checkpoint-*` under the experiment dir, timestamped
              subruns included; the full state when phase and tag match the
              checkpoint's meta, the parameters only (optimizer reset,
              `train.start_epoch`) when they differ; `train.resume` names a
              checkpoint directory, a `.pth` file or a URL of either
  retention   keep only the latest and the best epochs
  torch import  a `.pth` file is a BEiT/VLMo state dict, imported through
              `models.import_torch`

A checkpoint of the port is a directory; a file is a `.pth`, as the JAX
package tells its orbax directories from `.pth` files. The port does not
read orbax checkpoints (it cannot import JAX).

`state.pt` holds the fp32 parameters (`VlmoTask.state_dict()`), the AdamW
state (`torch.optim.AdamW.state_dict()`: its moments and step counts), the
step, the ISDA statistics, the momentum encoder's and the eval EMA's trees,
the negative queues and their pointer (each None where the run has none),
and the states of both of `TrainState`'s generators, so that a resumed run
draws the dropout an uninterrupted one draws. A full resume restores all
of it; a warm start (a phase or tag mismatch, or a `.pth` import) loads
the parameters only and leaves both EMA trees and the queues as the run
built them, as JAX's `state.replace(params=...)` does: the trees then hold
the run's initial weights, not the loaded ones.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import shutil
import tempfile
import urllib.parse
import urllib.request
from typing import Any

import torch

from exploremultimodal_torch.models.heads import ISDAState
from exploremultimodal_torch.train.state import TrainState

CKPT_PREFIX = "checkpoint-"
STATE_FILE = "state.pt"


def _ckpt_dir(output_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(output_dir), f"{CKPT_PREFIX}{epoch}")


def state_dict(state: TrainState) -> dict[str, Any]:
    """Everything a resume needs, as tensors and plain values."""
    isda = state.isda
    return {
        "step": int(state.step),
        "model": state.task.state_dict(),
        "optimizer": state.optimizer.torch.state_dict(),
        "generator": state.generator.get_state(),
        "seed_generator": state.seed_generator.get_state(),
        "isda": None if isda is None else {
            "count": isda.count, "mean": isda.mean, "cov": isda.cov},
        "ema": None if state.ema_task is None else state.ema_task.state_dict(),
        "model_ema": (None if state.model_ema_task is None
                      else state.model_ema_task.state_dict()),
        "queue": None if state.img_queue is None else {
            "img": state.img_queue, "txt": state.txt_queue, "ptr": state.queue_ptr},
    }


def _check_present(sd: dict, key: str, present: bool, flag: str) -> None:
    if (sd.get(key) is not None) != present:
        raise ValueError(f"the checkpoint's {key} does not match the run's {flag}")


def load_state_dict(state: TrainState, sd: dict[str, Any]) -> None:
    """Restore `sd` (from `state_dict`) into `state` in place. Each of the
    ISDA statistics, the two EMA trees and the queues must be in both or
    in neither (ValueError otherwise)."""
    _check_present(sd, "isda", state.isda is not None, "train.isda_lambda")
    _check_present(sd, "ema", state.ema_task is not None, "vlmo_ema")
    _check_present(sd, "model_ema", state.model_ema_task is not None, "model_ema")
    _check_present(sd, "queue", state.img_queue is not None, "train.neg_queue")
    state.task.load_state_dict(sd["model"], strict=True)
    state.optimizer.torch.load_state_dict(sd["optimizer"])
    state.step = int(sd["step"])
    # a generator's state is a host ByteTensor, whatever device it draws on
    state.generator.set_state(sd["generator"].cpu())
    state.seed_generator.set_state(sd["seed_generator"].cpu())
    if sd["isda"] is not None:
        dev = state.isda.count.device
        state.isda = ISDAState(**{k: v.to(dev) for k, v in sd["isda"].items()})
    for key, tree in (("ema", state.ema_task), ("model_ema", state.model_ema_task)):
        if tree is not None:
            tree.load_state_dict(sd[key], strict=True)
    if state.img_queue is not None:
        q = sd["queue"]
        if q["img"].shape != state.img_queue.shape:
            raise ValueError(f"the checkpoint's queues are {tuple(q['img'].shape)}, the "
                             f"run's {tuple(state.img_queue.shape)}")
        state.img_queue.copy_(q["img"])
        state.txt_queue.copy_(q["txt"])
        state.queue_ptr = int(q["ptr"])


def save(output_dir: str, state: TrainState, cfg: dict, epoch: int, *,
         is_best: bool = False, scan_root: str | None = None, logger=None) -> str:
    """Save `checkpoint-{epoch}` under `output_dir` (the run dir), then
    apply retention under `scan_root` (the experiment dir), so stale
    checkpoints of earlier timestamped subruns are cleaned too.

    The files are written into `checkpoint-{epoch}.tmp/`, which `_scan`
    does not match, and the directory is renamed into place only once both
    are whole: a run killed during the save leaves the previous checkpoint
    the newest one."""
    path = _ckpt_dir(output_dir, epoch)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(state_dict(state), os.path.join(tmp, STATE_FILE))
    meta = {"phase": cfg["train"]["phase"], "tag": cfg.get("tag", "default"),
            "epoch": epoch, "step": int(state.step), "best": bool(is_best)}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    _apply_retention(scan_root or output_dir, keep_epoch=epoch, logger=logger)
    if logger:
        logger.info(f"saved checkpoint {path}" + (" (best)" if is_best else ""))
    return path


def _scan(output_dir: str) -> list[tuple[int, str]]:
    hits = []
    for path in glob.glob(os.path.join(output_dir, "**", f"{CKPT_PREFIX}*"),
                          recursive=True):
        m = re.search(rf"{CKPT_PREFIX}(\d+)$", path)
        if m and os.path.isdir(path):
            hits.append((int(m.group(1)), path))
    return sorted(set(hits))


def _apply_retention(output_dir: str, keep_epoch: int, logger=None) -> None:
    """Keep the latest (`keep_epoch`) and every best checkpoint."""
    for epoch, path in _scan(output_dir):
        if epoch == keep_epoch:
            continue
        meta_path = os.path.join(path, "meta.json")
        best = False
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                best = json.load(f).get("best", False)
        if not best:
            shutil.rmtree(path, ignore_errors=True)
            if logger:
                logger.info(f"removed old checkpoint {path}")


def _fetch_url_checkpoint(url: str, logger=None, sha256: str = "") -> str:
    """Fetch a checkpoint URL into the local cache (`EMM_CKPT_CACHE`, else
    `~/.cache/emm_checkpoints`) once and return the cached path.

    `file://` and `https://` only: plain `http://` is refused, since the file
    feeds a pickle loader. The download's sha256 must start with `sha256`
    (`train.resume_sha256`) or, failing that, with the hex suffix of a
    torch.hub-style name (`<name>-<hexprefix>.pth`); a mismatch discards
    it."""
    if url.startswith("http://"):
        raise ValueError(
            f"refusing plain-http checkpoint URL {url!r}: downloads are "
            "unauthenticated and the file feeds a pickle importer; use https://")
    expect = (sha256 or "").lower()
    name = os.path.basename(urllib.parse.urlparse(url).path) or "checkpoint"
    if not expect:
        m = re.search(r"-([0-9a-f]{8,64})\.[a-zA-Z]+$", name)
        if m:
            expect = m.group(1)
    cache_dir = os.environ.get(
        "EMM_CKPT_CACHE", os.path.join(os.path.expanduser("~"), ".cache",
                                       "emm_checkpoints"))
    os.makedirs(cache_dir, exist_ok=True)
    dest = os.path.join(cache_dir,
                        f"{hashlib.sha256(url.encode()).hexdigest()[:12]}_{name}")
    if os.path.exists(dest):
        if logger:
            logger.info(f"using cached checkpoint {dest} for {url}")
        return dest
    if logger:
        logger.info(f"fetching checkpoint {url} -> {dest}")
    # a unique temporary name: two runs sharing the cache must not write
    # into one file; os.replace installs it atomically
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".part")
    os.close(fd)
    try:
        urllib.request.urlretrieve(url, tmp)
        if expect:
            h = hashlib.sha256()
            with open(tmp, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            if not h.hexdigest().startswith(expect):
                raise ValueError(f"checkpoint {url} sha256 {h.hexdigest()[:16]}... does "
                                 f"not match expected prefix {expect!r}")
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return dest


def _is_torch_file(path: str) -> bool:
    """A torch file by its content: a zip archive (torch >= 1.6) or a pickle
    stream of protocol 2 or later (the legacy format), so that a URL without
    a `.pth` name still reaches the torch importer."""
    if not os.path.isfile(path):
        return False
    with open(path, "rb") as f:
        magic = f.read(2)
    return magic == b"PK" or (len(magic) == 2 and magic[0] == 0x80)


def is_torch_checkpoint(path: str) -> bool:
    return path.endswith((".pth", ".pt", ".ckpt")) or _is_torch_file(path)


def read_checkpoint(path: str) -> tuple[dict, dict]:
    """(state dict, meta) of a checkpoint directory, its tensors on the host:
    the loads copy each tensor to its parameter's device, and AdamW's step
    counts stay host tensors, as the optimizer keeps them."""
    sd = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                    weights_only=True)
    meta: dict = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return sd, meta


def auto_load(output_dir: str, state: TrainState, cfg: dict, *,
              logger=None) -> tuple[TrainState, int] | None:
    """Resume from the newest checkpoint under `output_dir`, or from
    `train.resume`. Loads into `state` in place and returns (state, the
    next epoch), or None when there is nothing to load."""
    t = cfg["train"]
    resume = t.get("resume") or ""
    if resume.startswith(("http://", "https://", "file://")):
        resume = _fetch_url_checkpoint(resume, logger, sha256=t.get("resume_sha256", ""))
    if resume and is_torch_checkpoint(resume):
        _load_torch(resume, state, cfg, logger)
        return state, int(t.get("start_epoch", 0))

    candidates = _scan(output_dir)
    if resume and os.path.isdir(resume):
        m = re.search(rf"{CKPT_PREFIX}(\d+)$", resume)
        candidates = [(int(m.group(1)) if m else 0, resume)]
    if not candidates:
        return None
    epoch, path = candidates[-1]
    sd, meta = read_checkpoint(path)
    if meta.get("phase") == t["phase"] and meta.get("tag") == cfg.get("tag", "default"):
        load_state_dict(state, sd)
        if logger:
            logger.info(f"resumed full state from {path} (epoch {epoch})")
        return state, epoch + 1
    # phase or tag differ: the parameters only (those the run's task has, at
    # the same shape), the optimizer as it is
    own = state.task.state_dict()
    params = {k: v for k, v in sd["model"].items()
              if k in own and own[k].shape == v.shape}
    state.task.load_state_dict(params, strict=False)
    if logger:
        logger.info(f"loaded params from {path} (phase/tag mismatch: "
                    f"{meta.get('phase')}/{meta.get('tag')} vs "
                    f"{t['phase']}/{cfg.get('tag')}); optimizer state reset")
    return state, int(t.get("start_epoch", 0))


def _load_torch(path: str, state: TrainState, cfg: dict, logger=None) -> None:
    from exploremultimodal_torch.models.import_torch import (
        import_torch_state,
        load_torch_checkpoint,
    )

    target = state.task.state_dict()
    new, loaded, missing = import_torch_state(
        load_torch_checkpoint(path), target, max_text_len=cfg["model"]["max_text_len"])
    state.task.load_state_dict(new, strict=True)
    if logger:
        logger.info(f"imported torch checkpoint {path}: {len(loaded)} tensors loaded, "
                    f"{len(missing)} params kept at init")
        if missing[:10]:
            logger.debug(f"first missing: {missing[:10]}")
