"""Checkpointing: best-model export + full train-state resume.

Counterpart of ``speech_intent_recognizer_tpu/train/checkpoint.py``:

* **best model**: ``best_model.pt``, a reference-layout ``state_dict``
  (the reference's own artifact, ``scripts/train.py:288``) that
  :meth:`..infer.predict.Predictor.from_checkpoint`, ``cli/test_model.py``
  and ``cli/evaluate.py`` load unchanged, plus ``best_model.json`` with the
  JAX package's meta fields;
* **full state**: ``state/epoch_<n>.pt`` (``torch.save``) with the model,
  the optimizer (Adam moments, step count), the epoch and the early-stop
  bookkeeping; the newest ``keep`` are retained, and ``--resume``
  continues from the newest.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
from typing import Optional

import torch

logger = logging.getLogger(__name__)

BEST_MODEL_FILE = "best_model.pt"
BEST_META_FILE = "best_model.json"
STATE_DIR = "state"
_STATE_RE = re.compile(r"epoch_(\d+)\.pt$")


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class Checkpointer:
    """Writes best-model exports and resumable train state under save_path."""

    def __init__(self, save_path: str, model_meta: Optional[dict] = None,
                 keep: int = 3):
        self.save_path = save_path
        self.model_meta = model_meta or {}
        self.keep = keep
        self.state_dir = os.path.join(save_path, STATE_DIR)
        os.makedirs(self.state_dir, exist_ok=True)

    def save_best(self, state_dict: dict, val_acc: float, epoch: int) -> str:
        path = os.path.join(self.save_path, BEST_MODEL_FILE)
        _atomic_save({k: v.detach().cpu() for k, v in state_dict.items()},
                     path)
        meta = dict(self.model_meta)
        meta.update({"val_acc": float(val_acc), "epoch": int(epoch),
                     "format": "torch-state-dict"})
        with open(os.path.join(self.save_path, BEST_META_FILE), "w") as f:
            json.dump(meta, f, indent=2)
        logger.info("saved best model (val_acc=%.4f) to %s", val_acc, path)
        return path

    def _state_files(self) -> list:
        found = []
        for path in glob.glob(os.path.join(self.state_dir, "epoch_*.pt")):
            m = _STATE_RE.search(path)
            if m:
                found.append((int(m.group(1)), path))
        return sorted(found)

    def save_state(self, model: torch.nn.Module, optimizer, epoch: int,
                   best_val_acc: float, no_improve: int) -> None:
        payload = {"model": model.state_dict(),
                   "optimizer": optimizer.state_dict(),
                   "epoch": int(epoch), "best_val_acc": float(best_val_acc),
                   "no_improve": int(no_improve)}
        _atomic_save(payload, os.path.join(self.state_dir,
                                           f"epoch_{epoch:06d}.pt"))
        for _, path in self._state_files()[:-self.keep]:
            os.remove(path)

    def latest_epoch(self) -> Optional[int]:
        files = self._state_files()
        return files[-1][0] if files else None

    def restore_state(self, model: torch.nn.Module, optimizer
                      ) -> Optional[dict]:
        """Load the newest full state into ``model`` and ``optimizer``;
        returns the bookkeeping (epoch, best_val_acc, no_improve), or None
        when there is none."""
        files = self._state_files()
        if not files:
            return None
        dev = next(model.parameters()).device
        payload = torch.load(files[-1][1], map_location=dev,
                             weights_only=True)
        model.load_state_dict(payload["model"])
        optimizer.load_state_dict(payload["optimizer"])
        book = {"epoch": int(payload["epoch"]),
                "best_val_acc": float(payload["best_val_acc"]),
                "no_improve": int(payload["no_improve"])}
        logger.info("resumed from epoch %d (best val acc %.4f)",
                    book["epoch"], book["best_val_acc"])
        return book
