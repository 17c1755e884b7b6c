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
  continues from the newest.  :meth:`Checkpointer.save_payload` /
  :meth:`Checkpointer.restore_payload` store any such dict (the wav2vec
  trainer's: model, optimizer with its plateau state, ``plateau_value``,
  bookkeeping) the same way.

The JAX package writes its resumable state as orbax directories; this
package writes ``torch.save`` files and reads neither package's the other
way, as with the best-model formats.

On a mesh that splits leaves over its ``model`` axis (``mesh=``) a file
holds whole leaves and whole Adam moments, gathered over each model group
(``parallel/sharding.py``), in the one-process format: every process
calls :meth:`Checkpointer.save_state` and process 0 writes;
:meth:`Checkpointer.restore_state` cuts them to this process's parts.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
from typing import Optional

import torch

from speech_intent_recognizer_tpu_torch.parallel.sharding import (
    full_optimizer_state, full_state_dict, sharded_optimizer_state,
    sharded_state_dict)

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
                   best_val_acc: float, no_improve: int, mesh=None) -> None:
        """The model, the optimizer and the bookkeeping as ``state/
        epoch_<epoch>.pt``.  With a ``mesh`` over processes every process
        calls this (a split model is gathered over each model group) and
        process 0 writes."""
        writes = mesh is None or not mesh.over_processes or mesh.rank == 0
        if not writes and mesh.spec.model == 1:
            return  # nothing to gather
        payload = {"model": full_state_dict(model, mesh),
                   "optimizer": full_optimizer_state(optimizer, mesh),
                   "epoch": int(epoch), "best_val_acc": float(best_val_acc),
                   "no_improve": int(no_improve)}
        if writes:
            self.save_payload(payload, epoch)

    def save_payload(self, payload: dict, step: int) -> None:
        """Save a resumable-state dict (tensors, numbers, strings, nested
        dicts and lists) as ``state/epoch_<step>.pt``, atomically; keep the
        newest ``keep``."""
        _atomic_save(payload, os.path.join(self.state_dir,
                                           f"epoch_{step:06d}.pt"))
        for _, path in self._state_files()[:-self.keep]:
            os.remove(path)

    def restore_payload(self, map_location="cpu") -> Optional[dict]:
        """The newest dict saved by :meth:`save_payload`, or None."""
        files = self._state_files()
        if not files:
            return None
        return torch.load(files[-1][1], map_location=map_location,
                          weights_only=True)

    def latest_epoch(self) -> Optional[int]:
        files = self._state_files()
        return files[-1][0] if files else None

    def restore_state(self, model: torch.nn.Module, optimizer, mesh=None
                      ) -> Optional[dict]:
        """Load the newest full state into ``model`` and ``optimizer`` (on
        a ``mesh`` with a model axis, placed ones: each split leaf and its
        moments cut to this process's part); returns the bookkeeping
        (epoch, best_val_acc, no_improve), or None when there is none."""
        payload = self.restore_payload(next(model.parameters()).device)
        if payload is None:
            return None
        model.load_state_dict(sharded_state_dict(payload["model"], model,
                                                 mesh))
        optimizer.load_state_dict(sharded_optimizer_state(
            payload["optimizer"], optimizer, mesh))
        book = {"epoch": int(payload["epoch"]),
                "best_val_acc": float(payload["best_val_acc"]),
                "no_improve": int(payload["no_improve"])}
        logger.info("resumed from epoch %d (best val acc %.4f)",
                    book["epoch"], book["best_val_acc"])
        return book


def save_model(path: str, state_dict: dict,
               meta: Optional[dict] = None) -> None:
    """A standalone model file (the JAX package's ``save_model``): the
    state dict as ``path`` (CPU tensors, written atomically) and ``meta`` as
    the ``.json`` beside it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _atomic_save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    if meta is not None:
        with open(os.path.splitext(path)[0] + ".json", "w") as f:
            json.dump(meta, f, indent=2)
