"""Fine-tuning of the raw-waveform ``Wav2VecIntent`` model.

Counterpart of ``speech_intent_recognizer_tpu/train/wav2vec_trainer.py``
(the reference's bytecode-only wav2vec trainer: AdamW, ReduceLROnPlateau
with factor 0.5 and patience 2, gradient clipping, an optionally frozen
feature extractor; batch 8, 20 epochs).  Raw 5 s waveforms are streamed
from the files batch by batch (decoded on a worker thread, copied to the
device two batches ahead as the JAX trainer's ``device_prefetch`` does),
padded to a fixed ``max_length``.

:func:`create_wav2vec_optimizer` is the JAX package's optax chain, step for
step: ``clip_by_global_norm`` over the trainable parameters, AdamW (optax
form: b1 0.9, b2 0.999, eps 1e-8, decoupled decay on every trainable
parameter) and then either ``optax.contrib.reduce_on_plateau`` (the
default) or, with ``warmup_steps > 0``, ``warmup_cosine_decay_schedule``
without the plateau.  Freezing is ``requires_grad=False`` on the feature
extractor (:func:`..models.wav2vec.feature_extractor_params`): those
parameters get no update and no decay, as under optax's ``set_to_zero``.

As in the JAX trainer, the plateau transform is stepped on every train
step with the last epoch's validation loss (``inf`` during epoch 1), so
its patience counts steps, not epochs: the scale halves every second step
(ROADMAP Queue 3, "Noted, in the reference").

Each epoch's noise, dropout and LayerDrop draw from one generator seeded
from ``(seed, epoch)`` and its shuffle from ``default_rng(seed + epoch)``,
so a resumed run matches an uninterrupted one.

Data-parallel (``mesh=``, a mesh over processes from
``parallel.create_mesh``): every process walks the same global batches and
decodes only its own rows of each; its draws are the global batch's
(``parallel.sharding.sharded_generator``); the gradients are averaged over the group
in one all-reduce, which makes the mean of equal local batches' mean
losses the global batch's mean; the validation metrics are averaged the
same way, and process 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import logging
import math
import os
import signal
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from speech_intent_recognizer_tpu_torch.data.prefetch import (
    BackgroundLoader, device_prefetch)
from speech_intent_recognizer_tpu_torch.data.wav2vec_data import (
    apply_train_noise, batch_waveforms, draw_train_noise)
from speech_intent_recognizer_tpu_torch.parallel.distributed import (
    all_reduce_gradients, all_reduce_max)
from speech_intent_recognizer_tpu_torch.parallel.mesh import (
    local_batch_size, training_mesh)
from speech_intent_recognizer_tpu_torch.parallel.sharding import (
    sharded_generator)
from speech_intent_recognizer_tpu_torch.train.loop import (
    _silent, epoch_generator)
from speech_intent_recognizer_tpu_torch.train.state import (
    ADAM_BETAS, ADAM_EPS, clip_by_global_norm_, lr_schedule)

logger = logging.getLogger(__name__)


class ReduceOnPlateau:
    """``optax.contrib.reduce_on_plateau``'s update rule at its defaults
    (rtol 1e-4, atol 0, no cooldown, accumulation_size 1, min_scale 0), in
    float32 on the host: :meth:`update` takes the value of one call and
    returns the scale that call applies.  At those defaults optax's other
    state fields (cooldown count, accumulated count and average) are
    constant and left out."""

    RTOL = 1e-4

    def __init__(self, factor: float = 0.5, patience: int = 2):
        self.factor, self.patience = factor, patience
        self.scale = np.float32(1.0)
        self.best_value = np.float32(np.inf)
        self.plateau_count = 0

    def update(self, value: float) -> float:
        value = np.float32(value)
        if value < np.float32(1 - self.RTOL) * self.best_value:
            self.best_value, self.plateau_count = value, 0
        else:
            self.plateau_count += 1
        if self.plateau_count == self.patience:
            self.scale = self.scale * np.float32(self.factor)
            self.plateau_count = 0
        return float(self.scale)

    def state_dict(self) -> dict:
        return {"scale": float(self.scale),
                "best_value": float(self.best_value),
                "plateau_count": self.plateau_count}

    def load_state_dict(self, state: dict) -> None:
        self.scale = np.float32(state["scale"])
        self.best_value = np.float32(state["best_value"])
        self.plateau_count = int(state["plateau_count"])


class Wav2VecOptimizer:
    """The wav2vec recipe's chain over a model's trainable parameters:
    optax-form global-norm clip, then AdamW at ``lr`` times the plateau
    scale, or at the warmup-cosine schedule's rate for this count."""

    def __init__(self, params, lr: float = 1e-4, weight_decay: float = 0.01,
                 grad_clip: Optional[float] = 1.0,
                 plateau: Optional[ReduceOnPlateau] = None,
                 schedule: Optional[Callable[[int], float]] = None):
        self.params = [p for p in params if p.requires_grad]
        self.lr = lr
        self.grad_clip = grad_clip if grad_clip and grad_clip > 0 else None
        self.plateau = plateau
        self.schedule = schedule
        self.count = 0
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=ADAM_BETAS,
                                       eps=ADAM_EPS,
                                       weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, value: float = math.inf) -> None:
        """One update; ``value`` feeds the plateau transform (ignored
        without one)."""
        for p in self.params:
            if p.grad is None:  # optax updates (decays) it with a zero grad
                p.grad = torch.zeros_like(p)
        if self.grad_clip is not None:
            clip_by_global_norm_([p.grad for p in self.params],
                                 self.grad_clip)
        lr = self.lr if self.schedule is None else self.schedule(self.count)
        if self.plateau is not None:
            lr = lr * self.plateau.update(value)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "plateau": (None if self.plateau is None
                            else self.plateau.state_dict())}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])
        if self.plateau is not None:
            self.plateau.load_state_dict(state["plateau"])


def create_wav2vec_optimizer(params, lr: float = 1e-4,
                             weight_decay: float = 0.01,
                             grad_clip: Optional[float] = 1.0,
                             plateau_factor: float = 0.5,
                             plateau_patience: int = 2,
                             warmup_steps: int = 0,
                             decay_steps: int = 0) -> Wav2VecOptimizer:
    """The JAX package's ``create_wav2vec_optimizer`` over the parameters
    that require grad.  ``warmup_steps > 0``: linear warmup from 0 to
    ``lr``, then cosine decay to 0 at ``max(decay_steps, warmup_steps +
    1)`` (``configs/wav2vec_large_batch.yaml``), no plateau transform."""
    if warmup_steps > 0:
        return Wav2VecOptimizer(
            params, lr, weight_decay, grad_clip,
            schedule=lr_schedule(lr, warmup_steps, "cosine",
                                 max(decay_steps, warmup_steps + 1)))
    return Wav2VecOptimizer(params, lr, weight_decay, grad_clip,
                            plateau=ReduceOnPlateau(plateau_factor,
                                                    plateau_patience))


class Wav2VecTrainer:
    """Train and evaluate steps and the epoch loop of the wav2vec recipe on
    the device that holds ``model``, data-parallel with a mesh over
    processes (``mesh``; a mesh of one device in this process is the
    one-device trainer)."""

    def __init__(self, model: torch.nn.Module, optimizer: Wav2VecOptimizer,
                 num_classes: int, max_length: int = 80000,
                 sample_rate: int = 16000, noise_prob: float = 0.8,
                 noise_level: float = 1e-3, mesh=None):
        self.mesh = training_mesh(mesh, "Wav2VecTrainer")
        self.model = model
        self.optimizer = optimizer
        self.num_classes = num_classes
        self.max_length = max_length
        self.sample_rate = sample_rate
        self.noise_prob = noise_prob
        self.noise_level = noise_level
        self.device = next(model.parameters()).device

    def update(self, x: torch.Tensor, mask: torch.Tensor, y: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               plateau_value: float = math.inf):
        """One optimizer update on an already-noised batch: mean softmax
        cross-entropy in train mode (dropout and LayerDrop from
        ``generator``).  Returns (loss, accuracy) as device scalars."""
        self.model.train()
        generator = sharded_generator(generator, self.mesh)
        logits = self.model(x, mask, generator=generator).float()
        loss = F.cross_entropy(logits, y)
        self.optimizer.zero_grad()
        loss.backward()
        if self.mesh is not None:
            all_reduce_gradients(self.optimizer.params, self.mesh.group,
                                 average=True)
        self.optimizer.step(plateau_value)
        acc = (logits.argmax(-1) == y).float().mean()
        return loss.detach(), acc

    def train_step(self, x: torch.Tensor, mask: torch.Tensor,
                   y: torch.Tensor, generator: Optional[torch.Generator],
                   plateau_value: float = math.inf):
        """The train step: the reference's additive noise, then
        :meth:`update`."""
        gate_u, normals = draw_train_noise(
            tuple(x.shape), x.device,
            sharded_generator(generator, self.mesh))
        x = apply_train_noise(x, mask, gate_u, normals, self.noise_prob,
                              self.noise_level)
        return self.update(x, mask, y, generator, plateau_value)

    @torch.no_grad()
    def evaluate_batch(self, x: torch.Tensor, mask: torch.Tensor,
                       y: torch.Tensor):
        self.model.eval()
        logits = self.model(x, mask).float()
        return (F.cross_entropy(logits, y),
                (logits.argmax(-1) == y).float().mean())

    def _batches(self, paths: Sequence[str], labels: Sequence[int],
                 batch_size: int, shuffle: bool, seed: int):
        """Full batches only (a partial last batch is dropped, in training
        and validation alike), decoded on a worker thread and copied to the
        device two batches ahead (``data/prefetch.device_prefetch``: pinned
        memory, non-blocking copies on a side stream).  Data-parallel: this
        process's rows of each global batch only."""
        n = len(paths)
        order = (np.random.default_rng(seed).permutation(n) if shuffle
                 else np.arange(n))
        labels = np.asarray(labels)
        mine = slice(0, batch_size)
        if self.mesh is not None:
            b = local_batch_size(batch_size, self.mesh)
            mine = slice(self.mesh.rank * b, (self.mesh.rank + 1) * b)

        def produce():
            for start in range(0, n - batch_size + 1, batch_size):
                idx = order[start:start + batch_size][mine]
                x, mask, _ok = batch_waveforms([paths[i] for i in idx],
                                               self.sample_rate,
                                               self.max_length)
                yield x, mask, labels[idx]

        host = ((x, mask, y.astype(np.int64))
                for x, mask, y in BackgroundLoader(produce, capacity=2))
        yield from device_prefetch(host, buffer_size=2, device=self.device)

    def fit(self, train_paths, train_labels, val_paths, val_labels,
            epochs: int = 20, batch_size: int = 8, seed: int = 0,
            early_stop_patience: int = 5, checkpointer=None,
            resume: bool = True, log: Optional[Callable] = None) -> dict:
        """Train; returns ``{"best_val_acc", "best_state", "history"}``.

        With ``checkpointer`` (a :class:`.checkpoint.Checkpointer`) the
        best model is exported as ``best_model.pt`` and the full state
        (model, optimizer with the plateau state, ``plateau_value``,
        bookkeeping) saved every epoch; a stopped run resumes from its last
        epoch.  SIGTERM / SIGINT stop the run after the current epoch."""
        from speech_intent_recognizer_tpu_torch.train.checkpoint import (
            BEST_MODEL_FILE)

        log = log or logger.info
        rank = 0 if self.mesh is None else self.mesh.rank
        if rank != 0:
            log = _silent
        start_epoch, best_val_acc, best_state, no_improve = 0, -1.0, None, 0
        plateau_value = math.inf
        history = []
        if checkpointer is not None and resume:
            restored = checkpointer.restore_payload(self.device)
            if restored is not None:
                self.model.load_state_dict(restored["model"])
                self.optimizer.load_state_dict(restored["optimizer"])
                plateau_value = float(restored["plateau_value"])
                start_epoch = int(restored["epoch"])
                best_val_acc = float(restored["best_val_acc"])
                no_improve = int(restored["no_improve"])
                best_file = os.path.join(checkpointer.save_path,
                                         BEST_MODEL_FILE)
                if os.path.exists(best_file):
                    best_state = torch.load(best_file, map_location="cpu",
                                            weights_only=True)
                log(f"w2v resumed from epoch {start_epoch} "
                    f"(best val acc {best_val_acc:.4f})")

        stop_requested = {"flag": False}
        prev_handlers = {}

        def _request_stop(signum, _frame):
            stop_requested["flag"] = True
            log(f"signal {signum}: will checkpoint and stop after this epoch")

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, _request_stop)
            except (ValueError, OSError):  # not the main thread
                prev_handlers.pop(sig, None)
        try:
            for epoch in range(start_epoch, epochs):
                t0 = time.perf_counter()
                gen = epoch_generator(seed, epoch, self.device)
                losses, accs = [], []
                for x, mask, y in self._batches(train_paths, train_labels,
                                                batch_size, True,
                                                seed + epoch):
                    loss, acc = self.train_step(x, mask, y, gen,
                                                plateau_value)
                    losses.append(loss)
                    accs.append(acc)
                vl, va = [], []
                for x, mask, y in self._batches(val_paths, val_labels,
                                                batch_size, False, 0):
                    loss, acc = self.evaluate_batch(x, mask, y)
                    vl.append(loss)
                    va.append(acc)
                vl, va, losses = (self._mean_over_mesh(v)
                                  for v in (vl, va, losses))
                val_loss = (float(torch.stack(vl).double().mean()) if vl
                            else math.inf)
                val_acc = float(torch.stack(va).double().mean()) if va \
                    else 0.0
                plateau_value = val_loss
                entry = {"epoch": epoch + 1,
                         "train_loss": (float(torch.stack(losses).double()
                                              .mean()) if losses else 0.0),
                         "val_loss": val_loss, "val_acc": val_acc,
                         "seconds": time.perf_counter() - t0}
                history.append(entry)
                log(f"w2v epoch {epoch + 1}/{epochs}: "
                    f"train_loss={entry['train_loss']:.4f} "
                    f"val_loss={val_loss:.4f} val_acc={val_acc:.4f}")
                stop = False
                if val_acc > best_val_acc:
                    best_val_acc, no_improve = val_acc, 0
                    best_state = {k: v.detach().cpu().clone() for k, v in
                                  self.model.state_dict().items()}
                    if checkpointer is not None and rank == 0:
                        checkpointer.save_best(best_state, best_val_acc,
                                               epoch + 1)
                else:
                    no_improve += 1
                    if no_improve >= early_stop_patience:
                        log(f"early stopping after {epoch + 1} epochs")
                        stop = True
                if checkpointer is not None and rank == 0:
                    checkpointer.save_payload(
                        {"model": self.model.state_dict(),
                         "optimizer": self.optimizer.state_dict(),
                         "plateau_value": float(plateau_value),
                         "epoch": epoch + 1,
                         "best_val_acc": float(best_val_acc),
                         "no_improve": int(no_improve)}, epoch + 1)
                if self.mesh is not None:
                    # a signal to any process stops all; process 0 joins
                    # after its writes
                    stop_requested["flag"] = all_reduce_max(
                        stop_requested["flag"], self.mesh.group, self.device)
                if stop_requested["flag"]:
                    log(f"stopped by signal; state checkpointed at epoch "
                        f"{epoch + 1}")
                    stop = True
                if stop:
                    break
        finally:
            for sig, handler in prev_handlers.items():
                try:
                    signal.signal(sig, handler)
                except (ValueError, OSError):
                    pass
        return {"best_val_acc": best_val_acc, "best_state": best_state,
                "history": history}

    def _mean_over_mesh(self, values: list) -> list:
        """Per-batch device scalars averaged over the mesh's processes (the
        global batch's mean over equal local batches)."""
        if self.mesh is None or not values:
            return values
        t = torch.stack(values).float()
        torch.distributed.all_reduce(t, group=self.mesh.group)
        return list(t / self.mesh.spec.data)

