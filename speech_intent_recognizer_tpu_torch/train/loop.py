"""The training loop over a device-resident feature or waveform set.

Counterpart of ``speech_intent_recognizer_tpu/train/loop.py`` (reference
``scripts/train.py:72-118,164-302``) on one device.  The whole feature set
lives on the device; an epoch is a loop of steps that gather their batch by
index there, so nothing crosses to the host inside an epoch.  Shuffling is
a device ``randperm``; the last partial batch is padded with repeats that
carry weight 0 (they still enter BatchNorm's batch statistics, as in the JAX
version), so every sample counts once per epoch.

Waveform-resident mode (``Trainer(from_waveforms=True)``,
``data.train_on_waveforms``): the set is int16 waveforms with their
lengths, and each step featurizes its gathered rows with
:func:`..ops.frontend.log_mel_frontend` (the K3 kernel on a CUDA device at
the reference geometry), after the waveform augmentation of
``data.use_waveform_augment`` (``ops/augment.py``).  The features are
data: no gradient flows into the front-end.

:meth:`Trainer.train_epoch` takes ``(perm, weights)`` as the JAX
``epoch_fn`` does, so both packages can be fed identical batches.  Each
epoch draws its permutation, waveform augmentation, SpecAugment, mixup and
dropout from one ``torch.Generator`` seeded from ``(seed, epoch)``, so a
resumed run continues exactly.  Early stopping and best-model tracking follow
``train.py:263-302`` with the JAX package's rule: always export a best
model once.

Data-parallel mode (``Trainer(mesh=)``, a mesh over processes from
``parallel.create_mesh`` in a ``torch.distributed`` group): every process
holds the whole set and draws the same ``(perm, weights)``, and runs its
own rows of each global batch, with its own K3, K2 and K2T launches.  Its
step is the one-process step on the global batch, as the JAX step on a
``data`` mesh is: the draws are the global batch's
(``parallel.sharding.sharded_generator``), BatchNorm's statistics are
reduced over the group (``CNNAudioGRU.set_sync_group``), the loss is
divided by the global batch's weight (each process holds the whole
weights row, so no collective), and the gradients are summed over the
group in one all-reduce after ``backward()``.  Metrics and
the stop flag are reduced too, so early stopping and the best model agree
on every process; process 0 alone writes checkpoints.

On a ``(data, model)`` grid (``create_mesh(model_axis=)``) the rows, the
draws, BatchNorm's statistics, the metric totals and the gradient sum are
the data group's (``Mesh.data_group``); the processes of a model group run
the same rows, each with its parts of the GRU, ``attention`` and ``fc``
leaves (``parallel.sharding.place_params``, which the trainer applies),
and the clip sums the parts' norms over the model group.  Checkpoints
hold whole leaves and whole Adam moments, gathered over each model group
(every process takes part; process 0 writes), in the one-process format.
"""

from __future__ import annotations

import logging
import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from speech_intent_recognizer_tpu_torch.config import Config
from speech_intent_recognizer_tpu_torch.ops.augment import (
    augment_waveforms, mixup)
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    log_mel_frontend, make_frontend_params)
from speech_intent_recognizer_tpu_torch.ops.specaugment import spec_augment
from speech_intent_recognizer_tpu_torch.parallel.distributed import (
    all_reduce_gradients, all_reduce_max)
from speech_intent_recognizer_tpu_torch.parallel.mesh import (
    Mesh, local_batch_size, training_mesh)
from speech_intent_recognizer_tpu_torch.parallel.sharding import (
    full_state_dict, place_params, sharded_generator)
from speech_intent_recognizer_tpu_torch.train.state import (
    Optimizer, create_optimizer)

logger = logging.getLogger(__name__)


def cross_entropy(logits: torch.Tensor, labels_onehot: torch.Tensor,
                  weights: torch.Tensor,
                  total_weight: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Weighted mean cross-entropy, log-softmax in fp32.  ``total_weight``:
    the denominator when these rows are a part of the batch (its whole
    weight), else ``weights.sum()``."""
    logp = F.log_softmax(logits.float(), dim=-1)
    per_example = -(labels_onehot * logp).sum(dim=-1)
    total = weights.sum() if total_weight is None else total_weight
    return (per_example * weights).sum() / total.clamp(min=1e-8)


def pad_permutation(generator: torch.Generator, n: int, batch_size: int,
                    device: "str | torch.device"):
    """Device shuffle padded to whole batches: (perm (steps, B) int64,
    weights (steps, B) f32).  Padding entries repeat the permutation from
    its start (``jnp.resize``) and carry weight 0."""
    steps = -(-n // batch_size)
    total = steps * batch_size
    perm = torch.randperm(n, generator=generator, device=device)
    pad = perm.repeat(-(-(total - n) // n))[:total - n]
    idx = torch.cat([perm, pad]).reshape(steps, batch_size)
    w = (torch.arange(total, device=device) < n).float().reshape(
        steps, batch_size)
    return idx, w


def sequential_batches(n: int, batch_size: int,
                       device: "str | torch.device" = "cpu"):
    """In-order batches; the last one padded with index n-1 at weight 0."""
    steps = -(-n // batch_size)
    total = steps * batch_size
    idx = torch.arange(total, device=device).clamp(max=n - 1).reshape(
        steps, batch_size)
    w = (torch.arange(total, device=device) < n).float().reshape(
        steps, batch_size)
    return idx, w


def epoch_generator(seed: int, epoch: int,
                    device: "str | torch.device") -> torch.Generator:
    """The generator of one epoch, a function of (seed, epoch) only."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


@dataclass
class TrainResult:
    best_val_acc: float
    epochs_run: int
    history: list = field(default_factory=list)
    best_state: Optional[dict] = None
    stopped_early: bool = False


class Trainer:
    """Config-driven trainer for the intent classifier on one device, or
    on one process's rows (and parts of the split leaves) of a mesh
    (``mesh=``, a mesh over processes; a mesh of one data shard in this
    process is the one-device trainer).  On a mesh with a model axis the
    model's split leaves are cut here (:func:`..parallel.sharding.
    place_params`) unless they already are; a given ``optimizer`` must
    be built after that cut."""

    def __init__(self, model: torch.nn.Module, cfg: Config,
                 optimizer: Optional[Optimizer] = None,
                 num_classes: Optional[int] = None,
                 from_waveforms: bool = False,
                 mesh: Optional[Mesh] = None):
        self.mesh = training_mesh(mesh, "Trainer")
        if self.mesh is not None:
            # on a grid with a model axis, a data group of one process
            # holds the whole batch: native BatchNorm is then the
            # one-process arithmetic, bit for bit (the synchronized path's
            # last bits move the conv stack's gradients by ReLU / max-pool
            # routing).  A data-parallel run keeps the synchronized path
            # at every size, one process included: on a one-card host
            # that is the run that exercises it
            sync = self.mesh.spec.data > 1 or self.mesh.spec.model == 1
            model.set_sync_group(self.mesh.data_group if sync else None)
            place_params(model, self.mesh)
        self.model = model
        self.cfg = cfg
        self.num_classes = num_classes or cfg.model.num_labels
        self.optimizer = optimizer or create_optimizer(
            model.parameters(), lr=cfg.train.lr,
            weight_decay=cfg.train.weight_decay,
            grad_clip=cfg.train.grad_clip)
        if self.mesh is not None:
            self.optimizer.model_group = self.mesh.model_group
        self.from_waveforms = from_waveforms
        self._frontend_params = None
        if from_waveforms:
            device = next(model.parameters()).device
            self._frontend_params = make_frontend_params(cfg.audio, device)

    def _featurize(self, waves: torch.Tensor, lengths: torch.Tensor
                   ) -> torch.Tensor:
        """(B, L) float32 waveforms + (B,) int32 lengths -> (B, n_mels, T)
        float32 features; K3 on a CUDA device at the reference geometry."""
        return log_mel_frontend(waves, lengths.clamp(min=1),
                                self._frontend_params)

    def _inputs(self, features: torch.Tensor, lengths, idx: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The model's input for the rows ``idx``: gathered features, or in
        waveform mode the gathered int16 rows scaled to float, augmented
        when ``generator`` is given, then featurized."""
        if not self.from_waveforms:
            return features[idx]
        with torch.no_grad():
            x = features[idx].float() * (1.0 / 32768.0)
            ln = lengths[idx]
            if generator is not None:
                x, ln = augment_waveforms(
                    x, ln, generator, augment_prob=self.cfg.data.augment_prob)
            return self._featurize(x, ln)

    def _check_lengths(self, lengths) -> None:
        if self.from_waveforms and lengths is None:
            raise ValueError("waveform-resident training needs the lengths")

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    def _local(self, batch: int) -> slice:
        """This process's rows of a ``batch``-row global batch."""
        if self.mesh is None:
            return slice(0, batch)
        b = local_batch_size(batch, self.mesh)
        d = self.mesh.data_index
        return slice(d * b, (d + 1) * b)

    def _reduce(self, totals: torch.Tensor) -> torch.Tensor:
        """Sum per-process metric totals over the mesh's data group."""
        if self.mesh is not None:
            torch.distributed.all_reduce(totals, group=self.mesh.data_group)
        return totals

    def train_epoch(self, features: torch.Tensor, labels: torch.Tensor,
                    perm: torch.Tensor, weights: torch.Tensor,
                    generator: torch.Generator,
                    lengths: Optional[torch.Tensor] = None) -> dict:
        """One optimizer step per row of ``perm`` / ``weights``; waveform
        augmentation, SpecAugment, mixup and dropout draw from
        ``generator``.  In waveform mode ``features`` are (N, L) int16
        waveforms and ``lengths`` (N,) int32.  -> {"loss", "acc"} (weighted
        means).  Data-parallel: ``perm`` and ``weights`` are the global
        batches, the same on every process, which runs its own rows."""
        self._check_lengths(lengths)
        data = self.cfg.data
        use_mixup = data.mixup_alpha > 0 and data.use_mixup
        wave_aug = data.use_waveform_augment and self.from_waveforms
        model, opt = self.model, self.optimizer
        model.train()
        mine = self._local(int(perm.shape[1]))
        generator = sharded_generator(generator, self.mesh)
        group = None if self.mesh is None else self.mesh.data_group
        totals = torch.zeros(3, device=features.device)
        for idx_all, w_all in zip(perm, weights):
            idx, w, w_sum = idx_all[mine], w_all[mine], w_all.sum()
            x = self._inputs(features, lengths, idx,
                             generator if wave_aug else None)
            y = labels[idx]
            y_onehot = F.one_hot(y, self.num_classes).float()
            if data.use_augmentation:
                x = spec_augment(x, generator,
                                 augment_prob=data.augment_prob,
                                 time_mask_param=data.time_mask_param,
                                 freq_mask_param=data.freq_mask_param)
            if use_mixup:
                x, y_onehot = mixup(x, y_onehot, generator, data.mixup_alpha,
                                    group)
            logits = model(x, generator)
            loss = cross_entropy(logits, y_onehot, w, w_sum)
            opt.zero_grad()
            loss.backward()
            if self.mesh is not None:
                all_reduce_gradients(opt.params, self.mesh.data_group)
            opt.step()
            with torch.no_grad():
                correct = ((logits.argmax(-1) == y).float() * w).sum()
                totals += torch.stack([loss * w_sum, correct, w.sum()])
        return _means(self._reduce(totals))

    @torch.no_grad()
    def evaluate(self, features: torch.Tensor, labels: torch.Tensor,
                 batch_size: Optional[int] = None,
                 lengths: Optional[torch.Tensor] = None) -> dict:
        """Weighted loss and accuracy over the set; data-parallel, each
        process runs its rows of each batch (rounded up to a multiple of
        the data axis) and the totals are summed over the mesh."""
        self._check_lengths(lengths)
        bs = batch_size or (self.cfg.train.batch_size
                            * self.cfg.train.eval_batch_multiplier)
        n = int(features.shape[0])
        bs = min(bs, n)
        if self.mesh is not None:
            bs = -(-bs // self.mesh.spec.data) * self.mesh.spec.data
        perm, weights = sequential_batches(n, bs, features.device)
        mine = self._local(bs)
        self.model.eval()
        totals = torch.zeros(3, device=features.device)
        for idx, w in zip(perm[:, mine], weights[:, mine]):
            y = labels[idx]
            logits = self.model(self._inputs(features, lengths, idx))
            loss = cross_entropy(logits, F.one_hot(y, self.num_classes)
                                 .float(), w)
            correct = ((logits.argmax(-1) == y).float() * w).sum()
            totals += torch.stack([loss * w.sum(), correct, w.sum()])
        return _means(self._reduce(totals))

    def fit(self, train_features: torch.Tensor, train_labels: torch.Tensor,
            val_features: torch.Tensor, val_labels: torch.Tensor,
            checkpointer=None, start_epoch: int = 0,
            best_val_acc: float = 0.0, no_improve: int = 0,
            log: Optional[Callable[[str], None]] = None,
            train_lengths: Optional[torch.Tensor] = None,
            val_lengths: Optional[torch.Tensor] = None) -> TrainResult:
        """Train from ``start_epoch`` to ``cfg.train.epochs`` with early
        stopping; in waveform mode the features are int16 waveforms and
        ``train_lengths`` / ``val_lengths`` their lengths.  Data-parallel:
        every process passes the whole set (and its checkpointer); process
        0 alone logs and writes checkpoints, and the others wait for its
        writes."""
        cfg = self.cfg.train
        log = log or logger.info
        if self.rank != 0:
            log = _silent
        n_train = int(train_features.shape[0])
        bs = min(cfg.batch_size, n_train)
        if self.mesh is not None:  # raises unless bs divides by the axis
            local_batch_size(bs, self.mesh)
        dev = train_features.device
        result = TrainResult(best_val_acc=best_val_acc, epochs_run=start_epoch)

        # SIGTERM / SIGINT request a final checkpoint at the next epoch
        # boundary instead of dying mid-step
        preempted = {"flag": False}
        prev_handlers = {}

        def _request_stop(signum, _frame):
            preempted["flag"] = True
            log(f"signal {signum}: will checkpoint and stop after this epoch")

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, _request_stop)
            except ValueError:  # not the main thread
                pass

        try:
            for epoch in range(start_epoch, cfg.epochs):
                t0 = time.perf_counter()
                gen = epoch_generator(cfg.seed, epoch, dev)
                perm, weights = pad_permutation(gen, n_train, bs, dev)
                train_m = self.train_epoch(train_features, train_labels,
                                           perm, weights, gen,
                                           lengths=train_lengths)
                val_m = self.evaluate(val_features, val_labels,
                                      lengths=val_lengths)
                dt = time.perf_counter() - t0
                entry = {"epoch": epoch + 1, "train_loss": train_m["loss"],
                         "train_acc": train_m["acc"],
                         "val_loss": val_m["loss"], "val_acc": val_m["acc"],
                         "seconds": dt}
                result.history.append(entry)
                log(f"epoch {epoch + 1}/{cfg.epochs}: "
                    f"train_loss={train_m['loss']:.4f} "
                    f"val_loss={val_m['loss']:.4f} "
                    f"val_acc={val_m['acc']:.4f} ({dt:.1f}s)")

                improved = (val_m["acc"]
                            > result.best_val_acc + cfg.early_stop_delta)
                # always export a best model once (the reference can end a
                # degenerate run with no checkpoint, train.py:281)
                if (val_m["acc"] > result.best_val_acc
                        or result.best_state is None):
                    result.best_val_acc = val_m["acc"]
                    result.best_state = full_state_dict(self.model,
                                                        self.mesh)
                    if checkpointer is not None and self.rank == 0:
                        checkpointer.save_best(result.best_state,
                                               result.best_val_acc, epoch + 1)
                if improved:
                    no_improve = 0
                else:
                    no_improve += 1
                    log(f"no improvement for {no_improve} epoch(s)")

                if checkpointer is not None:
                    checkpointer.save_state(self.model, self.optimizer,
                                            epoch + 1, result.best_val_acc,
                                            no_improve, mesh=self.mesh)
                if self.mesh is not None:
                    # one decision for every process: a signal to any
                    # stops all.  Process 0 joins after its writes, so no
                    # process goes on before the checkpoint is on disk
                    preempted["flag"] = all_reduce_max(
                        preempted["flag"], self.mesh.group, dev)

                result.epochs_run = epoch + 1
                if no_improve >= cfg.early_stop_patience:
                    log(f"early stopping after {epoch + 1} epochs")
                    result.stopped_early = True
                    break
                if preempted["flag"]:
                    log(f"preempted; state checkpointed at epoch {epoch + 1}")
                    result.stopped_early = True
                    break
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
        log(f"training complete; best val accuracy {result.best_val_acc:.4f}")
        return result


def _silent(_msg: str) -> None:
    pass


def _means(totals: torch.Tensor) -> dict:
    loss_sum, correct, count = totals.tolist()
    count = max(count, 1.0)
    return {"loss": loss_sum / count, "acc": correct / count}
