"""Dry run of the port on a ``(data, model)`` grid of processes: the
counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``
(its pure data-parallel mesh and its dp x tp meshes).

:func:`dryrun_multichip` starts ``n`` processes (fresh interpreters: CUDA
is never forked) joined by ``torch.distributed`` over a ``file://`` store,
each with a group timeout.  For each model axis asked for (``model_axis``:
one, or several in turn in the same processes) they form the ``n / model``
x ``model`` grid and each runs five parts:

1. ``feature``: one data-parallel train step from features with
   SpecAugment, mixup and dropout on, then an evaluation;
2. ``wav2vec``: one step of the small-config ``Wav2VecTrainer`` (train
   noise, dropout, LayerDrop);
3. ``waveform``: one waveform-resident step with the waveform
   augmentation (K3 on each process's rows on the card), then an
   evaluation;
4. ``checkpoint``: a deterministic step (dropout 0, no augmentation),
   saved by process 0, restored by every process into a fresh model and
   optimizer; the next step is bit-equal to the uninterrupted run's;
5. ``serving`` (process 0): ``Predictor(mesh=)`` over ``n`` entries of the
   device on a ragged batch of ``n + 3`` rows, against the meshless rows.

Parts 1-3 are held to the one-process step on the global batch, which
process 0 runs beside them from the same weights, data and generator:
loss, every gradient after the all-reduce (a split leaf's parts gathered
whole), BatchNorm's running statistics and the evaluation, within
``BARS``.  Each part prints a line as the JAX dry run does, and reports
each process's kernel launches and its bytes of parameters and Adam
moments beside the whole model's (``parallel.sharding.local_bytes``).  On
the CPU the models are narrow (the CNN-GRU at conv 8/16/16, GRU 32; wav2vec
at hidden 32, two heads, so that a model axis of 4 cuts inside a head); on
CUDA the CNN-GRU has the reference widths, 64 rows a process, and wav2vec
is wav2vec2-base (seeded), 4 rows of 1 s a process, fp32 with TF32 off;
NCCL when every process has its own card, gloo when they share one::

    python -m speech_intent_recognizer_tpu_torch.parallel.dryrun --n 2
    python -m speech_intent_recognizer_tpu_torch.parallel.dryrun --n 4 --model_axis 2 --device cpu

(the first on the card, the default).  A part of a mesh with a model axis
writes under ``dp<data>xtp<model>/`` of the output directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from speech_intent_recognizer_tpu_torch.ops.model_parallel import (
    gather_parts)
from speech_intent_recognizer_tpu_torch.parallel.sharding import (
    full_state_dict, local_bytes, place_params, split_dim)

MODULE = "speech_intent_recognizer_tpu_torch.parallel.dryrun"
CLASSES = 4
# data-parallel step vs the one-process step on the global batch (fp32;
# only the order of the sums differs), per device kind: ``loss`` for the
# losses and the evaluation after the step (relative), ``stats`` for
# BatchNorm's running statistics (relative to their largest), ``grad``
# for every gradient of the GRU, attention and fc and ``conv_grad`` for
# the conv stack's (conv and bn leaves), each over that leaf's own
# largest gradient magnitude in the one-process step (at least GRAD_FLOOR
# of the step's largest).  attention.bias's gradient is zero in exact
# arithmetic (the bias shifts every frame's score alike, and the softmax
# over frames ignores a shift): it has no scale of its own and is held
# over the step's largest gradient magnitude.  A ``<part>_<name>`` key
# overrides ``<name>`` for one part.  The statistics' last bits differ,
# and a ReLU or max-pool input within that of its boundary routes its
# gradient elsewhere: the conv stack's gradients move by a share that
# grows with the elements per step.  On the CPU the waveform step's
# conv2.weight gradient moves by 2.1e-5 of its scale, as much as the
# one-process step's own moves between one and four threads (its
# ``spread``): its conv leaves are held at 1e-4.  PERF.md, section 6, has
# the readings.
BARS = {"cpu": dict(loss=1e-5, stats=1e-5, grad=1e-5, conv_grad=1e-5,
                    conv_grad_l2=1e-5, waveform_conv_grad=1e-4,
                    waveform_conv_grad_l2=1e-4, serving=1e-5),
        "cuda": dict(loss=1e-4, stats=1e-5, grad=1e-5, conv_grad=2e-2,
                     conv_grad_l2=2e-3, serving=2e-2)}
GRAD_FLOOR = 1e-3
ZERO_GRADS = ("attention.bias",)
# ``serving``: the serving mesh's probabilities against the meshless
# rows; on the card the bf16 path, whose cuDNN convs pick their algorithm
# by batch size, at bench.py's gate
# data-parallel steps timed after the checks (the median is reported)
STEP_TIMES = 5
# per device kind: widths, rows a process, frames, seconds of audio (the
# CPU's 1.6 s fill 50 of its 64 frames, as 5 s fill 157 of the reference's
# 200); the wav2vec model (None: wav2vec2-base), its rows a process and
# samples a row
SIZES = {
    "cpu": dict(conv_channels=(8, 16, 16), gru_hidden=32, rows=4,
                frames=64, max_duration=1.6, w2v_hidden=32, w2v_rows=4,
                w2v_samples=4000),
    "cuda": dict(conv_channels=(32, 64, 128), gru_hidden=256, rows=64,
                 frames=200, max_duration=5.0, w2v_hidden=None, w2v_rows=4,
                 w2v_samples=16000),
}


def _counters() -> dict:
    """Each kernel's wrappers (K2's two entries: the contract's under
    autograd, the input GEMM's layout elsewhere)."""
    from speech_intent_recognizer_tpu_torch.ops import frontend_kernels as fk
    from speech_intent_recognizer_tpu_torch.ops.conv23 import conv23
    from speech_intent_recognizer_tpu_torch.ops.gru import (
        gru_layer, gru_layer_backward, gru_layer_btc)
    from speech_intent_recognizer_tpu_torch.ops.pool_epilogue import (
        bias_relu_pool2)

    return {"K1": (fk.frontend_conv1,), "K2": (gru_layer, gru_layer_btc),
            "K3": (fk.frontend,), "K2T": (gru_layer_backward,),
            "K4": (fk.mel_db,), "K5": (conv23,), "K6": (bias_relu_pool2,)}


def reset_launches() -> None:
    for fns in _counters().values():
        for fn in fns:
            fn.launches = 0
    (backward,) = _counters()["K2T"]
    backward.kernel_launches.update(dict.fromkeys(backward.kernel_launches, 0))


def launches(device) -> dict:
    """Each kernel's launches, and of K2T's those of the fp32 cluster
    backward (``K2T_cluster``)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    counters = _counters()
    return {**{k: sum(fn.launches for fn in fns)
               for k, fns in counters.items()},
            "K2T_cluster": counters["K2T"][0].kernel_launches["cluster"]}


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def _scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return _err(got, want) / (float(want.abs().max()) or 1.0)


def _size(t: torch.Tensor, kind: str) -> float:
    t = t.float()
    return float(t.abs().max() if kind == "max" else t.norm())


def _grads(model) -> dict:
    return {n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}


def _full_grads(model, mesh) -> dict:
    """Every gradient, a split leaf's parts gathered whole over the model
    group (collective: every process calls it)."""
    out = {}
    for name, g in _grads(model).items():
        d = split_dim(model.get_parameter(name))
        if d is not None:
            g = gather_parts(g, mesh.model_group, d)
        out[name] = g
    return out


def _grad_errs(grads: dict, ref_grads: dict, kind: str = "max") -> dict:
    """Each gradient's error over that leaf's own size in the reference
    step (at least GRAD_FLOOR of the step's largest; the step's largest
    for ZERO_GRADS), both in the norm ``kind``: ``max`` (largest
    magnitude) or ``l2`` (Euclidean)."""
    step = max(_size(g, kind) for g in ref_grads.values())

    def scale(n):
        if n in ZERO_GRADS:
            return step
        return max(_size(ref_grads[n], kind), GRAD_FLOOR * step)

    return {n: _size(g - ref_grads[n], kind) / scale(n)
            for n, g in grads.items()}


def _worst(errs: dict) -> dict:
    """{"grad": (leaf, err)} of the GRU, attention and fc leaves' largest
    error and {"conv_grad": ...} of the conv stack's, where the model has
    the leaves."""
    out = {}
    for key, conv in (("grad", False), ("conv_grad", True)):
        leaves = {n: e for n, e in errs.items()
                  if n.startswith(("conv", "bn")) == conv}
        if leaves:
            worst = max(leaves, key=leaves.get)
            out[key] = (worst, leaves[worst])
    return out


def _compare(grads: dict, buffers: dict, ref_model, dp: dict,
             ref: dict) -> dict:
    """Errors of the step on the mesh (its whole gradients and buffers)
    against the one-process step."""
    ref_grads = _grads(ref_model)
    errs_max = _grad_errs(grads, ref_grads)
    l2 = _grad_errs(grads, ref_grads, "l2")
    ref_bufs = dict(ref_model.named_buffers())
    stats = [_scaled_err(b, ref_bufs[n]) for n, b in buffers.items()
             if "running" in n]
    errs = {f"{k}_err": abs(dp[k] - ref[k]) / (abs(ref[k]) or 1.0)
            for k in dp}
    for key, (leaf, e) in _worst(errs_max).items():
        errs[f"{key}_err"], errs[f"worst_{key}"] = e, leaf
    if "conv_grad" in _worst(l2):
        errs["conv_grad_l2_err"] = _worst(l2)["conv_grad"][1]
    errs.update(stats_err=max(stats, default=0.0), grad_errs=errs_max,
                grad_l2_errs=l2)
    return errs


def _spread(run, ref_model) -> dict:
    """The one-process step's own spread, each gradient over its leaf's
    scale as the data-parallel step's: ``spread``, the step again at four
    threads (CPU only; the card's step gives the same bits again), and
    ``ulp_spread*``, the step again from weights one ulp apart (the first
    weight matrix or kernel moved to the next float up): how far the last
    bits of the same step move its gradients (the conv stack's apart)."""
    out = {}
    threads = torch.get_num_threads()
    if next(ref_model.parameters()).device.type == "cpu":
        torch.set_num_threads(4 if threads != 4 else 1)
        try:
            other = run(None)[0]
        finally:
            torch.set_num_threads(threads)
        out["spread"] = max(_grad_errs(_grads(other),
                                       _grads(ref_model)).values())
    other = run(None, nudge=True)[0]
    for kind, suffix in (("max", ""), ("l2", "_l2")):
        for key, (_, e) in _worst(_grad_errs(
                _grads(other), _grads(ref_model), kind)).items():
            out[f"ulp_spread_{key}{suffix}"] = e
    return out


@torch.no_grad()
def _nudge(model) -> None:
    """Move every value of the model's first weight matrix or kernel one
    ulp up."""
    p = next(p for p in model.parameters() if p.dim() >= 2)
    p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))


def _hold(part: str, errs: dict, kind: str) -> None:
    bars = BARS[kind]

    def bar(key):
        name = key[:-len("_err")]
        return bars.get(f"{part}_{name}", bars.get(name, bars["loss"]))

    bad = {k: v for k, v in errs.items() if k.endswith("_err")
           and v > bar(k)}
    if bad:
        raise AssertionError(f"{part}: data-parallel step vs the one-process "
                             f"step beyond the bars {bars}: {bad} ({errs})")


def _same_on_every_rank(model, mesh) -> bool:
    """Whether every process holds process 0's whole parameters, bit for
    bit (a split leaf's parts gathered over the model group)."""
    flat = torch.cat([
        (p.detach() if split_dim(p) is None
         else gather_parts(p.detach(), mesh.model_group, split_dim(p)))
        .reshape(-1) for p in model.parameters()])
    ref = flat.clone()
    torch.distributed.broadcast(ref, 0, group=mesh.group)
    same = torch.tensor([float(torch.equal(ref, flat))], device=flat.device)
    torch.distributed.all_reduce(same, op=torch.distributed.ReduceOp.MIN,
                                 group=mesh.group)
    return bool(same.item())


def _mesh_name(mesh) -> str:
    return f"dp{mesh.spec.data}xtp{mesh.spec.model}"


def _cnn(dropout: float, size, dev, seed: int = 0):
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU

    model = CNNAudioGRU(num_classes=CLASSES,
                        conv_channels=size["conv_channels"],
                        gru_hidden=size["gru_hidden"], dropout=dropout)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev)


def _cnn_step(mesh, dev, size, raw: dict, waves: bool) -> dict:
    """Parts 1 and 3: a step over the last row of a padded permutation (it
    holds pad rows of weight 0) and an evaluation, data-parallel and, on
    process 0, in one process."""
    from speech_intent_recognizer_tpu_torch.config import Config
    from speech_intent_recognizer_tpu_torch.train.loop import (
        Trainer, epoch_generator, pad_permutation)

    b = mesh.spec.data * size["rows"]
    cfg = Config.from_dict({"num_labels": CLASSES, "batch_size": b,
                            "lr": 1e-3, "bf16": False,
                            "mel_spec_length": size["frames"],
                            "max_duration": size["max_duration"], **raw})
    n = 2 * b - 3
    rng = np.random.default_rng(0)
    lengths = None
    if waves:
        width = cfg.audio.max_samples
        t = np.arange(width) / 16000.0
        tone = np.sin(2 * np.pi * rng.uniform(200, 2000, (n, 1)) * t)
        x = (8000 * tone + 800 * rng.standard_normal((n, width)))
        feats = torch.from_numpy(x.astype(np.int16)).to(dev)
        lengths = torch.from_numpy(rng.integers(
            width // 2, width + 1, n).astype(np.int32)).to(dev)
    else:
        feats = torch.from_numpy(rng.standard_normal(
            (n, 64, size["frames"])).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, CLASSES, n)).to(dev)
    perm, w = pad_permutation(torch.Generator(device=dev).manual_seed(1), n,
                              b, dev)
    perm, w = perm[-1:], w[-1:]

    def run(m, nudge=False):
        model = _cnn(cfg.model.dropout, size, dev)
        if nudge:
            _nudge(model)
        trainer = Trainer(model, cfg, num_classes=CLASSES,
                          from_waveforms=waves, mesh=m)
        reset_launches()
        train = trainer.train_epoch(feats, labels, perm, w,
                                    epoch_generator(0, 0, dev),
                                    lengths=lengths)
        counts = launches(dev)
        ev = trainer.evaluate(feats, labels, batch_size=b, lengths=lengths)
        return model, {"train_loss": train["loss"], "eval_loss": ev["loss"],
                       "eval_acc": ev["acc"]}, (counts, trainer)

    model, metrics, (counts, trainer) = run(mesh)
    grads = _full_grads(model, mesh)
    result = {"part": "waveform" if waves else "feature", **metrics,
              "launches": counts,
              "bytes": local_bytes(model, trainer.optimizer, mesh),
              "replicas_equal": _same_on_every_rank(model, mesh)}
    if mesh.rank == 0:
        ref_model, ref, _ = run(None)
        result.update(_compare(grads, dict(model.named_buffers()),
                               ref_model, metrics, ref),
                      **_spread(run, ref_model))
        _hold(result["part"], result, dev.type)
    # host ms of further data-parallel steps (every process takes part)
    times = []
    for i in range(STEP_TIMES):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_epoch(feats, labels, perm, w,
                            epoch_generator(0, i + 1, dev), lengths=lengths)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    result["step_ms"] = sorted(times)[len(times) // 2]
    return result


def feature_part(mesh, dev, size, out_dir) -> dict:
    return _cnn_step(mesh, dev, size, {
        "use_augmentation": True, "use_mixup": True, "mixup_alpha": 0.2,
        "dropout": 0.5}, waves=False)


def waveform_part(mesh, dev, size, out_dir) -> dict:
    return _cnn_step(mesh, dev, size, {
        "train_on_waveforms": True, "use_waveform_augment": True,
        "use_augmentation": True, "augment_prob": 0.7, "use_mixup": True,
        "dropout": 0.5}, waves=True)


def wav2vec_part(mesh, dev, size, out_dir) -> dict:
    """Part 2: one wav2vec step (noise, dropout, LayerDrop on)."""
    from speech_intent_recognizer_tpu_torch.models.wav2vec import (
        Wav2Vec2Config, Wav2VecIntent, init_wav2vec, small_wav2vec_config)
    from speech_intent_recognizer_tpu_torch.train.loop import (
        epoch_generator)
    from speech_intent_recognizer_tpu_torch.train.wav2vec_trainer import (
        Wav2VecTrainer, create_wav2vec_optimizer)

    length = size["w2v_samples"]
    b = mesh.spec.data * size["w2v_rows"]
    config = (Wav2Vec2Config() if size["w2v_hidden"] is None
              else small_wav2vec_config(hidden_size=size["w2v_hidden"],
                                        num_layers=2))
    rng = np.random.default_rng(2)
    x = torch.from_numpy((0.1 * rng.standard_normal((b, length)))
                         .astype(np.float32)).to(dev)
    ln = rng.integers(length // 2, length + 1, b)
    mask = torch.from_numpy((np.arange(length)[None] < ln[:, None])
                            .astype(np.int32)).to(dev)
    y = torch.from_numpy(rng.integers(0, CLASSES, b)).to(dev)

    def run(m, nudge=False):
        model = init_wav2vec(Wav2VecIntent(config, CLASSES), 0).to(dev)
        if nudge:
            _nudge(model)
        trainer = Wav2VecTrainer(model, create_wav2vec_optimizer(
            model.parameters(), lr=1e-4), CLASSES, max_length=length,
            mesh=m)
        rows = slice(0, b)
        if m is not None:
            k = b // m.spec.data
            rows = slice(m.data_index * k, (m.data_index + 1) * k)
        loss, _acc = trainer.train_step(x[rows], mask[rows], y[rows],
                                        epoch_generator(0, 0, dev))
        if m is not None:  # the global batch's mean of equal local means
            torch.distributed.all_reduce(loss, group=m.data_group)
            loss = loss / m.spec.data
        return model, {"train_loss": float(loss)}, trainer

    model, metrics, trainer = run(mesh)
    grads = _full_grads(model, mesh)
    result = {"part": "wav2vec", **metrics,
              "bytes": local_bytes(model, trainer.optimizer, mesh),
              "replicas_equal": _same_on_every_rank(model, mesh)}
    if mesh.rank == 0:
        ref_model, ref, _ = run(None)
        result.update(_compare(grads, {}, ref_model, metrics, ref),
                      **_spread(run, ref_model))
        _hold("wav2vec", result, dev.type)
    return result


def checkpoint_part(mesh, dev, size, out_dir) -> dict:
    """Part 4: a deterministic step, a checkpoint written by process 0
    (whole leaves and moments, gathered over each model group), a fresh
    model and optimizer restored from it on every process (cut to its
    parts again); the next step bit-equal to the uninterrupted run's.
    Process 0 writes the first step's inputs and result to
    ``deterministic_step.pt`` (the CPU tests hold it to the JAX trainer on
    the same mesh)."""
    from speech_intent_recognizer_tpu_torch.config import Config
    from speech_intent_recognizer_tpu_torch.train.checkpoint import (
        Checkpointer)
    from speech_intent_recognizer_tpu_torch.train.loop import (
        Trainer, epoch_generator, pad_permutation)
    from speech_intent_recognizer_tpu_torch.train.state import (
        optimizer_from_config)

    b = mesh.spec.data * size["rows"]
    # the parity tests' lr (tests/test_torch_train.py)
    raw = {"num_labels": CLASSES, "batch_size": b, "lr": 5e-5,
           "weight_decay": 1e-4, "grad_clip": 1.0, "bf16": False,
           "use_augmentation": False, "use_mixup": False, "dropout": 0.0,
           "mel_spec_length": size["frames"]}
    cfg = Config.from_dict(raw)
    n = 2 * b
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.standard_normal(
        (n, 64, size["frames"])).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, CLASSES, n)).to(dev)
    perm, w = pad_permutation(torch.Generator(device=dev).manual_seed(1), n,
                              b, dev)

    def state(model):
        return {k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()}

    model = _cnn(0.0, size, dev)
    init = state(model)
    trainer = Trainer(model, cfg, num_classes=CLASSES, mesh=mesh)
    first = trainer.train_epoch(feats, labels, perm[:1], w[:1],
                                epoch_generator(0, 0, dev))
    after = full_state_dict(model, mesh)
    ckpt = Checkpointer(os.path.join(out_dir, "checkpoint"))
    ckpt.save_state(model, trainer.optimizer, 1, 0.0, 0, mesh=mesh)
    if mesh.rank == 0:
        torch.save({"config": raw, "init": init, "after_step": after,
                    "features": feats.cpu(), "labels": labels.cpu(),
                    "perm": perm[:1].cpu(), "weights": w[:1].cpu(),
                    "train_loss": first["loss"]},
                   os.path.join(out_dir, "deterministic_step.pt"))
    torch.distributed.barrier(group=mesh.group)
    trainer.train_epoch(feats, labels, perm[1:], w[1:],
                        epoch_generator(0, 1, dev))
    restored = place_params(_cnn(0.0, size, dev, seed=99), mesh)
    opt = optimizer_from_config(cfg, restored.parameters(), n)
    book = ckpt.restore_state(restored, opt, mesh)
    Trainer(restored, cfg, optimizer=opt, num_classes=CLASSES,
            mesh=mesh).train_epoch(feats, labels, perm[1:], w[1:],
                                   epoch_generator(0, 1, dev))
    a, r = full_state_dict(model, mesh), full_state_dict(restored, mesh)
    bit_equal = book is not None and all(torch.equal(a[k], r[k]) for k in a)
    if not bit_equal:
        raise AssertionError("checkpoint: the restored run's next step is "
                             "not bit-equal to the uninterrupted run's")
    return {"part": "checkpoint", "train_loss": first["loss"],
            "bit_equal": bit_equal,
            "bytes": local_bytes(model, trainer.optimizer, mesh),
            "replicas_equal": _same_on_every_rank(model, mesh)}


def serving_part(mesh, dev, size, out_dir) -> dict:
    """Part 5 (process 0): the serving mesh (``n`` entries of the device,
    the mesh's model axis replicated) on a ragged batch."""
    from speech_intent_recognizer_tpu_torch.data.labelmap import (
        save_label_map)
    from speech_intent_recognizer_tpu_torch.infer.predict import Predictor
    from speech_intent_recognizer_tpu_torch.parallel.mesh import create_mesh

    if mesh.rank != 0:
        return {"part": "serving"}
    n = mesh.spec.data * mesh.spec.model
    model = _cnn(0.0, size, "cpu")
    path = os.path.join(out_dir, "serving_model.pt")
    torch.save(model.state_dict(), path)
    lm = os.path.join(out_dir, "serving_labels.json")
    save_label_map({f"intent_{i}": i for i in range(CLASSES)}, lm)
    serving = create_mesh(model_axis=mesh.spec.model, devices=[dev] * n)
    pred = Predictor.from_checkpoint(path, lm, device=dev, mesh=serving)
    plain = Predictor.from_checkpoint(path, lm, device=dev)
    rows = mesh.spec.data + 3
    rng = np.random.default_rng(5)
    width = pred._buffer_width()
    lengths = rng.integers(1, pred.audio_cfg.max_samples + 1, rows)
    buf = np.zeros((rows, width), np.float32)
    for i, k in enumerate(lengths):
        buf[i, :k] = 0.1 * rng.standard_normal(k)
    reset_launches()
    got = pred.predict_waveform_batch(buf, lengths.astype(np.int32))
    counts = launches(dev)
    want = plain.predict_waveform_batch(buf, lengths.astype(np.int32))
    err = float(np.abs(got - want).max())
    bar = BARS[dev.type]["serving"]
    if got.shape != want.shape or err > bar:
        raise AssertionError(f"serving: mesh rows vs meshless rows, "
                             f"shape {got.shape} vs {want.shape}, max "
                             f"|err| {err:.3e} > {bar}")
    return {"part": "serving", "rows": rows, "prob_err": err,
            "launches": counts}


PARTS = (feature_part, wav2vec_part, waveform_part, checkpoint_part,
         serving_part)


def _line(n: int, mesh, r: dict) -> str:
    keys = [k for k in ("train_loss", "eval_loss", "eval_acc", "grad_err",
                        "conv_grad_err", "conv_grad_l2_err", "spread",
                        "ulp_spread_grad", "ulp_spread_conv_grad",
                        "ulp_spread_conv_grad_l2", "stats_err", "step_ms",
                        "bit_equal", "rows", "prob_err", "launches")
            if k in r]
    body = " ".join(f"{k}={r[k]:.6g}" if isinstance(r[k], float)
                    else f"{k}={r[k]}" for k in keys)
    if "bytes" in r:
        by = r["bytes"]
        body += (f" split_bytes={by['split']}/{by['split_full']}"
                 f" adam_split_bytes={by['adam_split']}/"
                 f"{by['adam_split_full']}")
    return f"dryrun_multichip(n={n}): mesh={mesh.shape} {r['part']} {body} OK"


def run_rank(rank: int, n: int, device: str, store: str, out_dir: str,
             timeout_s: float, model_axes=(1,)) -> None:
    """One process of the dry run: join the group, run every part on the
    grid of each model axis in turn, write ``rank<r>.json`` into
    ``out_dir``."""
    from speech_intent_recognizer_tpu_torch.parallel.distributed import (
        initialize_distributed)
    from speech_intent_recognizer_tpu_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    kind = torch.device(device).type
    shared = kind == "cuda" and n > torch.cuda.device_count()
    backend = "gloo" if kind == "cpu" or shared else "nccl"
    dev = initialize_distributed(store, n, rank, device=device,
                                 backend=backend, timeout_s=timeout_s)
    if kind == "cuda":
        # fp32 steps, and the same bits twice (cuDNN's default backward
        # algorithms are not deterministic; the checkpoint part needs it)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    size = SIZES[kind]
    results = []
    try:
        for model_axis in model_axes:
            mesh = create_mesh(model_axis=model_axis)
            sub = out_dir
            if model_axis > 1:
                sub = os.path.join(out_dir, _mesh_name(mesh))
                os.makedirs(sub, exist_ok=True)
            for part in PARTS:
                t0 = time.perf_counter()
                r = part(mesh, dev, size, sub)
                r.update(mesh=_mesh_name(mesh),
                         seconds=time.perf_counter() - t0)
                results.append(r)
                if rank == 0:
                    print(_line(n, mesh, r), flush=True)
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "backend": backend, "device": str(dev),
                       "parts": results}, f, indent=1)
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int = 2, device: str = "cuda",
                     out_dir: str | None = None, timeout_s: float = 600.0,
                     group_timeout_s: float = 120.0,
                     model_axis: "int | tuple" = 1) -> dict:
    """Run the dry run over ``n_devices`` processes on ``device`` (``cpu``
    or ``cuda``), on the ``n_devices / model_axis`` x ``model_axis`` grid
    (``model_axis`` a tuple: each grid in turn, in the same processes);
    every process ends or is killed within ``timeout_s``.  Prints process
    0's lines; raises if any process failed.  Returns ``{"parts": {name:
    process 0's result on the first grid}, "meshes": {"dp<d>xtp<m>":
    {name: process 0's result}}, "ranks": [each process's results]}``;
    ``out_dir`` keeps the files (else a temporary directory).  Raises on
    ``cuda`` when there is no card."""
    axes = (model_axis,) if isinstance(model_axis, int) else tuple(
        model_axis)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: device 'cuda' asked for, but "
                           "torch.cuda.is_available() is False (pass "
                           "device='cpu' for the CPU run)")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory(prefix="sir_dryrun_") as tmp:
        out = out_dir or tmp
        store = "file://" + os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", MODULE, "--rank", str(r), "--n",
             str(n_devices), "--device", device, "--store", store, "--out",
             out, "--group-timeout", str(group_timeout_s), "--model_axis",
             *map(str, axes)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(n_devices)]
        outputs = []
        try:
            for p in procs:
                outputs.append(p.communicate(timeout=timeout_s)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError("dryrun_multichip: process(es) "
                               f"{failed} failed:\n" + "\n".join(
                                   f"--- process {r} ---\n{outputs[r][-4000:]}"
                                   for r in failed))
        print(outputs[0], end="", flush=True)
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    meshes = {}
    for p in ranks[0]["parts"]:
        meshes.setdefault(p["mesh"], {})[p["part"]] = p
    return {"parts": next(iter(meshes.values())), "meshes": meshes,
            "ranks": ranks}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    p.add_argument("--rank", type=int, default=None,
                   help="(internal) run one process of the dry run")
    p.add_argument("--store", default=None, help="(internal)")
    p.add_argument("--out", default=None, help="(internal)")
    p.add_argument("--group-timeout", type=float, default=120.0,
                   help="seconds a collective may wait")
    p.add_argument("--model_axis", type=int, nargs="+", default=[1],
                   help="the model axis of the grid (several: each grid in "
                        "turn)")
    args = p.parse_args(argv)
    if args.rank is not None:
        run_rank(args.rank, args.n, args.device, args.store, args.out,
                 args.group_timeout, tuple(args.model_axis))
        return {}
    return dryrun_multichip(args.n, args.device,
                            group_timeout_s=args.group_timeout,
                            model_axis=tuple(args.model_axis))


if __name__ == "__main__":
    main()
