"""Data-parallel training of the port over two gloo processes on the CPU,
held to the port's one-process step on the global batch and to the JAX
trainer on a two-device ``data`` mesh.

One spawn serves every case: ``parallel.dryrun.dryrun_multichip(2,
"cpu")`` starts two fresh interpreters (one thread each) joined over a
``file://`` store under ``tmp_path`` (no TCP port, so no race between
xdist workers), with a 60 s group timeout, each ended within 240 s.  Its
process 0 runs the one-process step beside each data-parallel one and
reports the errors: 1e-5 of scale, each gradient's over that leaf's own
largest magnitude in the one-process step; 1e-4 for the waveform step's
conv-stack gradients, whose conv2.weight gradient moves by 2.1e-5 of its
scale between one and four threads in one process
(``parallel/dryrun.py``, ``BARS``)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu.config.schema import Config as RefConfig
from speech_intent_recognizer_tpu.convert.torch_import import (
    convert_torch_state_dict)
from speech_intent_recognizer_tpu.models import cnn_gru as ref_model
from speech_intent_recognizer_tpu.parallel.mesh import (
    create_mesh as ref_create_mesh)
from speech_intent_recognizer_tpu.parallel.sharding import place_params
from speech_intent_recognizer_tpu.train import loop as ref_loop
from speech_intent_recognizer_tpu.train import state as ref_state
from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
from speech_intent_recognizer_tpu_torch.parallel import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the bars, stated here (the dry run holds the same ones on the CPU)
BARS = dict(loss=1e-5, stats=1e-5, grad=1e-5, conv_grad=1e-5,
            conv_grad_l2=1e-5, waveform_conv_grad=1e-4,
            waveform_conv_grad_l2=1e-4, serving=1e-5)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    result = dryrun.dryrun_multichip(2, "cpu", out_dir=str(out),
                                     timeout_s=240.0, group_timeout_s=60.0)
    return result, out


def _every_rank(result, part):
    return [next(p for p in r["parts"] if p["part"] == part)
            for r in result["ranks"]]


@pytest.mark.parametrize("part", ["feature", "waveform", "wav2vec"])
def test_step_matches_one_process_step(run, part):
    """SpecAugment, mixup and dropout on (feature); the waveform
    augmentation, SpecAugment, mixup and dropout on (waveform); train
    noise, dropout and LayerDrop on (wav2vec): the loss and BatchNorm's
    running statistics within 1e-5 of scale, every gradient within the
    part's bar of its own leaf's scale (the conv stack's in the largest
    magnitude and in the Euclidean norm), and both processes hold
    bit-equal parameters after the step."""
    result, _ = run
    got = result["parts"][part]
    assert got["train_loss_err"] <= BARS["loss"], got
    assert got["stats_err"] <= BARS["stats"], got
    assert got["grad_err"] <= BARS["grad"], got
    if part != "wav2vec":  # the wav2vec model has no conv stack of its own
        for key in ("conv_grad", "conv_grad_l2"):
            bar = BARS.get(f"{part}_{key}", BARS[key])
            assert got[f"{key}_err"] <= bar, (key, got)
    assert all(p["replicas_equal"] for p in _every_rank(result, part))
    losses = {p["train_loss"] for p in _every_rank(result, part)}
    assert len(losses) == 1, losses


@pytest.mark.parametrize("part", ["feature", "waveform"])
def test_evaluate_totals_are_the_global_batchs(run, part):
    """The evaluation's totals are summed over the processes: loss and
    accuracy those of the one-process evaluation, the same on both."""
    result, _ = run
    got = result["parts"][part]
    assert got["eval_loss_err"] <= BARS["loss"], got
    assert got["eval_acc_err"] == 0.0, got
    ranks = _every_rank(result, part)
    assert len({(p["eval_loss"], p["eval_acc"]) for p in ranks}) == 1


def test_checkpoint_round_trip_is_bit_equal(run):
    result, out = run
    assert all(p["bit_equal"] for p in _every_rank(result, "checkpoint"))
    assert (out / "checkpoint" / "state" / "epoch_000001.pt").exists()


def test_serving_mesh_on_a_ragged_batch(run):
    """``Predictor(mesh=)`` over two CPU entries, 2 + 3 rows: the meshless
    predictor's rows."""
    got = run[0]["parts"]["serving"]
    assert got["rows"] == 5 and got["prob_err"] <= BARS["serving"]


def test_deterministic_step_matches_jax_data_mesh(run):
    """The checkpoint part's first step (dropout 0, no augmentation, lr
    5e-5) over two processes against the JAX ``Trainer`` on a two-device
    ``data`` mesh from the same weights and batch: the loss, and the
    evaluation logits after the step (so the weights and BatchNorm's
    statistics), within tests/test_torch_train.py's 1e-4."""
    _, out = run
    saved = torch.load(out / "deterministic_step.pt", weights_only=True)
    raw = saved["config"]
    size = dryrun.SIZES["cpu"]
    widths = dict(conv_channels=size["conv_channels"],
                  gru_hidden=size["gru_hidden"])
    params, stats = convert_torch_state_dict(
        {k: v.numpy() for k, v in saved["init"].items()})
    mesh = ref_create_mesh(devices=jax.devices()[:2])
    model = ref_model.CNNAudioGRU(num_classes=dryrun.CLASSES, dropout=0.0,
                                  **widths)
    tx = ref_state.create_optimizer(lr=raw["lr"],
                                    weight_decay=raw["weight_decay"],
                                    grad_clip=raw["grad_clip"])
    state = ref_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=place_params(mesh, params),
        batch_stats=place_params(mesh, stats), opt_state=tx.init(params),
        tx=tx)
    trainer = ref_loop.Trainer(model, RefConfig.from_dict(raw), mesh=mesh,
                               tx=tx, num_classes=dryrun.CLASSES)
    feats = saved["features"].numpy()
    state, m = trainer._build_epoch_fn()(
        state, jnp.asarray(feats), jnp.asarray(saved["labels"].numpy(),
                                               jnp.int32),
        jnp.asarray(saved["perm"].numpy(), jnp.int32),
        jnp.asarray(saved["weights"].numpy()), jax.random.key(0))
    np.testing.assert_allclose(saved["train_loss"], float(m["loss"]),
                               rtol=1e-4, atol=1e-4)
    held = feats[:4]
    want = np.asarray(model.apply({"params": state.params,
                                   "batch_stats": state.batch_stats},
                                  jnp.asarray(held), train=False))
    port = CNNAudioGRU(num_classes=dryrun.CLASSES, dropout=0.0, **widths)
    port.load_state_dict(saved["after_step"])
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(held)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_cli_train_over_two_processes(tmp_path):
    """``cli.train`` launched twice with the config's ``parallel`` section
    (a ``file://`` coordinator, 2 processes, ``data_axis: 2``, each its
    ``process_id``) on a tiny WAV corpus: process 0 computes and writes the
    feature caches while process 1 waits and reads them, both train the
    same 2 epochs, process 0 alone writes the checkpoints and the
    history."""
    from speech_intent_recognizer_tpu_torch.data.audio_io import save_wav

    rng = np.random.default_rng(5)
    csvs = {}
    for split, n in (("train", 16), ("valid", 8)):
        rows = []
        for i in range(n):
            t = np.arange(int(rng.integers(8000, 16000))) / 16000
            x = 0.3 * np.sin(2 * np.pi * 300 * (i % 2 + 1) * t)
            path = tmp_path / split / f"{i:03d}.wav"
            save_wav(str(path), x.astype(np.float32), 16000)
            rows.append(f"{path},tone_{i % 2}\n")
        csvs[split] = tmp_path / f"{split}.csv"
        csvs[split].write_text("path,label\n" + "".join(rows))
    label_map = tmp_path / "label_map.json"
    label_map.write_text(json.dumps({"tone_0": 0, "tone_1": 1}))
    ckpt = tmp_path / "ckpt"
    procs = []
    for rank in range(2):
        cfg = tmp_path / f"cfg{rank}.yaml"
        cfg.write_text(
            f"data:\n  cache_dir: {tmp_path / 'cache'}\n"
            f"  precompute_batch_size: 8\n"
            f"model:\n  num_labels: 2\n  conv_channels: [8, 16, 16]\n"
            f"  gru_hidden: 32\ntrain:\n  epochs: 2\n  batch_size: 8\n"
            f"  early_stop_patience: 5\n  bf16: false\n"
            f"  save_path: {ckpt}\n"
            f"parallel:\n  coordinator_address: file://{tmp_path / 'store'}\n"
            f"  num_processes: 2\n  process_id: {rank}\n  data_axis: 2\n")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "speech_intent_recognizer_tpu_torch.cli."
             "train", "--config", str(cfg), "--train_csv",
             str(csvs["train"]), "--val_csv", str(csvs["valid"]),
             "--label_map", str(label_map), "--device", "cpu"],
            cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "process 0 of 2" in outs[0] and "process 1 of 2" in outs[1]
    assert "epoch 2/2" in outs[0] and "epoch 2/2" not in outs[1]
    assert (tmp_path / "cache" / "train_features.npz").exists()
    history = json.loads((ckpt / "training_history.json").read_text())
    assert history["epochs_run"] == 2
    assert all(np.isfinite(h["train_loss"]) for h in history["history"])
    assert (ckpt / "best_model.pt").exists()
    assert sorted(os.listdir(ckpt / "state")) == ["epoch_000001.pt",
                                                  "epoch_000002.pt"]
