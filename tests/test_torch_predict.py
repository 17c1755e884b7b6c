"""The slice as a whole: the JAX ``Predictor.from_checkpoint`` (msgpack)
against the port's (from the ``.pt`` that ``save_torch_checkpoint`` writes
for the same variables) on padded buffers — probabilities within 2e-2 with
equal argmax, the bar of tests/test_conv1_fusion.py:150-151 — plus the
port's file API and CLI on the CPU."""

import json

import jax
import numpy as np
import pytest

from speech_intent_recognizer_tpu.convert.torch_export import (
    save_torch_checkpoint)
from speech_intent_recognizer_tpu.infer.predict import (
    Predictor as JaxPredictor)
from speech_intent_recognizer_tpu.models.cnn_gru import (
    CNNAudioGRU as FlaxCNNAudioGRU, init_model)
from speech_intent_recognizer_tpu.train.checkpoint import save_model
from speech_intent_recognizer_tpu_torch.data.audio_io import save_wav
from speech_intent_recognizer_tpu_torch.infer.predict import Predictor


def _wave(rng, n):
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    raw = init_model(FlaxCNNAudioGRU(num_classes=31), jax.random.key(1))
    params = jax.tree.map(np.array, raw["params"])  # writable copies
    stats = jax.tree.map(np.array, raw["batch_stats"])
    r = np.random.default_rng(11)
    for i in (1, 2, 3):
        c = stats[f"bn{i}"]["mean"].shape[0]
        stats[f"bn{i}"] = {
            "mean": (0.1 * r.standard_normal(c)).astype(np.float32),
            "var": r.uniform(0.5, 2.0, c).astype(np.float32)}
    save_model(str(d / "model.msgpack"),
               {"params": params, "batch_stats": stats})
    save_torch_checkpoint(str(d / "model.pt"), params, stats)
    (d / "label_map.json").write_text(
        json.dumps({f"intent_{i}": i for i in range(31)}))
    return d


@pytest.fixture(scope="module")
def port(checkpoints):
    return Predictor.from_checkpoint(str(checkpoints / "model.pt"),
                                     str(checkpoints / "label_map.json"),
                                     device="cpu")


def test_fused_predictor_matches_jax(checkpoints, port):
    rng = np.random.default_rng(5)
    want_pred = JaxPredictor.from_checkpoint(
        str(checkpoints / "model.msgpack"),
        str(checkpoints / "label_map.json"))
    assert want_pred._conv1 is not None and port._conv1 is not None
    lengths = [24000, 12000, 80000, 1537]
    buf = np.zeros((len(lengths), port._buffer_width()), np.float32)
    for i, n in enumerate(lengths):
        buf[i, :n] = _wave(rng, n)
    ln = np.asarray(lengths, np.int32)
    want = want_pred.predict_waveform_batch(buf, ln)
    got = port.predict_waveform_batch(buf, ln)
    assert got.shape == (4, 31)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert (np.argmax(got, -1) == np.argmax(want, -1)).all()
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_unfused_predictor_matches_jax(checkpoints):
    """fold_bn=False serves the fp32 train-form model behind the plain
    front-end, as the JAX predictor does."""
    rng = np.random.default_rng(6)
    args = (str(checkpoints / "label_map.json"),)
    want_pred = JaxPredictor.from_checkpoint(
        str(checkpoints / "model.msgpack"), *args, fold_bn=False)
    got_pred = Predictor.from_checkpoint(str(checkpoints / "model.pt"),
                                         *args, fold_bn=False, device="cpu")
    assert got_pred._conv1 is None
    buf = np.zeros((2, got_pred._buffer_width()), np.float32)
    buf[0, :30000] = _wave(rng, 30000)
    buf[1, :7000] = _wave(rng, 7000)
    ln = np.asarray([30000, 7000], np.int32)
    np.testing.assert_allclose(got_pred.predict_waveform_batch(buf, ln),
                               want_pred.predict_waveform_batch(buf, ln),
                               atol=1e-3)


def test_file_array_directory_api(port, tmp_path):
    rng = np.random.default_rng(8)
    x = _wave(rng, 20000)
    save_wav(str(tmp_path / "a.wav"), x, 16000)
    save_wav(str(tmp_path / "b.wav"), _wave(rng, 9000), 16000)
    (tmp_path / "notes.txt").write_text("not audio")
    r = port.predict_file(str(tmp_path / "a.wav"))
    assert set(r) == {"predicted_label", "confidence", "top_predictions"}
    assert len(r["top_predictions"]) == 3
    assert r["predicted_label"] == r["top_predictions"][0]["label"]
    q = np.round(x * 32767.0) / 32768.0  # what the 16-bit file decodes to
    a = port.predict_array(q, 16000)
    assert a["predicted_label"] == r["predicted_label"]
    assert abs(a["confidence"] - r["confidence"]) < 1e-6
    results = port.predict_directory(str(tmp_path))
    assert [d["file"] for d in results] == ["a.wav", "b.wav"]
    assert port.predict_file(str(tmp_path / "missing.wav")) is None


def test_cli_test_model_on_cpu(checkpoints, tmp_path, capsys):
    from speech_intent_recognizer_tpu_torch.cli.test_model import main

    save_wav(str(tmp_path / "x.wav"), _wave(np.random.default_rng(9), 16000),
             16000)
    result = main(["--model", str(checkpoints / "model.pt"),
                   "--label_map", str(checkpoints / "label_map.json"),
                   "--audio", str(tmp_path / "x.wav"), "--device", "cpu"])
    assert result["predicted_label"].startswith("intent_")
    assert "PREDICTION RESULTS" in capsys.readouterr().out
