"""The slice as a whole: the JAX ``Predictor.from_checkpoint`` (msgpack)
against the port's (from the ``.pt`` that ``save_torch_checkpoint`` writes
for the same variables) on padded buffers — probabilities within 2e-2 with
equal argmax, the bar of tests/test_conv1_fusion.py:150-151 — the two
opt-in configurations (``enable_conv23_kernel``, ``pool_impl="kernel"``)
against the JAX predictor with ``enable_conv23_kernel()`` at the same bar,
plus the port's file API and CLI on the CPU."""

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


def _buffers(port, rng, lengths):
    buf = np.zeros((len(lengths), port._buffer_width()), np.float32)
    for i, n in enumerate(lengths):
        buf[i, :n] = _wave(rng, n)
    return buf, np.asarray(lengths, np.int32)


def test_conv23_predictor_matches_jax(checkpoints, port):
    """K1 -> K5 -> head on both sides (the Pallas kernels in interpret
    mode, the port's plain versions): equal argmax, probabilities within
    2e-2; and within the same bar of the port's default path."""
    args = (str(checkpoints / "label_map.json"),)
    want_pred = JaxPredictor.from_checkpoint(
        str(checkpoints / "model.msgpack"), *args)
    want_pred.enable_conv23_kernel()
    got_pred = Predictor.from_checkpoint(str(checkpoints / "model.pt"),
                                         *args, device="cpu")
    assert got_pred._conv23 is None  # opt-in, not the default
    got_pred.enable_conv23_kernel()
    assert got_pred._conv23 is not None and want_pred._conv23 is not None
    # rows whose top-two margin (>= 4e-4 here) is far above the paths'
    # difference (~2e-5): the seeded model's probabilities are near uniform
    buf, ln = _buffers(port, np.random.default_rng(15),
                       [24000, 9000, 40000, 16000])
    want = want_pred.predict_waveform_batch(buf, ln)
    got = got_pred.predict_waveform_batch(buf, ln)
    assert got.shape == (4, 31)
    assert (np.argmax(got, -1) == np.argmax(want, -1)).all()
    np.testing.assert_allclose(got, want, atol=2e-2)
    default = port.predict_waveform_batch(buf, ln)
    assert (np.argmax(got, -1) == np.argmax(default, -1)).all()
    np.testing.assert_allclose(got, default, atol=2e-2)


def test_pool_impl_kernel_predictor_matches_default(checkpoints, port):
    pred = Predictor.from_checkpoint(str(checkpoints / "model.pt"),
                                     str(checkpoints / "label_map.json"),
                                     device="cpu", pool_impl="kernel")
    assert pred._conv1.model.pool_impl == "kernel"
    assert port._conv1.model.pool_impl == "torch"  # the default
    buf, ln = _buffers(port, np.random.default_rng(16), [30000, 5000])
    np.testing.assert_allclose(pred.predict_waveform_batch(buf, ln),
                               port.predict_waveform_batch(buf, ln),
                               atol=1e-5)


@pytest.mark.parametrize("case", ["geometry", "unfolded", "channels"])
def test_enable_conv23_kernel_refuses(checkpoints, case):
    """The JAX method's conditions and error (predict.py:167-174)."""
    import torch

    from speech_intent_recognizer_tpu_torch.config import AudioConfig
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU

    if case == "channels":  # conv2 of another width: K1 serves, K5 cannot
        model = CNNAudioGRU(31, conv_channels=(32, 48, 128), fold_bn=True)
        model.reset_parameters(torch.Generator().manual_seed(0))
        pred = Predictor(model, {"a": 0}, device="cpu")
        pred._maybe_enable_conv1_fusion(model.state_dict())
        assert pred._conv1 is not None
    else:
        kw = ({"fold_bn": False} if case == "unfolded" else
              {"audio_cfg": AudioConfig(hop_length=256, mel_spec_length=400)})
        pred = Predictor.from_checkpoint(
            str(checkpoints / "model.pt"),
            str(checkpoints / "label_map.json"), device="cpu", **kw)
        assert pred._conv1 is None
    with pytest.raises(ValueError, match="reference geometry and channels"):
        pred.enable_conv23_kernel()


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


@pytest.mark.parametrize("flags", [["--conv23"], ["--pool-impl", "kernel"]])
def test_cli_reaches_the_opt_in_configurations(checkpoints, tmp_path, flags):
    from speech_intent_recognizer_tpu_torch.cli.test_model import main

    save_wav(str(tmp_path / "x.wav"), _wave(np.random.default_rng(9), 16000),
             16000)
    base = ["--model", str(checkpoints / "model.pt"),
            "--label_map", str(checkpoints / "label_map.json"),
            "--audio", str(tmp_path / "x.wav"), "--device", "cpu"]
    want, got = main(base), main(base + flags)
    assert got["predicted_label"] == want["predicted_label"]
    assert abs(got["confidence"] - want["confidence"]) < 2e-2
