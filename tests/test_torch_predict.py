"""The slice as a whole: the JAX ``Predictor.from_checkpoint`` (msgpack)
against the port's (from the ``.pt`` that ``save_torch_checkpoint`` writes
for the same variables) on padded buffers — probabilities within 2e-2 with
equal argmax, the bar of tests/test_conv1_fusion.py:150-151.  The port's
default serves conv2 + conv3 in K5 where its contract holds, so it is held
to the JAX predictor with ``enable_conv23_kernel()`` (the same structure),
and the port's torch epilogues (the form the rule serves off K5's
contract, given through ``Predictor._serve_k1``) to the JAX default; the
rule that picks K1's and K5's forms, and where K5 runs inside the model;
plus the port's file API and CLI on the CPU."""

import json

import jax
import numpy as np
import pytest
import torch

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


@pytest.fixture(scope="module")
def torch_port(checkpoints):
    """The port's fused path with torch's epilogues after conv2 / conv3:
    the default predictor's K1 seam given that form."""
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
        conv1_external_params)

    pred = Predictor.from_checkpoint(str(checkpoints / "model.pt"),
                                     str(checkpoints / "label_map.json"),
                                     device="cpu")
    pred._serve_k1(*conv1_external_params(pred.model.state_dict()))
    return pred


def test_fused_predictor_matches_jax(checkpoints, torch_port):
    """conv2 / conv3 through ``F.conv2d`` and torch's epilogues, the
    structure of the JAX default."""
    rng = np.random.default_rng(5)
    want_pred = JaxPredictor.from_checkpoint(
        str(checkpoints / "model.msgpack"),
        str(checkpoints / "label_map.json"))
    assert want_pred._conv1 is not None and torch_port._conv1 is not None
    assert want_pred._conv23 is None
    assert not torch_port._conv1.model.conv23
    lengths = [24000, 12000, 80000, 1537]
    buf = np.zeros((len(lengths), torch_port._buffer_width()), np.float32)
    for i, n in enumerate(lengths):
        buf[i, :n] = _wave(rng, n)
    ln = np.asarray(lengths, np.int32)
    want = want_pred.predict_waveform_batch(buf, ln)
    got = torch_port.predict_waveform_batch(buf, ln)
    assert got.shape == (4, 31)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert (np.argmax(got, -1) == np.argmax(want, -1)).all()
    np.testing.assert_allclose(got, want, atol=2e-2)


def _buffers(port, rng, lengths):
    buf = np.zeros((len(lengths), port._buffer_width()), np.float32)
    for i, n in enumerate(lengths):
        buf[i, :n] = _wave(rng, n)
    return buf, np.asarray(lengths, np.int32)


def test_conv23_predictor_matches_jax(checkpoints, port, torch_port):
    """K1 -> K5 -> head on both sides (the Pallas kernels in interpret
    mode, the port's plain versions): the port's default against the JAX
    predictor with ``enable_conv23_kernel()``, equal argmax, probabilities
    within 2e-2; and within the same bar of the port's torch epilogues."""
    args = (str(checkpoints / "label_map.json"),)
    want_pred = JaxPredictor.from_checkpoint(
        str(checkpoints / "model.msgpack"), *args)
    want_pred.enable_conv23_kernel()
    assert want_pred._conv23 is not None
    assert port._conv1.model.conv23  # the default, by K5's contract
    # rows whose top-two margin (>= 4e-4 here) is far above the paths'
    # difference (~2e-5): the seeded model's probabilities are near uniform
    buf, ln = _buffers(port, np.random.default_rng(15),
                       [24000, 9000, 40000, 16000])
    want = want_pred.predict_waveform_batch(buf, ln)
    got = port.predict_waveform_batch(buf, ln)
    assert got.shape == (4, 31)
    assert (np.argmax(got, -1) == np.argmax(want, -1)).all()
    np.testing.assert_allclose(got, want, atol=2e-2)
    torch_ep = torch_port.predict_waveform_batch(buf, ln)
    assert (np.argmax(got, -1) == np.argmax(torch_ep, -1)).all()
    np.testing.assert_allclose(got, torch_ep, atol=2e-2)


def test_default_serves_k5_at_the_reference_geometry(port):
    """``from_checkpoint`` at the reference geometry and channels: the
    ``conv1_external`` variant in the ``conv23`` form, K5's operands its
    buffers and no conv module left in it."""
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
        CONV23_BUFFERS)
    from speech_intent_recognizer_tpu_torch.ops.conv23 import (
        W2_SHAPE, W3_SHAPE)

    body = port._fused_body()
    model = body.model
    assert body is port._conv1 and body.with_conv1
    assert model.conv1_external and model.conv23
    assert model.compute_dtype == torch.bfloat16
    assert list(model._stages) == []
    assert not any(n.startswith("conv") for n, _ in model.named_children())
    shapes = [tuple(getattr(model, n).shape) for n in CONV23_BUFFERS]
    assert shapes == [W2_SHAPE, (64,), W3_SHAPE, (128,)]
    state = body.state_dict()
    assert all(f"model.{n}" in state for n in CONV23_BUFFERS)
    assert not any(k.startswith(("model.conv2.", "model.conv3."))
                   for k in state)


# the rule's table: the audio geometry (AudioConfig's fields) and the
# conv stack's channels -> the form that serves
RULE_CASES = {
    "reference": ({}, (32, 64, 128), "conv23"),
    "librosa": ({"frontend": "librosa"}, (32, 64, 128), "unfused"),
    "n_fft_512": ({"n_fft": 512}, (32, 64, 128), "unfused"),
    "hop_256": ({"hop_length": 256}, (32, 64, 128), "unfused"),
    "n_mels_40": ({"n_mels": 40}, (32, 64, 128), "unfused"),
    "frames_202": ({"mel_spec_length": 202}, (32, 64, 128), "unfused"),
    "conv1_16": ({}, (16, 64, 128), "unfused"),
    "conv2_48": ({}, (32, 48, 128), "torch"),
    "conv3_96": ({}, (32, 64, 96), "torch"),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_rule_picks_the_serving_form(case):
    """The one rule of the conv stage (``fk.conv1_engages`` for K1,
    ``k5.engages`` for K5) on a folded model's state: K1 with K5 at the
    reference geometry and channels; K1 with torch's epilogues where only
    K5's channels differ; the unfused model wherever K1 does not serve.
    The form is built, not run."""
    from speech_intent_recognizer_tpu_torch.config import AudioConfig
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU

    audio, chans, want = RULE_CASES[case]
    model = CNNAudioGRU(4, conv_channels=chans, gru_hidden=8, fold_bn=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    pred = Predictor(model, {f"i{i}": i for i in range(4)},
                     AudioConfig(**audio), device="cpu")
    pred._maybe_enable_conv1_fusion(model.state_dict())
    body = pred._fused_body()
    if want == "unfused":
        assert pred._conv1 is None and body.model is model
        assert not body.with_conv1
        return
    variant = body.model
    assert body is pred._conv1 and body.with_conv1
    assert variant.conv1_external and variant.pool_impl == "torch"
    assert variant.compute_dtype == torch.bfloat16
    assert variant.conv23 == (want == "conv23")
    assert list(variant._stages) == ([] if want == "conv23" else [2, 3])


@pytest.mark.parametrize("case", ["channels", "time"])
def test_off_contract_keeps_torch_epilogues(tmp_path, monkeypatch, case):
    """Off K5's contract the rule keeps torch's epilogues: conv2 of another
    width under K1 (the torch form of the variant), or a
    ``mel_spec_length`` off K1's 200 frames (K1 does not serve: the
    unfused model's convs); K5 never runs."""
    from speech_intent_recognizer_tpu_torch.config import AudioConfig
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
    from speech_intent_recognizer_tpu_torch.ops import conv23 as k5

    chans = (32, 48, 128) if case == "channels" else (32, 64, 128)
    model = CNNAudioGRU(4, conv_channels=chans, gru_hidden=32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "m.pt")
    (tmp_path / "lm.json").write_text(json.dumps(
        {f"i{i}": i for i in range(4)}))
    cfg = AudioConfig(mel_spec_length=202) if case == "time" else None
    pred = Predictor.from_checkpoint(str(tmp_path / "m.pt"),
                                     str(tmp_path / "lm.json"),
                                     audio_cfg=cfg, device="cpu")
    body = pred._fused_body()
    if case == "channels":
        assert body.with_conv1 and not body.model.conv23
        assert body.model.pool_impl == "torch"
    else:
        assert not body.with_conv1 and body.model is pred.model
    assert not body.model.conv23 and list(body.model._stages)[-2:] == [2, 3]
    calls = []
    real = k5.conv23
    monkeypatch.setattr(
        k5, "conv23", lambda *a, **k: calls.append(1) or real(*a, **k))
    buf, ln = _buffers(pred, np.random.default_rng(17), [20000, 7000])
    probs = pred.predict_waveform_batch(buf, ln)
    assert calls == [] and probs.shape == (2, 4)
    assert np.isfinite(probs).all()
    with pytest.raises(ValueError, match="reference geometry and channels"):
        pred.enable_conv23_kernel()


def test_enable_conv23_kernel_on_the_default_changes_nothing(checkpoints,
                                                             port):
    """Where K5 already serves, ``enable_conv23_kernel()`` keeps the same
    serving body (same module, same outputs)."""
    pred = Predictor.from_checkpoint(str(checkpoints / "model.pt"),
                                     str(checkpoints / "label_map.json"),
                                     device="cpu")
    body = pred._fused_body()
    buf, ln = _buffers(pred, np.random.default_rng(18), [26000, 4000])
    before = pred.predict_waveform_batch(buf, ln)
    pred.enable_conv23_kernel()
    assert pred._fused_body() is body
    np.testing.assert_array_equal(pred.predict_waveform_batch(buf, ln),
                                  before)


def test_k5_launches_inside_the_model_before_its_gru(port, monkeypatch):
    """Where a trace attributes K5: with forward pre-hooks on
    ``CNNAudioGRU`` and ``TorchGRU`` and a wrapper on
    ``ops.conv23.conv23``, the one ``conv23`` call of a batch comes after
    the model's forward begins and before its GRU's, on CPU tensors (the
    plain version), with K1's sheet in and K5's out."""
    from speech_intent_recognizer_tpu_torch.ops import conv23 as k5

    events = []
    real = k5.conv23

    def spy(x, *ops, **kw):
        events.append(("conv23", x.device.type, tuple(x.shape)))
        out = real(x, *ops, **kw)
        torch.testing.assert_close(out, k5._conv23_plain(x, *ops),
                                   rtol=0, atol=0)
        return out

    monkeypatch.setattr(k5, "conv23", spy)
    model = port._fused_body().model
    hooks = [model.register_forward_pre_hook(
                 lambda *_: events.append(("CNNAudioGRU",))),
             model.gru.register_forward_pre_hook(
                 lambda *_: events.append(("TorchGRU",))),
             model.register_forward_hook(
                 lambda *_: events.append(("CNNAudioGRU end",)))]
    try:
        buf, ln = _buffers(port, np.random.default_rng(19), [30000, 12000])
        port.predict_waveform_batch(buf, ln)
    finally:
        for h in hooks:
            h.remove()
    assert events == [("CNNAudioGRU",), ("conv23", "cpu", (2, 100, 1024)),
                      ("TorchGRU",), ("CNNAudioGRU end",)]


@pytest.mark.parametrize("case", ["geometry", "unfolded", "channels"])
def test_enable_conv23_kernel_refuses(checkpoints, case):
    """The JAX method's conditions and error (predict.py:167-174)."""
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
