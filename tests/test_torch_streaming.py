"""The port's streaming path against the JAX package's on the same seeded
inputs, with a narrow model on both sides (conv 8/16/16, GRU hidden 32, 4
classes; weights carried by ``jax_bridge``):

* the featurizer, mode for mode, over chunk sizes 1024, 333 and 4096 and
  signal lengths 1, 2, 511, 512, 513, 20000 and past the 5 s cap: ``host``
  bit-equal in fp32 and fp64, ``native`` bit-equal, ``device`` (K4's plain
  version here) within rtol / atol 1e-4 dB, the bar of
  tests/test_torch_mel_db.py;
* the fused finalize against ``_build_fused_finalize`` on the same
  operands: probabilities within atol 1e-5, equal argmax;
* the recognizer end to end (within 1e-5 of the JAX recognizer), the
  ``async_results`` Mapping protocol, ``get_all``, ``partial_result`` and
  streaming against the offline ``predict_array`` (the bars of
  tests/test_infer.py);
* ``BatchFinalizer``: rows within 1e-5 of the single finalize, lazy
  dispatch, ``max_batch`` auto-flush, K4 once and K2 twice per flush;
* the ``stream`` CLI replaying a file and ``serve --help`` on the CPU.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu.config.schema import (
    AudioConfig as JaxAudioConfig)
from speech_intent_recognizer_tpu.infer import streaming as jax_streaming
from speech_intent_recognizer_tpu.infer.predict import (
    Predictor as JaxPredictor)
from speech_intent_recognizer_tpu.models.cnn_gru import (
    CNNAudioGRU as FlaxCNNAudioGRU, init_model)
from speech_intent_recognizer_tpu_torch.config import AudioConfig
from speech_intent_recognizer_tpu_torch.convert.jax_bridge import (
    from_jax_variables)
from speech_intent_recognizer_tpu_torch.data import native
from speech_intent_recognizer_tpu_torch.data.audio_io import save_wav
from speech_intent_recognizer_tpu_torch.infer import streaming
from speech_intent_recognizer_tpu_torch.infer.predict import Predictor
from speech_intent_recognizer_tpu_torch.infer.streaming import (
    BatchFinalizer, PendingResult, StreamingFeaturizer, StreamingRecognizer,
    fused_finalize)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
from speech_intent_recognizer_tpu_torch.ops import frontend_kernels as fk
from speech_intent_recognizer_tpu_torch.ops import gru as gru_ops
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    make_frontend_params)

NARROW = dict(conv_channels=(8, 16, 16), gru_hidden=32)
LABELS = {f"intent_{i}": i for i in range(4)}
CHUNKS = (1024, 333, 4096)
LENGTHS = (1, 2, 511, 512, 513, 20000, 85000)  # 85000: past the 5 s cap
DEVICE_TOL = 1e-4  # dB: K4 against the JAX DFT matmuls
PROB_TOL = 1e-5


def _speech_like(rng, n, amp=0.2):
    return (amp * np.sin(2 * np.pi * 300 * np.arange(n) / 16000)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


def _utterance(seed, n):
    r = np.random.default_rng(seed)
    return (0.2 * np.sin(2 * np.pi * r.uniform(200, 400)
                         * np.arange(n) / 16000)
            + 0.02 * r.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(JAX predictor, port predictor on the CPU) with the same narrow
    train-form weights and non-trivial BatchNorm statistics."""
    model = FlaxCNNAudioGRU(num_classes=4, **NARROW)
    raw = init_model(model, jax.random.key(0))
    params = jax.tree.map(np.array, raw["params"])
    stats = jax.tree.map(np.array, raw["batch_stats"])
    r = np.random.default_rng(3)
    for name in stats:
        c = stats[name]["mean"].shape[0]
        stats[name] = {"mean": (0.1 * r.standard_normal(c)).astype(np.float32),
                       "var": r.uniform(0.5, 2.0, c).astype(np.float32)}
    want = JaxPredictor(model, {"params": params, "batch_stats": stats},
                        LABELS)
    port_model = CNNAudioGRU(4, **NARROW)
    port_model.load_state_dict(from_jax_variables(params, stats))
    return want, Predictor(port_model, LABELS, device="cpu")


# ---------------------------------------------------------------- featurizer


def _featurizers(mode, dtype=np.float32):
    if mode == "native" and not native.available():
        pytest.skip("native libsirdsp not built")
    kw = {"host_dtype": dtype} if mode == "host" else {}
    want = jax_streaming.StreamingFeaturizer(audio_cfg=JaxAudioConfig(),
                                             mode=mode, **kw)
    got = StreamingFeaturizer(audio_cfg=AudioConfig(), mode=mode,
                              device="cpu", **kw)
    assert got.mode == want.mode == mode
    return want, got


def _run(want, got, x, chunk):
    for i in range(0, max(len(x), 1), chunk):
        assert got.feed(x[i : i + chunk]) == want.feed(x[i : i + chunk])
    return ((got.partial_features(), want.partial_features()),
            (got.finalize(), want.finalize()))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("n", LENGTHS)
def test_host_featurizer_bit_equal(dtype, chunk, n):
    want, got = _featurizers("host", dtype)
    x = _speech_like(np.random.default_rng(n), n)
    for a, b in _run(want, got, x, chunk):
        assert a.shape == b.shape == (64, 200)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("n", LENGTHS)
def test_native_featurizer_bit_equal(chunk, n):
    want, got = _featurizers("native")
    x = _speech_like(np.random.default_rng(n), n)
    for a, b in _run(want, got, x, chunk):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("n", LENGTHS)
def test_device_featurizer_within_k4_bar(chunk, n):
    """``device`` mode: K4's plain version in 16-frame blocks against the
    JAX DFT matmuls, features within 1e-4."""
    want, got = _featurizers("device")
    x = _speech_like(np.random.default_rng(n), n)
    for a, b in _run(want, got, x, chunk):
        np.testing.assert_allclose(a, b, rtol=DEVICE_TOL, atol=DEVICE_TOL)


def test_partial_features_counts_and_reset():
    """Shape, the frame count after each chunk, bit-equal partial features
    mid-stream, and a reset featurizer reproducing its first result."""
    want, got = _featurizers("host")
    x = _speech_like(np.random.default_rng(5), 8192)
    for i in range(0, len(x), 1024):
        done = got.feed(x[i : i + 1024])
        assert done == want.feed(x[i : i + 1024])
        assert done == (i + 1024 + 512 - 1024) // 512 + 1
        np.testing.assert_array_equal(got.partial_features(),
                                      want.partial_features())
    assert got.partial_features().shape == (64, 200)
    first = got.finalize()
    got.reset()
    for i in range(0, len(x), 1024):
        got.feed(x[i : i + 1024])
    np.testing.assert_array_equal(got.finalize(), first)


@pytest.mark.parametrize("win_length", [1024, 800, 512, 401])
def test_window_is_the_kernels_window(win_length):
    """The host modes' window (the JAX DFT matrices' window) and K4's
    ``FrontendParams.window`` are the same array for every win_length."""
    cfg = AudioConfig(win_length=win_length)
    hann = streaming.golden_hann(cfg.n_fft, cfg)
    np.testing.assert_array_equal(
        hann, jax_streaming.golden_hann(cfg.n_fft,
                                        JaxAudioConfig(win_length=win_length)))
    np.testing.assert_array_equal(hann.astype(np.float32),
                                  make_frontend_params(cfg).window.numpy())


def test_auto_mode_picks_and_logs(monkeypatch, caplog):
    caplog.set_level(logging.INFO, logger=streaming.__name__)
    fz = StreamingFeaturizer(mode="auto")
    assert fz.mode == ("native" if native.available() else "host")
    monkeypatch.setattr(native, "available", lambda: False)
    fz = StreamingFeaturizer(mode="auto")
    assert fz.mode == "host"
    assert "auto mode asked, host mode runs" in caplog.text
    with pytest.raises(ValueError, match="unknown streaming mode"):
        StreamingFeaturizer(mode="gpu")


# ------------------------------------------------------------ fused finalize


@pytest.fixture(scope="module")
def jax_fused(pair):
    want, _ = pair
    rec = jax_streaming.StreamingRecognizer(want, featurizer_mode="host")
    return rec._build_fused_finalize()


@pytest.mark.parametrize("count,n_tail", [(0, 0), (0, 4), (37, 2), (37, 0),
                                          (196, 4), (198, 4), (199, 1),
                                          (200, 0), (200, 3)])
def test_fused_finalize_matches_jax(pair, jax_fused, count, n_tail):
    want, port = pair
    r = np.random.default_rng(count * 10 + n_tail)
    mel = np.zeros((200, 64), np.float32)
    mel[:count] = r.uniform(-80.0, 10.0, (count, 64))
    tail = np.zeros((4, 1024), np.float32)
    tail[:n_tail] = _speech_like(r, n_tail * 1024).reshape(n_tail, 1024)
    expect = np.asarray(jax_fused(want.variables, jnp.asarray(mel),
                                  jnp.int32(count), jnp.asarray(tail),
                                  jnp.int32(n_tail)))
    got = fused_finalize(port.model, port.frontend_params, mel[None],
                         np.asarray([count]), tail[None],
                         np.asarray([n_tail]))[0].numpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, expect, atol=PROB_TOL)
    assert np.argmax(got) == np.argmax(expect)


@pytest.mark.parametrize("count,n_silent,n_tail", [(120, 30, 2), (200, 60, 0),
                                                   (190, 47, 4)])
def test_fused_finalize_digital_silence_matches_jax(pair, jax_fused, count,
                                                    n_silent, n_tail):
    """The end of an utterance padded with digital zeros (what
    ``FileAudioSource`` replays): the last ``n_silent`` rows at exactly
    -100 dB and all-zero tail frames, port against JAX."""
    want, port = pair
    r = np.random.default_rng(count + n_silent)
    mel = np.zeros((200, 64), np.float32)
    mel[:count - n_silent] = r.uniform(-80.0, 10.0, (count - n_silent, 64))
    mel[count - n_silent:count] = -100.0
    tail = np.zeros((4, 1024), np.float32)
    expect = np.asarray(jax_fused(want.variables, jnp.asarray(mel),
                                  jnp.int32(count), jnp.asarray(tail),
                                  jnp.int32(n_tail)))
    got = fused_finalize(port.model, port.frontend_params, mel[None],
                         np.asarray([count]), tail[None],
                         np.asarray([n_tail]))[0].numpy()
    np.testing.assert_allclose(got, expect, atol=PROB_TOL)
    assert np.argmax(got) == np.argmax(expect)


# --------------------------------------------------------------- recognizer


def _stream(rec, x, chunk=1024, stop=False):
    result = None
    for i in range(0, len(x) - chunk, chunk):
        r = rec.feed(x[i : i + chunk])
        if r is not None:
            result = r
            if stop:
                break
    return result


def _same_result(got, want, tol=PROB_TOL):
    assert got["predicted_label"] == want["predicted_label"]
    assert abs(got["confidence"] - want["confidence"]) < tol
    for a, b in zip(got["top_predictions"], want["top_predictions"]):
        assert a["label"] == b["label"]
        assert abs(a["probability"] - b["probability"]) < tol


def test_end_to_end_utterance_matches_jax(pair):
    want, port = pair
    stream = np.concatenate([_speech_like(np.random.default_rng(1), 16000),
                             np.zeros(12000, np.float32)])
    got = _stream(StreamingRecognizer(port, silence_limit=0.5,
                                      featurizer_mode="host"), stream)
    expect = _stream(jax_streaming.StreamingRecognizer(
        want, silence_limit=0.5, featurizer_mode="host"), stream)
    assert got is not None and expect is not None
    assert got["predicted_label"].startswith("intent_")
    assert 0.0 <= got["confidence"] <= 1.0
    assert len(got["top_predictions"]) == 3
    _same_result(got, expect)


def test_async_results_mode(pair):
    """Every assertion of tests/test_infer.py's async test on the port."""
    _, port = pair
    sync = StreamingRecognizer(port, silence_limit=0.5)
    asyn = StreamingRecognizer(port, silence_limit=0.5, async_results=True)
    stream = np.concatenate([_speech_like(np.random.default_rng(2), 16000),
                             np.zeros(12000, np.float32)])
    got_sync = got_async = None
    for i in range(0, len(stream) - 1024, 1024):
        chunk = stream[i : i + 1024]
        r1 = sync.feed(chunk)
        r2 = asyn.feed(chunk)
        got_sync = r1 if r1 is not None else got_sync
        got_async = r2 if r2 is not None else got_async
    assert got_sync is not None and got_async is not None
    assert isinstance(got_sync, dict)
    assert isinstance(got_async, PendingResult)
    resolved = got_async.get()
    assert resolved["predicted_label"] == got_sync["predicted_label"]
    assert resolved["confidence"] == got_sync["confidence"]
    assert got_async["predicted_label"] == got_sync["predicted_label"]
    assert got_async.ready()
    assert got_async.get("predicted_label") == got_sync["predicted_label"]
    assert got_async.get("no_such_key", 42) == 42
    assert "confidence" in got_async
    assert set(got_async) == set(got_sync)
    assert dict(got_async) == got_sync
    assert dict(got_async.items()) == got_sync
    assert len(got_async) == len(got_sync)
    assert got_async.resolve() is got_async.resolve()


def test_pending_result_get_all(pair):
    _, port = pair
    stream = np.concatenate([_speech_like(np.random.default_rng(4), 16000),
                             np.zeros(12000, np.float32)])
    pending = []
    for _ in range(3):
        rec = StreamingRecognizer(port, silence_limit=0.5, async_results=True)
        for i in range(0, len(stream) - 1024, 1024):
            r = rec.feed(stream[i : i + 1024])
            if r is not None:
                pending.append(r)
    assert len(pending) == 3
    assert all(r.ready() for r in pending)  # CPU tensors: ready at once
    resolved = PendingResult.get_all(pending + pending[:1])
    assert len(resolved) == 4
    assert len({d["predicted_label"] for d in resolved}) == 1
    assert len({d["confidence"] for d in resolved}) == 1
    again = PendingResult.get_all(pending)
    assert again[0] is resolved[0]


def test_partial_result_midstream_matches_jax(pair):
    want, port = pair
    speech = _speech_like(np.random.default_rng(6), 8192)
    got_rec = StreamingRecognizer(port, silence_limit=1.0)
    want_rec = jax_streaming.StreamingRecognizer(want, silence_limit=1.0)
    assert got_rec.partial_result() is None  # not recording yet
    for i in range(0, len(speech), 1024):
        got_rec.feed(speech[i : i + 1024])
        want_rec.feed(speech[i : i + 1024])
    assert got_rec.recording
    got = got_rec.partial_result()
    assert got["predicted_label"].startswith("intent_")
    _same_result(got, want_rec.partial_result())


def test_async_partial_result_is_pending(pair):
    """With ``async_results`` the mid-utterance hypothesis is a
    ``PendingResult`` (what the server's drain loop sends once ready),
    equal to the synchronous dict."""
    _, port = pair
    speech = _speech_like(np.random.default_rng(8), 8192)
    recs = [StreamingRecognizer(port, silence_limit=1.0, async_results=a)
            for a in (False, True)]
    for rec in recs:
        for i in range(0, len(speech), 1024):
            rec.feed(speech[i : i + 1024])
    want, got = (rec.partial_result() for rec in recs)
    assert isinstance(want, dict) and isinstance(got, PendingResult)
    assert got.ready() and dict(got) == want


class _KeepOperands(StreamingRecognizer):
    def finalize_operands(self):
        self.operands = super().finalize_operands()
        return self.operands


@pytest.mark.parametrize("mode", ["host", "native"])
def test_file_replay_digital_silence_matches_jax(pair, tmp_path, mode):
    """``cli.stream --audio``'s path: ``FileAudioSource`` pads the file
    with 1.5 s of digital zeros and ``run_live`` drives the recognizer at
    the CLI's defaults.  The -100 dB rows this puts into the buffer reach
    the finalize (checked), and the port's results equal the JAX package's
    within 1e-5: what the replay answers is the reference's arithmetic."""
    from speech_intent_recognizer_tpu.infer import mic as jax_mic
    from speech_intent_recognizer_tpu_torch.infer import mic

    if mode == "native" and not native.available():
        pytest.skip("native libsirdsp not built")
    want, port = pair
    path = str(tmp_path / "x.wav")
    save_wav(path, _utterance(10, 30000), 16000)
    rec = _KeepOperands(port, featurizer_mode=mode)
    got = mic.run_live(rec, mic.FileAudioSource(path))
    expect = jax_mic.run_live(
        jax_streaming.StreamingRecognizer(want, featurizer_mode=mode),
        jax_mic.FileAudioSource(path))
    mel, count = rec.operands[:2]
    assert (mel[:count] <= -99.99).all(axis=1).sum() >= 16  # the floor
    assert len(got) == len(expect) == 1
    _same_result(got[0], expect[0])


def test_streaming_equals_offline_prediction(pair):
    """tests/test_infer.py:278-299 on the port: the streamed utterance and
    the port's offline ``predict_array`` agree (same label, confidence
    within 0.05: the silence tail inside the VAD window shifts the
    features slightly)."""
    _, port = pair
    x = _speech_like(np.random.default_rng(7), 20000)
    offline = port.predict_array(x, 16000)
    rec = StreamingRecognizer(port, silence_limit=0.25, threshold=0.005,
                              prior_recording=0.0)
    result = _stream(rec, np.concatenate([x, np.zeros(8000, np.float32)]),
                     stop=True)
    assert result is not None
    assert result["predicted_label"] == offline["predicted_label"]
    assert abs(result["confidence"] - offline["confidence"]) < 0.05


# ------------------------------------------------------------ batched finalize


class _Counts:
    """Counts the plain K4 and K2 calls (what launches on the card)."""

    def __init__(self, monkeypatch):
        self.k4 = self.k2 = 0
        mel_db_plain, gru_plain = fk._mel_db_plain, gru_ops._gru_layer_plain

        def k4(*args, **kw):
            self.k4 += 1
            return mel_db_plain(*args, **kw)

        def k2(*args, **kw):
            self.k2 += 1
            return gru_plain(*args, **kw)

        monkeypatch.setattr(fk, "_mel_db_plain", k4)
        monkeypatch.setattr(gru_ops, "_gru_layer_plain", k2)


def _fed(port, x, **kw):
    rec = StreamingRecognizer(port, silence_limit=10.0, **kw)
    for j in range(0, len(x), 1024):
        rec.feed(x[j : j + 1024])
    return rec


def test_batch_matches_single_call_finalize(pair, monkeypatch):
    _, port = pair
    batcher = BatchFinalizer(port, max_batch=16)
    singles, deferred = [], []
    counts = _Counts(monkeypatch)
    for i, n in enumerate([16000, 23456, 40001]):
        x = _utterance(i, n)
        single = _fed(port, x, featurizer_mode="host")
        batched = _fed(port, x, featurizer_mode="host", async_results=True,
                       batch_finalizer=batcher)
        counts.k4 = counts.k2 = 0
        singles.append(single.flush())
        assert (counts.k4, counts.k2) == (1, 2)  # per single finalize
        r = batched.flush()
        assert not r.ready()  # queued, not dispatched
        deferred.append(r)
    counts.k4 = counts.k2 = 0
    assert batcher.flush() == 3
    assert (counts.k4, counts.k2) == (1, 2)  # one pass for all three
    assert batcher.flush() == 0
    for want, have in zip(singles, PendingResult.get_all(deferred)):
        _same_result(have, want)


def test_lazy_dispatch_on_resolve(pair):
    _, port = pair
    batcher = BatchFinalizer(port)
    rec = _fed(port, _utterance(7, 20000), async_results=True,
               batch_finalizer=batcher)
    r = rec.flush()
    assert not r.ready()
    out = r.resolve()  # forces the flush
    assert out["predicted_label"] in port.label_map
    assert len(batcher._queue) == 0


def test_max_batch_auto_flush(pair):
    _, port = pair
    batcher = BatchFinalizer(port, max_batch=2)
    recs = [_fed(port, _utterance(i + 20, 16000), async_results=True,
                 batch_finalizer=batcher) for i in range(2)]
    r1 = recs[0].flush()
    assert len(batcher._queue) == 1
    r2 = recs[1].flush()  # hits max_batch=2 -> dispatched
    assert len(batcher._queue) == 0
    assert r1.ready() and r2.ready()
    assert r2.resolve()["predicted_label"] in port.label_map


# ----------------------------------------------------------------------- CLIs


def test_stream_cli_replays_a_file(pair, tmp_path, capsys):
    from speech_intent_recognizer_tpu_torch.cli.stream import main

    _, port = pair
    torch.save(port.model.state_dict(), tmp_path / "model.pt")
    (tmp_path / "label_map.json").write_text(json.dumps(LABELS))
    save_wav(str(tmp_path / "x.wav"), _utterance(9, 20000), 16000)
    results = main(["--model", str(tmp_path / "model.pt"),
                    "--label_map", str(tmp_path / "label_map.json"),
                    "--audio", str(tmp_path / "x.wav"), "--device", "cpu"])
    assert len(results) == 1
    assert results[0]["predicted_label"] in LABELS
    assert "INTENT RECOGNITION RESULTS" in capsys.readouterr().out


def test_serve_cli_help(capsys):
    from speech_intent_recognizer_tpu_torch.cli.serve import main

    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--socket" in out and "--device" in out
