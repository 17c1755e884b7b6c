"""Two host paths of the port held to the reference on inputs that once
made them part ways: a WAV file whose data chunk is not a whole number of
samples (``Predictor.predict_file`` / ``predict_directory``), and an
unreadable reference-format ``.pt`` feature cache (``build_dataset``).  In
both the JAX package logs, falls through and goes on; so does the port."""

import functools
import json
import struct

import jax
import numpy as np
import torch

from speech_intent_recognizer_tpu.config.schema import Config as RefConfig
from speech_intent_recognizer_tpu.convert.torch_export import (
    save_torch_checkpoint)
from speech_intent_recognizer_tpu.data import pipeline as ref_pipeline
from speech_intent_recognizer_tpu.infer import predict as ref_predict
from speech_intent_recognizer_tpu.models.cnn_gru import (
    CNNAudioGRU as FlaxCNNAudioGRU, init_model)
from speech_intent_recognizer_tpu.train.checkpoint import save_model
from speech_intent_recognizer_tpu_torch.config import Config
from speech_intent_recognizer_tpu_torch.data import pipeline
from speech_intent_recognizer_tpu_torch.data.audio_io import save_wav
from speech_intent_recognizer_tpu_torch.infer import predict


def _wave(rng, n):
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _odd_wav(path, data_bytes=2001):
    """Mono PCM16 at 16 kHz, 44-byte header, a data chunk of an odd number
    of bytes (not a whole number of 2-byte samples)."""
    data = np.random.default_rng(5).integers(0, 256, data_bytes,
                                             dtype=np.uint8).tobytes()
    header = (b"RIFF" + struct.pack("<I", 36 + data_bytes) + b"WAVE"
              + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2,
                                      16)
              + b"data" + struct.pack("<I", data_bytes))
    assert len(header) == 44
    path.write_bytes(header + data)


def test_predict_directory_skips_a_wav_with_a_partial_sample(tmp_path,
                                                             monkeypatch):
    """The reference logs the undecodable file, returns None for it and
    skips it in the directory; the port returns the same one result."""
    raw = init_model(FlaxCNNAudioGRU(num_classes=31), jax.random.key(2))
    params = jax.tree.map(np.array, raw["params"])
    stats = jax.tree.map(np.array, raw["batch_stats"])
    save_model(str(tmp_path / "model.msgpack"),
               {"params": params, "batch_stats": stats})
    save_torch_checkpoint(str(tmp_path / "model.pt"), params, stats)
    labels = tmp_path / "label_map.json"
    labels.write_text(json.dumps({f"intent_{i}": i for i in range(31)}))
    audio = tmp_path / "audio"
    audio.mkdir()
    _odd_wav(audio / "a_odd.wav")
    save_wav(str(audio / "b_good.wav"), _wave(np.random.default_rng(3),
                                              12000), 16000)
    for module in (predict, ref_predict):
        monkeypatch.setattr(module, "load_audio", functools.partial(
            module.load_audio, prefer_native=False))

    port = predict.Predictor.from_checkpoint(
        str(tmp_path / "model.pt"), str(labels), device="cpu")
    ref = ref_predict.Predictor.from_checkpoint(
        str(tmp_path / "model.msgpack"), str(labels))
    assert port.predict_file(str(audio / "a_odd.wav")) is None
    got = port.predict_directory(str(audio))
    want = ref.predict_directory(str(audio))
    assert [r["file"] for r in got] == [r["file"] for r in want] == [
        "b_good.wav"]
    assert got[0]["predicted_label"] == want[0]["predicted_label"]
    assert abs(got[0]["confidence"] - want[0]["confidence"]) < 2e-2


def test_build_dataset_recomputes_past_an_unreadable_legacy_cache(tmp_path):
    """A garbage ``train_features.pt`` beside no ``.npz``: both packages warn
    and precompute the two-row manifest instead of raising."""
    rng = np.random.default_rng(4)
    rows = []
    for i, n in enumerate((16000, 9000)):
        path = tmp_path / f"u{i}.wav"
        save_wav(str(path), _wave(rng, n), 16000)
        rows.append(f"{path},intent_{i}\n")
    csv = tmp_path / "train.csv"
    csv.write_text("file_path,intent\n" + "".join(rows))
    cache_dir = tmp_path / "cache"
    cache_dir.mkdir()
    (cache_dir / "train_features.pt").write_bytes(b"not a torch pickle file!!")
    assert len((cache_dir / "train_features.pt").read_bytes()) == 25
    label_map = {"intent_0": 0, "intent_1": 1}
    flat = {"cache_dir": str(cache_dir), "precompute_batch_size": 2}

    got = pipeline.build_dataset(str(csv), label_map, Config.from_dict(flat),
                                 device="cpu")
    (cache_dir / "train_features.npz").unlink()
    want = ref_pipeline.build_dataset(str(csv), label_map,
                                      RefConfig.from_dict(flat), store=False)
    assert got.num_items == want.num_items == 2
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    assert torch.isfinite(got.features).all()
    np.testing.assert_allclose(got.features.numpy(),
                               np.asarray(want.features), atol=5e-2)
