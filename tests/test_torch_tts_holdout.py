"""The TTS-holdout evaluation of the port against the JAX package's:

* ``evaluate_tts_directory`` of both packages, fed one stub predictor,
  writes byte-equal ``detailed_results.csv`` and
  ``classification_report.csv`` (labeled files right and wrong, a file
  missing from ``details.csv``, an expected label outside the label map,
  and a listed file that ``predict_directory`` skipped as a partial WAV);
* each package's ``cli/test_tts_samples`` on the CPU over a few synthetic
  WAVs of one seeded checkpoint and a WAV with a partial sample (both skip
  it): equal predicted labels, confidences within the bar
  ``tests/test_torch_predict.py`` holds the predictor to (2e-2).
  The checkpoint is a full-width ``.msgpack``: the JAX
  ``Predictor.from_checkpoint`` builds the default widths
  (``infer/predict.py:100-111`` there), so a narrow one does not load
  there."""

import csv
import filecmp
import functools
import json
import os
import struct
import sys

import jax
import numpy as np
import pytest

from speech_intent_recognizer_tpu.evaluation.tts_holdout import (
    evaluate_tts_directory as jax_evaluate)
from speech_intent_recognizer_tpu.tts.generate import generate_audio_files
from speech_intent_recognizer_tpu_torch.evaluation.tts_holdout import (
    evaluate_tts_directory)

CSVS = ("detailed_results.csv", "classification_report.csv")
CLASSES = ("activate_lamp", "bring_shoes", "deactivate_music", "increase_heat")


class StubPredictor:
    """What ``evaluate_tts_directory`` reads of a predictor."""

    def __init__(self, results):
        self.label_map = {c: i for i, c in enumerate(CLASSES)}
        self.inv_label_map = {i: c for c, i in self.label_map.items()}
        self._results = results

    def predict_directory(self, audio_dir):
        return [dict(r) for r in self._results]


def _details(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "text", "class"])
        w.writerows(rows)


@pytest.fixture
def holdout_dir(tmp_path):
    d = tmp_path / "tts"
    d.mkdir()
    _details(d / "details.csv", [
        ("001_a.wav", "switch the lamp on", "activate_lamp"),
        ("002_b.wav", "bring my shoes", "bring_shoes"),
        ("003_c.wav", "stop the music", "deactivate_music"),
        ("004_d.wav", "make it warmer", "increase_heat"),
        ("005_e.wav", "open the window", "open_window"),  # not in the map
        ("006_f.wav", "turn it up", "increase_heat"),  # skipped: partial
    ])
    results = [
        {"file": "001_a.wav", "predicted_label": "activate_lamp",
         "confidence": 0.91},
        {"file": "002_b.wav", "predicted_label": "deactivate_music",
         "confidence": 0.4123456789},
        {"file": "003_c.wav", "predicted_label": "deactivate_music",
         "confidence": 0.7},
        {"file": "004_d.wav", "predicted_label": "increase_heat",
         "confidence": 1.0 / 3.0},
        {"file": "005_e.wav", "predicted_label": "activate_lamp",
         "confidence": 0.5},
        {"file": "extra.wav", "predicted_label": "bring_shoes",  # unlabeled
         "confidence": 0.25},
    ]
    return d, StubPredictor(results)


def test_holdout_csvs_byte_equal_to_jax(tmp_path, holdout_dir):
    d, stub = holdout_dir
    mine = evaluate_tts_directory(stub, str(d),
                                  report_dir=str(tmp_path / "port"))
    theirs = jax_evaluate(stub, str(d), report_dir=str(tmp_path / "jax"))
    for name in CSVS:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False), name
    assert mine["accuracy"] == theirs["accuracy"] == 0.75
    assert mine["rows"] == theirs["rows"]
    assert mine["report"] == theirs["report"]
    assert [r["file"] for r in mine["rows"]][-1] == "extra.wav"
    assert not mine["rows"][-1]["expected"]


def test_holdout_without_details_or_matplotlib(tmp_path, holdout_dir,
                                               monkeypatch):
    """No ``details.csv``: nothing is labeled, accuracy 0, the CSVs are
    still equal to JAX's; without matplotlib the plots are skipped."""
    d, stub = holdout_dir
    os.remove(d / "details.csv")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    mine = evaluate_tts_directory(stub, str(d),
                                  report_dir=str(tmp_path / "port"))
    jax_evaluate(stub, str(d), report_dir=str(tmp_path / "jax"))
    assert mine["accuracy"] == 0.0 and mine["report"]["classes"] == {}
    for name in CSVS:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False), name
    assert sorted(os.listdir(tmp_path / "port")) == sorted(CSVS)


def test_holdout_plots_written(tmp_path, holdout_dir):
    pytest.importorskip("matplotlib")
    d, stub = holdout_dir
    evaluate_tts_directory(stub, str(d), report_dir=str(tmp_path / "port"))
    for name in ("confusion_matrix.png", "class_accuracy.png",
                 "confidence_distribution.png"):
        assert (tmp_path / "port" / name).stat().st_size > 0, name


def _partial_wav(path, data_bytes=2001):
    """Mono PCM16 at 16 kHz whose data chunk is an odd number of bytes (not
    a whole number of 2-byte samples), as ``tests/test_torch_faults.py``."""
    data = bytes(range(256)) * (data_bytes // 256) + bytes(data_bytes % 256)
    path.write_bytes(
        b"RIFF" + struct.pack("<I", 36 + data_bytes) + b"WAVE" + b"fmt "
        + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
        + b"data" + struct.pack("<I", data_bytes) + data)


def test_cli_against_jax_cli(tmp_path, monkeypatch):
    from speech_intent_recognizer_tpu.cli.test_tts_samples import (
        main as jax_main)
    from speech_intent_recognizer_tpu.infer import predict as jax_predict
    from speech_intent_recognizer_tpu_torch.infer import predict
    from speech_intent_recognizer_tpu.models.cnn_gru import (
        CNNAudioGRU, init_model)
    from speech_intent_recognizer_tpu.train.checkpoint import save_model
    from speech_intent_recognizer_tpu_torch.cli.test_tts_samples import main

    variables = jax.tree.map(np.array, init_model(
        CNNAudioGRU(num_classes=len(CLASSES)), jax.random.key(6)))
    # a decisive head (top-two margins far above the bf16 path's error)
    # that tells the three utterances apart
    variables["params"]["fc"]["kernel"] *= 100.0
    save_model(str(tmp_path / "model.msgpack"), variables)
    labels = tmp_path / "label_map.json"
    labels.write_text(json.dumps({c: i for i, c in enumerate(CLASSES)}))
    audio = tmp_path / "tts"
    generate_audio_files(None, str(audio), engine="synthetic",
                         texts_and_classes=[
                             ("switch the lamp on", "activate_lamp"),
                             ("bring me my shoes please", "bring_shoes"),
                             ("stop", "deactivate_music")])
    _partial_wav(audio / "004_partial.wav")
    for module in (predict, jax_predict):  # the Python decoders
        monkeypatch.setattr(module, "load_audio", functools.partial(
            module.load_audio, prefer_native=False))
    common = ["--model", str(tmp_path / "model.msgpack"),
              "--label_map", str(labels), "--audio_dir", str(audio)]
    mine = main(common + ["--report_dir", str(tmp_path / "port"),
                          "--device", "cpu"])
    theirs = jax_main(common + ["--report_dir", str(tmp_path / "jax")])
    assert [r["file"] for r in mine["rows"]] == \
        [r["file"] for r in theirs["rows"]]
    assert len(mine["rows"]) == 3
    assert len({r["predicted"] for r in mine["rows"]}) == 2
    assert [r["predicted"] for r in mine["rows"]] == \
        [r["predicted"] for r in theirs["rows"]]
    np.testing.assert_allclose([r["confidence"] for r in mine["rows"]],
                               [r["confidence"] for r in theirs["rows"]],
                               atol=2e-2)
    assert mine["accuracy"] == theirs["accuracy"]
    assert os.path.exists(tmp_path / "port" / "detailed_results.csv")
