"""The port's copies of the JAX-free host code, pinned to their originals
on the same inputs (exact equality: the copies run the same NumPy code)."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

from speech_intent_recognizer_tpu import config as ref_config
from speech_intent_recognizer_tpu.config import loader as ref_loader
from speech_intent_recognizer_tpu.config.schema import (
    ConfigError as RefConfigError)
from speech_intent_recognizer_tpu.data import audio_io as ref_io
from speech_intent_recognizer_tpu.data import labelmap as ref_labelmap
from speech_intent_recognizer_tpu.evaluation import metrics as ref_metrics
from speech_intent_recognizer_tpu.ops import frontend_numpy as ref_golden
from speech_intent_recognizer_tpu.ops import resample as ref_resample
from speech_intent_recognizer_tpu_torch import config
from speech_intent_recognizer_tpu_torch.config import loader
from speech_intent_recognizer_tpu_torch.data import audio_io
from speech_intent_recognizer_tpu_torch.data import labelmap
from speech_intent_recognizer_tpu_torch.evaluation import metrics
from speech_intent_recognizer_tpu_torch.ops import frontend_numpy as golden
from speech_intent_recognizer_tpu_torch.ops import resample


def _wave(rng, n):
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n_freqs,n_mels,scale,norm", [
    (513, 64, "htk", None), (257, 40, "slaney", "slaney")])
def test_mel_filterbank_and_window_match(n_freqs, n_mels, scale, norm):
    np.testing.assert_array_equal(
        golden.mel_filterbank(n_freqs, n_mels, 16000, mel_scale=scale,
                              norm=norm),
        ref_golden.mel_filterbank(n_freqs, n_mels, 16000, mel_scale=scale,
                                  norm=norm))
    np.testing.assert_array_equal(golden.hann_window(2 * (n_freqs - 1)),
                                  ref_golden.hann_window(2 * (n_freqs - 1)))


@pytest.mark.parametrize("n,frontend", [(1537, "torchaudio"),
                                        (40000, "torchaudio"),
                                        (24000, "librosa")])
def test_log_mel_golden_matches(rng, n, frontend):
    x = _wave(rng, n)
    a = golden.pad_or_trim_np(
        golden.log_mel_spectrogram_np(x, frontend=frontend), 200)
    b = ref_golden.pad_or_trim_np(
        ref_golden.log_mel_spectrogram_np(x, frontend=frontend), 200)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("orig,new", [(44100, 16000), (8000, 16000),
                                      (16000, 16000)])
def test_resample_matches(rng, orig, new):
    x = _wave(rng, 5000)
    np.testing.assert_array_equal(resample.resample_np(x, orig, new),
                                  ref_resample.resample_np(x, orig, new))


@pytest.mark.parametrize("prefer_native", [True, False])
def test_wav_round_trip_matches(rng, tmp_path, prefer_native):
    x = _wave(rng, 12345)
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    audio_io.save_wav(str(ours), x, 16000)
    ref_io.save_wav(str(theirs), x, 16000)
    assert ours.read_bytes() == theirs.read_bytes()
    got, rate = audio_io.load_audio(str(ours), target_sample_rate=16000,
                                    prefer_native=prefer_native)
    want, rate_ref = ref_io.load_audio(str(ours), target_sample_rate=16000,
                                       prefer_native=prefer_native)
    assert rate == rate_ref == 16000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, x, atol=1.0 / 32767)
    # resampled decode of a 22.05 kHz file
    audio_io.save_wav(str(ours), x, 22050)
    np.testing.assert_array_equal(
        audio_io.load_audio(str(ours), 16000, prefer_native=prefer_native)[0],
        ref_io.load_audio(str(ours), 16000, prefer_native=prefer_native)[0])


def test_label_map_matches(tmp_path):
    path = tmp_path / "label_map.json"
    lm = labelmap.create_label_map(["b_x", "a_y", "b_x", "c_z"])
    assert lm == ref_labelmap.create_label_map(["b_x", "a_y", "b_x", "c_z"])
    labelmap.save_label_map(lm, str(path))
    assert json.loads(path.read_text()) == lm
    assert labelmap.load_label_map(str(path)) == \
        ref_labelmap.load_label_map(str(path))


@pytest.mark.parametrize("k", [1, 3, 31])
def test_top_k_predictions_match(rng, k):
    probs = rng.dirichlet(np.ones(31))
    inv = {i: f"intent_{i}" for i in range(30)}  # one id unlabelled
    assert metrics.top_k_predictions(probs, inv, k) == \
        ref_metrics.top_k_predictions(probs, inv, k)



CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
    "*.yaml")))
OVERRIDES = [
    {},
    {"n_fft": 512, "hop_length": 256, "n_mels": 40, "lr": "5e-05",
     "batch_size": "64", "use_amp": True, "num_workers": 4},
    {"audio": {"win_length": 400, "n_fft": 512, "f_max": 7600.0},
     "model": {"conv_channels": [8, 16, 16], "gru_hidden": 32},
     "train": {"epochs": 2, "bf16": False}, "seed": 7},
]


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
@pytest.mark.parametrize("overrides", range(len(OVERRIDES)))
def test_config_copy_matches_original(path, overrides):
    """The port's own config/ against the JAX package's: the same YAML and
    the same overrides give equal dataclasses.asdict."""
    assert loader.load_raw(path) == ref_loader.load_raw(path)
    raw = {**ref_loader.load_raw(path), **OVERRIDES[overrides]}
    got, want = config.Config.from_dict(raw), ref_config.Config.from_dict(raw)
    assert type(got) is not type(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_dict() == want.to_dict()
    assert got.audio.max_samples == want.audio.max_samples
    assert got.audio.n_freqs == want.audio.n_freqs
    if not overrides:
        assert dataclasses.asdict(config.load_config(path)) == \
            dataclasses.asdict(ref_config.load_config(path))


def test_config_mini_yaml_reader_matches():
    text = ("# comment\nlr: 5e-05\nuse_mixup: yes\nf: ~\nname: 'x y'\n"
            "audio:\n  n_mels: 40  # inline\n  frontend: torchaudio\n"
            "model:\n  conv_channels: [8, 16, 16]\nepochs: 3\n")
    got = loader._mini_yaml_load(text)
    assert got == ref_loader._mini_yaml_load(text)
    assert got["audio"] == {"n_mels": 40, "frontend": "torchaudio"}
    assert got["model"]["conv_channels"] == [8, 16, 16]


@pytest.mark.parametrize("raw", [
    {"learning_rate": 1e-3},              # a typo of a flat key
    {"audio": {"n_mel": 40}},             # a typo inside a section
    {"frontend": "kaldi"},                # unknown front-end
    {"n_fft": 256, "audio": {"win_length": 400}},  # window longer than FFT
    {"epochs": 0}, {"augment_prob": 1.5}, {"num_labels": 1},
])
def test_config_errors_match(raw):
    with pytest.raises(RefConfigError):
        ref_config.Config.from_dict(raw)
    with pytest.raises(config.ConfigError):
        config.Config.from_dict(raw)
    assert issubclass(config.ConfigError, ValueError)


def test_config_save_round_trip(tmp_path):
    cfg = config.Config.from_dict({"hop_length": 256, "epochs": 2})
    for name in ("c.yaml", "c.json"):
        loader.save_config(cfg, str(tmp_path / name))
        assert config.load_config(str(tmp_path / name)).to_dict() == \
            cfg.to_dict()
    with pytest.raises(FileNotFoundError):
        config.load_config(str(tmp_path / "missing.yaml"))
    assert config.load_audio_config(str(tmp_path / "c.yaml")).hop_length == 256
