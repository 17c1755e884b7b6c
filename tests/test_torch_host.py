"""The port's copies of the JAX-free host code, pinned to their originals
on the same inputs (exact equality: the copies run the same NumPy code)."""

import json

import numpy as np
import pytest

from speech_intent_recognizer_tpu.data import audio_io as ref_io
from speech_intent_recognizer_tpu.data import labelmap as ref_labelmap
from speech_intent_recognizer_tpu.evaluation import metrics as ref_metrics
from speech_intent_recognizer_tpu.ops import frontend_numpy as ref_golden
from speech_intent_recognizer_tpu.ops import resample as ref_resample
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

