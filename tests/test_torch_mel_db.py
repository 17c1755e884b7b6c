"""K4, frames -> dB-mel: the port's plain version against the JAX package's
Pallas kernel (interpret mode off the TPU) on the same numpy frames, rtol /
atol 1e-4 (tests/test_pallas_frontend.py:35), and ``log_mel_frontend`` off
the reference geometry against JAX ``backend="pallas"``, which reaches that
kernel there (2e-3, tests/test_pallas_frontend.py:62), and against the fp64
golden (< 0.05)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu.config.schema import (
    AudioConfig as JaxAudioConfig)
from speech_intent_recognizer_tpu.ops import frontend_jax
from speech_intent_recognizer_tpu.ops.frontend_pallas import mel_db_pallas
from speech_intent_recognizer_tpu_torch.config import AudioConfig
from speech_intent_recognizer_tpu_torch.ops import frontend_numpy as golden
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    log_mel_frontend, make_frontend_params, padded_samples)
from speech_intent_recognizer_tpu_torch.ops.frontend_kernels import (
    _mel_db_plain, dft_matrices, mel_db)

@pytest.fixture
def rng():
    """A generator per test: inputs do not depend on the order of tests."""
    return np.random.default_rng(102)


GEOMETRIES = {
    "hop256": dict(n_fft=1024, hop_length=256, mel_spec_length=400),
    "fft512_40mels": dict(n_fft=512, hop_length=256, n_mels=40,
                          mel_spec_length=400),
}


@pytest.mark.parametrize("n", [1, 255, 256, 257, 300])
def test_mel_db_matches_jax_kernel(rng, n):
    p = make_frontend_params()
    frames = (rng.standard_normal((n, 1024)) * 0.1).astype(np.float32)
    want = np.asarray(mel_db_pallas(jnp.asarray(frames),
                                    frontend_jax.make_frontend_params()))
    mel_db.launches = 0
    got = mel_db(torch.from_numpy(frames), p).numpy()
    assert got.shape == (n, 64) and mel_db.launches == 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_mel_db_other_sizes_match_jax_kernel(rng):
    """A short window in a longer FFT, and a mel count that is no multiple
    of anything."""
    kw = dict(n_fft=512, win_length=400, hop_length=160, n_mels=40)
    frames = (rng.standard_normal((37, 512)) * 0.1).astype(np.float32)
    want = np.asarray(mel_db_pallas(
        jnp.asarray(frames),
        frontend_jax.make_frontend_params(JaxAudioConfig(**kw))))
    got = mel_db(torch.from_numpy(frames),
                 make_frontend_params(AudioConfig(**kw))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_dft_matrices_match_jax_operands():
    p = make_frontend_params(AudioConfig(n_fft=512, win_length=400))
    want = frontend_jax.make_frontend_params(
        JaxAudioConfig(n_fft=512, win_length=400))
    wcos, wsin = dft_matrices(p)
    np.testing.assert_allclose(wcos.numpy(), np.asarray(want.dft_cos),
                               atol=1e-6)
    np.testing.assert_allclose(wsin.numpy(), np.asarray(want.dft_sin),
                               atol=1e-6)


def test_mel_db_rejects_bad_frames():
    p = make_frontend_params()
    with pytest.raises(ValueError, match="frames"):
        mel_db(torch.zeros((3, 512)), p)
    with pytest.raises(ValueError, match="float32"):
        mel_db(torch.zeros((3, 1024), dtype=torch.float64), p)


def test_plain_takes_precomputed_operands(rng):
    p = make_frontend_params()
    frames = torch.from_numpy(rng.standard_normal((5, 1024))
                              .astype(np.float32))
    assert torch.equal(_mel_db_plain(frames, p),
                       _mel_db_plain(frames, p, dft_matrices(p)))


def _batch(rng, lengths, width):
    buf = np.zeros((len(lengths), width), np.float32)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000
        buf[i, :n] = (0.3 * np.sin(2 * np.pi * 440 * t)
                      + 0.05 * rng.standard_normal(n))
    return buf, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_frontend_off_reference_geometry_matches_jax_pallas(rng, name):
    kw = GEOMETRIES[name]
    cfg = AudioConfig(**kw)
    lengths = [16000, 39999, 80000, 1025]
    width = padded_samples(cfg.max_samples, cfg.hop_length)
    buf, ln = _batch(rng, lengths, width)
    jp = frontend_jax.make_frontend_params(JaxAudioConfig(**kw))
    want = np.asarray(frontend_jax.log_mel_frontend(
        jnp.asarray(buf), jnp.asarray(ln), jp, backend="pallas"))
    got = log_mel_frontend(torch.from_numpy(buf), torch.from_numpy(ln),
                           make_frontend_params(cfg)).numpy()
    assert got.shape == want.shape == (4, cfg.n_mels, 400)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    gold = np.stack([golden.pad_or_trim_np(golden.log_mel_spectrogram_np(
        buf[i, :n], n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        n_mels=cfg.n_mels), 400) for i, n in enumerate(lengths)])
    assert np.abs(got - gold).max() < 0.05
