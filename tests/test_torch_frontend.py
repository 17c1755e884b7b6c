"""The port's front-end against the JAX package on the same numpy inputs.

* the plain ``log_mel_frontend`` against the frozen feature vectors, the
  fp64 golden, and JAX ``log_mel_frontend(backend="xla")``;
* the plain K1 (front-end + conv1 + ReLU + pool) against JAX
  ``log_mel_conv1_frontend``, whose Pallas kernel runs in interpret mode on
  the CPU as the JAX package's own tests run it;
* off the reference geometry, ``log_mel_frontend`` against JAX
  ``backend="xla"`` and against the port's own plain version, raw dB and
  bf16 out included (the shared ``_finish`` tail).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu.config.schema import AudioConfig
from speech_intent_recognizer_tpu.ops import frontend_jax
from speech_intent_recognizer_tpu.ops.frontend_pallas import (
    conv1_band_operands)
from speech_intent_recognizer_tpu_torch.ops import frontend_numpy as golden
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    log_mel_conv1_frontend, log_mel_frontend, make_frontend_params,
    padded_samples)

CFG = AudioConfig()
WIDTH = padded_samples(CFG.max_samples, CFG.hop_length)


def _wave(rng, n):
    t = np.arange(n) / 16000
    x = (0.3 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * np.sin(2 * np.pi * 1330 * t + 0.5)
         + 0.05 * rng.standard_normal(n))
    return x.astype(np.float32)


def _batch(rng, lengths, width=WIDTH):
    buf = np.zeros((len(lengths), width), np.float32)
    for i, n in enumerate(lengths):
        buf[i, :n] = _wave(rng, n)
    return buf, np.asarray(lengths, np.int32)


def _port(buf, lengths):
    return log_mel_frontend(torch.from_numpy(buf), torch.from_numpy(lengths),
                            make_frontend_params(CFG)).numpy()


def test_matches_frozen_vectors():
    """Bar of tests/test_frontend.py::test_jax_frontend_matches_frozen."""
    z = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "golden_features.npz"))
    for key in ("vol", "lamp"):
        x = z[f"wave_{key}"]
        buf = np.zeros((1, CFG.max_samples), np.float32)
        buf[0, :len(x)] = x
        got = _port(buf, np.asarray([len(x)], np.int32))[0]
        np.testing.assert_allclose(got, z[f"feat_{key}"], rtol=3e-3,
                                   atol=3e-3, err_msg=key)


def test_matches_golden(rng):
    """Bar of tests/test_frontend.py:211 (2e-3).  The golden reflects
    ``x[:len]``, which equals the buffer semantics once len > 513."""
    lengths = [1537, 8000, 16001, 39999, 80000]
    buf, ln = _batch(rng, lengths)
    got = _port(buf, ln)
    for i, n in enumerate(lengths):
        want = golden.pad_or_trim_np(
            golden.log_mel_spectrogram_np(buf[i, :n]), 200)
        np.testing.assert_allclose(got[i], want, rtol=2e-3, atol=2e-3,
                                   err_msg=f"length {n}")


@pytest.mark.parametrize("width", [CFG.max_samples, WIDTH])
def test_matches_jax_xla(rng, width):
    """Including lengths 2 and 512, where the left reflect reads the
    zero-padded buffer and the right reflect falls back to x[0]."""
    lengths = [2, 512, 513, 1537, 16000, 80000]
    buf, ln = _batch(rng, lengths, width)
    want = np.asarray(frontend_jax.log_mel_frontend(
        jnp.asarray(buf), jnp.asarray(ln),
        frontend_jax.make_frontend_params(CFG), backend="xla"))
    np.testing.assert_allclose(_port(buf, ln), want, rtol=2e-3, atol=2e-3)


def test_plain_k1_matches_jax_conv1_frontend(rng):
    """Plain K1 vs the interpret-mode Pallas K1 on the same folded conv1
    weights, at the bar of tests/test_conv1_fusion.py:81 (0.05 * scale)."""
    lengths = [16000, 39999, 80000, 1537, 2, 512]
    buf, ln = _batch(rng, lengths)
    kernel = (rng.standard_normal((3, 3, 1, 32)) / 3.0).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32)).astype(np.float32)
    want = np.asarray(frontend_jax.log_mel_conv1_frontend(
        jnp.asarray(buf), jnp.asarray(ln),
        frontend_jax.make_frontend_params(CFG),
        conv1_band_operands(kernel, bias, CFG.n_mels),
        out_dtype=jnp.float32))
    got = log_mel_conv1_frontend(
        torch.from_numpy(buf), torch.from_numpy(ln), make_frontend_params(CFG),
        torch.from_numpy(np.transpose(kernel, (3, 2, 0, 1)).copy()),
        torch.from_numpy(bias))
    assert got.shape == (6, 100, 1024) and got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=0.05 * scale, rtol=0.05)


@pytest.mark.parametrize("kw", [
    dict(hop_length=256, mel_spec_length=400),
    dict(n_fft=512, hop_length=160, win_length=400, n_mels=40,
         mel_spec_length=300),
], ids=["hop256", "fft512_win400"])
@pytest.mark.parametrize("normalize", [True, False])
def test_other_geometries_match_jax_xla(kw, normalize):
    """The geometries the card serves through K4: on the CPU the same
    dispatcher takes the plain version.  Bars of
    tests/test_pallas_frontend.py:62 and :79 (2e-3; raw dB atol 5e-3)."""
    from speech_intent_recognizer_tpu_torch.config import (
        AudioConfig as PortAudioConfig)
    from speech_intent_recognizer_tpu_torch.ops.frontend import (
        log_mel_frontend_plain)
    from speech_intent_recognizer_tpu_torch.ops.frontend_kernels import (
        is_reference_geometry)

    cfg = PortAudioConfig(**kw)
    params = make_frontend_params(cfg)
    assert not is_reference_geometry(params)
    assert is_reference_geometry(make_frontend_params())
    lengths = [2, 513, 16000, 52117, 80000]
    buf, ln = _batch(np.random.default_rng(31), lengths,
                     padded_samples(cfg.max_samples, cfg.hop_length))
    want = np.asarray(frontend_jax.log_mel_frontend(
        jnp.asarray(buf), jnp.asarray(ln),
        frontend_jax.make_frontend_params(AudioConfig(**kw)), backend="xla",
        normalize=normalize))
    args = (torch.from_numpy(buf), torch.from_numpy(ln), params, normalize)
    got = log_mel_frontend(*args)
    assert got.shape == (5, cfg.n_mels, cfg.mel_spec_length)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3,
                               atol=2e-3 if normalize else 5e-3)
    assert torch.equal(got, log_mel_frontend_plain(*args))
    half = log_mel_frontend(*args, out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, got.to(torch.bfloat16))
