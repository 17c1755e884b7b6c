"""Golden CPU reference for the log-mel front-end (pure NumPy).

This is the bit-faithfulness anchor for the whole framework: the JAX and
Pallas front-ends are tested against this implementation, and this
implementation reproduces the exact semantics of the reference project's
feature extractors:

* "torchaudio" mode == ``torchaudio.transforms.MelSpectrogram`` +
  ``AmplitudeToDB`` + per-utterance normalization as used for training and
  evaluation (reference ``scripts/precompute_features.py:28-73`` and
  ``scripts/dataset.py:117-158``): hann(periodic) window, center=True with
  reflect padding, power spectrum, HTK mel scale with no filterbank norm,
  10*log10(clamp(p, 1e-10)) dB with ref=1.0 and no top_db, then
  ``(x - mean) / (std_unbiased + 1e-5)``.

* "librosa" mode == the live-microphone path (reference
  ``scripts/testing.py:193-217``): librosa mel (Slaney scale + Slaney area
  norm), ``power_to_db(ref=np.max)`` with top_db=80, then the fixed global
  normalization (-30.1, 12.7).  The reference claims both paths match; they
  do not — we keep both so the discrepancy is testable, but the framework
  trains and serves with the single "torchaudio" front-end.
"""

from __future__ import annotations

import numpy as np


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Hann window; ``periodic=True`` matches torch.hann_window's default."""
    n = win_length + 1 if periodic else win_length
    if win_length == 1:
        return np.ones(1, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return w[:win_length].astype(np.float64)


def hz_to_mel(freq, mel_scale: str = "htk"):
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # Slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def mel_to_hz(mels, mel_scale: str = "htk"):
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)),
        freqs,
    )


def mel_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    f_min: float = 0.0,
    f_max: float | None = None,
    mel_scale: str = "htk",
    norm: str | None = None,
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_freqs, n_mels).

    ``mel_scale="htk", norm=None`` reproduces torchaudio's
    ``melscale_fbanks`` defaults (the training front-end);
    ``mel_scale="slaney", norm="slaney"`` reproduces librosa's defaults
    (the reference mic path).
    """
    if f_max is None:
        f_max = sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_min = hz_to_mel(f_min, mel_scale)
    m_max = hz_to_mel(f_max, mel_scale)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)

    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float64)


def reflect_pad(x: np.ndarray, pad: int) -> np.ndarray:
    """Reflect-pad the last axis (no edge repeat), matching torch.stft."""
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")


def frame_signal_np(x: np.ndarray, n_fft: int, hop_length: int) -> np.ndarray:
    """Frame a 1-D signal into overlapping windows: (num_frames, n_fft)."""
    num_frames = 1 + (len(x) - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(num_frames)[:, None]
    return x[idx]


def spectrogram_np(
    waveform: np.ndarray,
    n_fft: int = 1024,
    hop_length: int = 512,
    win_length: int | None = None,
    power: float = 2.0,
    center: bool = True,
    pad_mode: str = "reflect",
) -> np.ndarray:
    """STFT power spectrogram, shape (n_freqs, num_frames), float64.

    Matches ``torch.stft(..., center=True, pad_mode="reflect",
    onesided=True)`` followed by ``|.|**power``.
    """
    x = np.asarray(waveform, dtype=np.float64).reshape(-1)
    win_length = win_length or n_fft
    window = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    if center:
        pad = n_fft // 2
        if pad_mode == "reflect":
            x = reflect_pad(x, pad)
        else:
            x = np.pad(x, (pad, pad))
    frames = frame_signal_np(x, n_fft, hop_length) * window[None, :]
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)  # (T, n_freqs)
    return (np.abs(spec) ** power).T  # (n_freqs, T)


def amplitude_to_db_np(
    power_spec: np.ndarray,
    multiplier: float = 10.0,
    amin: float = 1e-10,
    ref: float = 1.0,
    top_db: float | None = None,
) -> np.ndarray:
    """torchaudio ``AmplitudeToDB`` (stype="power") semantics.

    db = 10*log10(clamp(x, amin)) - 10*log10(max(amin, ref)); the reference
    uses defaults, so the ref term is 0 and no top_db clamp is applied
    (``scripts/precompute_features.py:36,67``).
    """
    db = multiplier * np.log10(np.maximum(power_spec, amin))
    db -= multiplier * np.log10(max(amin, ref))
    if top_db is not None:
        db = np.maximum(db, db.max() - top_db)
    return db


def power_to_db_np(
    power_spec: np.ndarray,
    ref: float | str = "max",
    amin: float = 1e-10,
    top_db: float | None = 80.0,
) -> np.ndarray:
    """librosa ``power_to_db`` semantics (reference ``testing.py:206``)."""
    ref_value = float(np.max(power_spec)) if ref == "max" else float(ref)
    db = 10.0 * np.log10(np.maximum(power_spec, amin))
    db -= 10.0 * np.log10(max(amin, ref_value))
    if top_db is not None:
        db = np.maximum(db, db.max() - top_db)
    return db


def normalize_per_utterance(mel_db: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """(x - mean) / (unbiased_std + eps), over the whole utterance.

    ``torch.Tensor.std()`` uses the unbiased (N-1) estimator — this detail
    matters for bit parity with the reference cache
    (``precompute_features.py:73``).
    """
    mean = mel_db.mean()
    std = mel_db.std(ddof=1)
    return (mel_db - mean) / (std + eps)


def log_mel_spectrogram_np(
    waveform: np.ndarray,
    sample_rate: int = 16000,
    n_fft: int = 1024,
    hop_length: int = 512,
    n_mels: int = 64,
    f_min: float = 0.0,
    f_max: float | None = None,
    frontend: str = "torchaudio",
    normalize: bool = True,
    global_mean: float = -30.1,
    global_std: float = 12.7,
    max_duration: float | None = 5.0,
    dtype=np.float32,
) -> np.ndarray:
    """Full golden front-end: waveform -> normalized log-mel (n_mels, T).

    "torchaudio" reproduces the training/eval feature contract; "librosa"
    reproduces the reference microphone path (including its fixed global
    normalization constants, ``testing.py:189-209``).
    """
    x = np.asarray(waveform, dtype=np.float64).reshape(-1)
    if max_duration is not None:
        max_samples = int(max_duration * sample_rate)
        if len(x) > max_samples:
            x = x[:max_samples]

    if frontend == "torchaudio":
        spec = spectrogram_np(x, n_fft, hop_length, pad_mode="reflect")
        fb = mel_filterbank(spec.shape[0], n_mels, sample_rate, f_min, f_max,
                            mel_scale="htk", norm=None)
        mel = fb.T @ spec
        mel_db = amplitude_to_db_np(mel)
        if normalize:
            mel_db = normalize_per_utterance(mel_db)
    elif frontend == "librosa":
        spec = spectrogram_np(x, n_fft, hop_length, pad_mode="constant")
        fb = mel_filterbank(spec.shape[0], n_mels, sample_rate, f_min, f_max,
                            mel_scale="slaney", norm="slaney")
        mel = fb.T @ spec
        mel_db = power_to_db_np(mel, ref="max", top_db=80.0)
        if normalize:
            mel_db = (mel_db - global_mean) / global_std
    else:
        raise ValueError(f"unknown frontend {frontend!r}")
    return mel_db.astype(dtype)


def pad_or_trim_np(mel: np.ndarray, target_length: int = 200) -> np.ndarray:
    """Pad (zeros, right) or trim the time axis to ``target_length`` frames
    (reference ``dataset.py:109-113`` / ``train.py:58-62``)."""
    t = mel.shape[-1]
    if t > target_length:
        return mel[..., :target_length]
    if t < target_length:
        pad = [(0, 0)] * (mel.ndim - 1) + [(0, target_length - t)]
        return np.pad(mel, pad)
    return mel
