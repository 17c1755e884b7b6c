"""Bandlimited sinc resampling, on the host (NumPy) or on a device.

Counterpart of ``speech_intent_recognizer_tpu/ops/resample.py`` (the
reference's ``ops`` package imports JAX, so the port keeps its own copy;
``tests/test_torch_host.py`` pins :func:`resample_np` to the original).
Reimplements torchaudio's ``sinc_interp_hann`` resampler: a polyphase
kernel bank of Hann-windowed sincs at the reduced ``orig/gcd : new/gcd``
ratio, applied as a strided correlation.  :func:`resample_torch` (the JAX
package's ``resample_jax``) applies the same bank as one fp32 matmul on the
tensor's device.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=32)
def _sinc_kernel(orig_freq: int, new_freq: int,
                 lowpass_filter_width: int = 6,
                 rolloff: float = 0.99) -> tuple[np.ndarray, int, int, int]:
    """Polyphase kernel bank, shape (new_freq_r, kernel_len), plus
    (width, orig_freq_r, new_freq_r) after gcd reduction."""
    g = math.gcd(int(orig_freq), int(new_freq))
    orig = int(orig_freq) // g
    new = int(new_freq) // g
    if orig == new:
        return np.ones((1, 1)), 0, 1, 1
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64) / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx[None, :]
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * (base_freq / orig)
    return kernel.astype(np.float64), width, orig, new


def resample_np(waveform: np.ndarray, orig_freq: int, new_freq: int,
                lowpass_filter_width: int = 6,
                rolloff: float = 0.99) -> np.ndarray:
    """Resample the last axis; matches torchaudio.functional.resample."""
    if orig_freq == new_freq:
        return np.asarray(waveform)
    x = np.asarray(waveform, dtype=np.float64)
    squeeze = x.ndim == 1
    x = np.atleast_2d(x)
    kernel, width, orig, new = _sinc_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff)
    length = x.shape[-1]
    x_pad = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(width, width + orig)])
    klen = kernel.shape[1]
    n_blocks = (x_pad.shape[-1] - klen) // orig + 1
    idx = np.arange(klen)[None, :] + orig * np.arange(n_blocks)[:, None]
    frames = x_pad[..., idx]  # (..., n_blocks, klen)
    ys = frames @ kernel.T  # (..., n_blocks, new)
    ys = ys.reshape(*x.shape[:-1], -1)
    target_length = math.ceil(new * length / orig)
    ys = ys[..., :target_length]
    out = ys.astype(np.result_type(waveform.dtype, np.float32))
    return out[0] if squeeze else out


def resample_torch(waveform, orig_freq: int, new_freq: int,
                   lowpass_filter_width: int = 6, rolloff: float = 0.99):
    """:func:`resample_np` on a tensor's device: the last axis of a float
    tensor, the kernel bank as one float32 matmul with TF32 off (the JAX
    package's ``resample_jax`` runs it at HIGHEST precision)."""
    import torch

    if orig_freq == new_freq:
        return waveform
    kernel, width, orig, new = _sinc_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff)
    squeeze = waveform.dim() == 1
    x = waveform.float()
    x = x[None] if squeeze else x
    length = x.shape[-1]
    x_pad = torch.nn.functional.pad(x, (width, width + orig))
    klen = kernel.shape[1]
    n_blocks = (x_pad.shape[-1] - klen) // orig + 1
    frames = x_pad.unfold(-1, klen, orig)[..., :n_blocks, :]
    bank = torch.as_tensor(kernel.T, dtype=torch.float32, device=x.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ys = frames @ bank  # (..., n_blocks, new)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    ys = ys.reshape(*x.shape[:-1], -1)
    ys = ys[..., :math.ceil(new * length / orig)]
    return ys[0] if squeeze else ys
