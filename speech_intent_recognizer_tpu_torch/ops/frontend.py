"""Log-mel front-end (PyTorch).

Counterpart of ``speech_intent_recognizer_tpu/ops/frontend_jax.py``.  Batched
variable-length audio arrives as a zero-padded (B, L) float32 buffer plus
the true lengths; every semantic of the reference is kept:

* centre padding by 512 samples: the **left reflect** reads the zero-padded
  buffer (``x[1:513][::-1]``, not clipped to the true length for short
  utterances); the **right reflect** is dynamic, ``x[clip(len-2-k, 0)]``
  for k in 0..511 (falls back to ``x[0]`` for tiny lengths).  This is not
  ``torch.stft(pad_mode="reflect")`` on ``x[:len]``, which differs for
  short utterances and raises for ``len <= 512``;
* valid frames ``1 + len // hop``; dB ``10*log10(max(mel, 1e-10))``;
* masked per-utterance mean and ddof=1 std, ``(db-mean)/(sqrt(var)+eps)``
  with ``max(cnt-1, 1)``; frames past the valid count zeroed afterwards;
  the time axis zero-padded or trimmed to ``mel_spec_length``.

:func:`log_mel_frontend` is plain PyTorch (the reference's XLA path);
:func:`log_mel_conv1_frontend` runs the fused front-end + conv1 kernel (K1,
``ops/frontend_kernels.py``) for CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from speech_intent_recognizer_tpu_torch.config.schema import AudioConfig
from speech_intent_recognizer_tpu_torch.ops import frontend_numpy as golden


class FrontendParams(NamedTuple):
    """Constant operands of the torchaudio-mode front-end (the only mode
    the port serves), as tensors on one device.

    ``window`` and ``mel_fb`` serve the plain path; ``twiddle`` and the
    packed filterbank (``fb_packed``/``fb_off``/``fb_lo``: each mel's
    nonzero weights, their offsets, and the first FFT bin of each triangle)
    are the K1 kernel's operands."""

    window: torch.Tensor  # (n_fft,) f32 periodic Hann
    mel_fb: torch.Tensor  # (n_freqs, n_mels) f32
    twiddle: torch.Tensor  # (n_fft // 2, 2) f32: cos, -sin of 2*pi*k/n_fft
    fb_packed: torch.Tensor  # (nnz,) f32
    fb_off: torch.Tensor  # (n_mels + 1,) int32
    fb_lo: torch.Tensor  # (n_mels,) int32
    n_fft: int
    hop_length: int
    n_mels: int
    target_length: int
    norm_eps: float


def make_frontend_params(cfg: Optional[AudioConfig] = None,
                         device: "str | torch.device" = "cpu"
                         ) -> FrontendParams:
    cfg = cfg or AudioConfig()
    if cfg.frontend != "torchaudio":
        raise ValueError("the port's front-end supports the torchaudio mode")
    n_freqs = cfg.n_fft // 2 + 1
    window = golden.hann_window(cfg.win_length)
    if cfg.win_length < cfg.n_fft:
        lpad = (cfg.n_fft - cfg.win_length) // 2
        window = np.pad(window, (lpad, cfg.n_fft - cfg.win_length - lpad))
    fb = golden.mel_filterbank(n_freqs, cfg.n_mels, cfg.sample_rate,
                               cfg.f_min, cfg.f_max, mel_scale="htk",
                               norm=None)
    angle = 2.0 * np.pi * np.arange(cfg.n_fft // 2) / cfg.n_fft
    twiddle = np.stack([np.cos(angle), -np.sin(angle)], axis=1)
    # sparse filterbank: each triangle's nonzero run of bins, mel-major
    fb32 = fb.astype(np.float32)
    lo, off, packed = [], [0], []
    for m in range(cfg.n_mels):
        nz = np.nonzero(fb32[:, m])[0]
        first, last = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        lo.append(first)
        packed.append(fb32[first:last, m])
        off.append(off[-1] + last - first)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return FrontendParams(
        window=f32(window), mel_fb=f32(fb), twiddle=f32(twiddle),
        fb_packed=f32(np.concatenate(packed)), fb_off=i32(off),
        fb_lo=i32(lo), n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        n_mels=cfg.n_mels, target_length=cfg.mel_spec_length,
        norm_eps=cfg.norm_eps)


def padded_samples(max_samples: int, hop: int = 512,
                   multiple: int = 8) -> int:
    """Row-aligned waveform buffer width (the reference's batch buffer
    size): at least one spare hop past ``max_samples``, in whole multiples
    of ``hop * multiple``.  The extra tail samples stay zero; true lengths
    are what the front-end masks on."""
    t = -(-(max_samples // hop + 1) // multiple) * multiple
    return t * hop


def _frames(waveforms: torch.Tensor, lengths: torch.Tensor, n_fft: int,
            hop: int) -> torch.Tensor:
    """(B, L) zero-padded buffer + (B,) int64 lengths -> (B, 1 + L // hop,
    n_fft) frames of the centre-padded signal, with the reference's reflect
    semantics."""
    b, width = waveforms.shape
    pad = n_fft // 2
    n_frames = 1 + width // hop
    dev = waveforms.device
    p = (hop * torch.arange(n_frames, device=dev)[:, None]
         + torch.arange(n_fft, device=dev)[None, :])  # centre-padded index
    s = (p - pad)[None]  # signal index, (1, T, n_fft)
    ln = lengths[:, None, None]
    src = torch.where(p[None] < pad, pad - p[None],
                      torch.where(s < ln, s, (2 * ln - 2 - s).clamp(min=0)))
    inside = src < width
    src = torch.where(inside, src, 0).expand(b, -1, -1)
    x = torch.gather(waveforms, 1, src.reshape(b, -1)).reshape(src.shape)
    return torch.where(inside, x, 0.0)


def log_mel_frontend(waveforms: torch.Tensor, lengths: torch.Tensor,
                     params: FrontendParams) -> torch.Tensor:
    """Batched waveforms -> normalized log-mel features (plain PyTorch).

    Args:
      waveforms: (B, L) float32, zero-padded beyond each true length.
      lengths: (B,) integer true sample counts.
      params: from :func:`make_frontend_params`, on the waveforms' device.

    Returns (B, n_mels, target_length) float32.  The FFT and the mel
    projection run in float32; on CUDA the projection uses TF32 only if
    ``torch.backends.cuda.matmul.allow_tf32`` is set.
    """
    hop, n_mels, target = params.hop_length, params.n_mels, params.target_length
    lengths = lengths.to(torch.int64).clamp(0, waveforms.shape[1])  # as K1
    frames = _frames(waveforms.float(), lengths, params.n_fft, hop)
    spec = torch.fft.rfft(frames * params.window, dim=-1)
    power = spec.real.square() + spec.imag.square()
    mel = torch.matmul(power, params.mel_fb)  # (B, T, n_mels)
    db = 10.0 * torch.log10(mel.clamp(min=1e-10))

    t = db.shape[1]
    t_valid = 1 + lengths // hop
    mask = (torch.arange(t, device=db.device)[None, :]
            < t_valid[:, None]).to(db.dtype)[:, :, None]
    cnt = (t_valid.to(db.dtype) * n_mels)[:, None, None]
    mean = (db * mask).sum(dim=(1, 2), keepdim=True) / cnt
    var = ((db - mean).square() * mask).sum(
        dim=(1, 2), keepdim=True) / (cnt - 1.0).clamp(min=1.0)
    db = (db - mean) / (var.sqrt() + params.norm_eps)
    db = (db * mask).transpose(1, 2)  # (B, n_mels, T)
    if t >= target:
        return db[:, :, :target].contiguous()
    return torch.nn.functional.pad(db, (0, target - t))


def log_mel_conv1_frontend(waveforms: torch.Tensor, lengths: torch.Tensor,
                           params: FrontendParams,
                           conv1_weight: torch.Tensor,
                           conv1_bias: torch.Tensor) -> torch.Tensor:
    """Fused front-end + first conv stage (the inference fast path).

    ``conv1_weight`` (C, 1, 3, 3) / ``conv1_bias`` (C,) are the BN-folded
    conv1 stage in reference layout (kernel dims mel, time).  Returns the
    pooled conv1 output (B, target_length // 2, (n_mels // 2) * C) bf16,
    lane = m_pooled * C + c, for ``CNNAudioGRU(conv1_external=True)``.
    CUDA tensors run the K1 kernel; CPU tensors its plain version.
    """
    from speech_intent_recognizer_tpu_torch.ops.frontend_kernels import (
        frontend_conv1)

    return frontend_conv1(waveforms, lengths, params, conv1_weight,
                          conv1_bias)
