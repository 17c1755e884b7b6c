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

The ``librosa`` mode (the reference's microphone path) differs in three
places: zero centre padding, a Slaney filterbank, and dB relative to the
loudest valid frame's mel power, floored 80 dB below it and normalized by
the fixed global constants.  The JAX package runs that mode in XLA only
(``ops/frontend_jax.py:448-456``; ``:552-553`` refuses its Pallas backend),
so here it is plain PyTorch on every device by design: no kernel serves it.

:func:`log_mel_frontend_plain` is plain PyTorch (the reference's XLA
path).  For CUDA tensors :func:`log_mel_frontend` runs the fused front-end
kernel (K3) at the reference geometry (n_fft 1024, hop 512, 64 mels, 200
frames) and, off it, frames the signal, runs the dB-mel kernel (K4) on the
frames and finishes in PyTorch; :func:`log_mel_conv1_frontend` runs the
fused front-end + conv1 kernel (K1).  The kernels' wrappers are in
``ops/frontend_kernels.py``; CPU tensors, and the librosa mode on any
device, take the plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from speech_intent_recognizer_tpu_torch.config import AudioConfig
from speech_intent_recognizer_tpu_torch.ops import frontend_numpy as golden


class FrontendParams(NamedTuple):
    """Constant operands of the front-end, as tensors on one device.

    ``window`` and ``mel_fb`` serve the plain path; ``twiddle`` and the
    packed filterbank (``fb_packed``/``fb_off``/``fb_lo``: each mel's
    nonzero weights, their offsets, and the first FFT bin of each triangle)
    are the kernels' operands (K1, K3, K4).  ``twiddle[k]`` is
    e^{-2 pi i k / n_fft}: the factor that untangles the kernels'
    half-size complex transform into the real-input one, and the table
    their pass twiddles are read from (``csrc/warp_rfft.cuh``).
    ``frontend`` ("torchaudio" or "librosa") and the librosa mode's global
    normalization constants close it, as in the JAX package's
    ``FrontendParams``; the kernels serve the torchaudio mode only."""

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
    frontend: str = "torchaudio"
    global_mean: float = -30.1  # the reference mic path's constants
    global_std: float = 12.7    # (testing.py:189-209)


class FrontendModule(torch.nn.Module):
    """A :class:`FrontendParams` held by a module: its six tensors as
    non-persistent buffers, so that ``.to()`` moves them with the module
    and a program traced from it (``torch.export``) keeps them as
    constants, outside its weights; :attr:`params` gives them back."""

    _TENSORS = FrontendParams._fields[:6]

    def __init__(self, params: FrontendParams):
        super().__init__()
        for name in self._TENSORS:
            self.register_buffer(name, getattr(params, name),
                                 persistent=False)
        self._scalars = tuple(params[len(self._TENSORS):])

    @property
    def params(self) -> FrontendParams:
        return FrontendParams(*(getattr(self, n) for n in self._TENSORS),
                              *self._scalars)


def make_frontend_params(cfg: Optional[AudioConfig] = None,
                         device: "str | torch.device" = "cpu"
                         ) -> FrontendParams:
    """The front-end of ``cfg`` on ``device``: an HTK filterbank in the
    torchaudio mode, a Slaney one (Slaney-normalized) in the librosa mode
    (``ops/frontend_numpy.py``'s librosa branch), whose features are
    normalized by the reference's global constants."""
    cfg = cfg or AudioConfig()
    n_freqs = cfg.n_fft // 2 + 1
    window = golden.hann_window(cfg.win_length)
    if cfg.win_length < cfg.n_fft:
        lpad = (cfg.n_fft - cfg.win_length) // 2
        window = np.pad(window, (lpad, cfg.n_fft - cfg.win_length - lpad))
    if cfg.frontend == "torchaudio":
        fb = golden.mel_filterbank(n_freqs, cfg.n_mels, cfg.sample_rate,
                                   cfg.f_min, cfg.f_max, mel_scale="htk",
                                   norm=None)
    else:
        fb = golden.mel_filterbank(n_freqs, cfg.n_mels, cfg.sample_rate,
                                   cfg.f_min, cfg.f_max, mel_scale="slaney",
                                   norm="slaney")
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
        norm_eps=cfg.norm_eps, frontend=cfg.frontend)


def padded_samples(max_samples: int, hop: int = 512,
                   multiple: int = 8) -> int:
    """Row-aligned waveform buffer width (the reference's batch buffer
    size): at least one spare hop past ``max_samples``, in whole multiples
    of ``hop * multiple``.  The extra tail samples stay zero; true lengths
    are what the front-end masks on."""
    t = -(-(max_samples // hop + 1) // multiple) * multiple
    return t * hop


def _frames(waveforms: torch.Tensor, lengths: torch.Tensor, n_fft: int,
            hop: int, reflect: bool = True) -> torch.Tensor:
    """(B, L) zero-padded buffer + (B,) int64 lengths -> (B, 1 + L // hop,
    n_fft) frames of the centre-padded signal, with the reference's reflect
    semantics, or (``reflect=False``, the librosa mode) zeros on both
    sides of the buffer."""
    b, width = waveforms.shape
    pad = n_fft // 2
    n_frames = 1 + width // hop
    dev = waveforms.device
    p = (hop * torch.arange(n_frames, device=dev)[:, None]
         + torch.arange(n_fft, device=dev)[None, :])  # centre-padded index
    s = (p - pad)[None]  # signal index, (1, T, n_fft)
    if reflect:
        ln = lengths[:, None, None]
        src = torch.where(p[None] < pad, pad - p[None],
                          torch.where(s < ln, s,
                                      (2 * ln - 2 - s).clamp(min=0)))
    else:
        src = torch.where(s < 0, width, s)  # read as zero below
    inside = src < width
    src = torch.where(inside, src, 0).expand(b, -1, -1)
    x = torch.gather(waveforms, 1, src.reshape(b, -1)).reshape(src.shape)
    return torch.where(inside, x, 0.0)


def _finish(db: torch.Tensor, lengths: torch.Tensor, params: FrontendParams,
            normalize: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """Shared tail of the unfused paths: (B, T, n_mels) float32 dB and
    (B,) int64 lengths -> masked per-utterance normalization (torchaudio
    mode) or dB relative to the loudest valid frame, floored at -80 dB and
    globally normalized (librosa mode), frames past the valid count zeroed,
    (B, n_mels, target_length) ``out_dtype``."""
    hop, n_mels, target = params.hop_length, params.n_mels, params.target_length
    t = db.shape[1]
    t_valid = 1 + lengths // hop
    mask = (torch.arange(t, device=db.device)[None, :]
            < t_valid[:, None]).to(db.dtype)[:, :, None]
    if params.frontend == "librosa":
        # power_to_db(ref=max, top_db=80) over the valid frames: the dB of
        # the largest valid mel power is the largest valid dB, so the
        # peak after the subtraction is 0 and the floor -80
        valid = mask > 0
        ref = torch.where(valid, db, -torch.inf).amax(dim=(1, 2),
                                                      keepdim=True)
        db = (db - ref).clamp(min=-80.0)
        if normalize:
            db = (db - params.global_mean) / params.global_std
    elif normalize:
        cnt = (t_valid.to(db.dtype) * n_mels)[:, None, None]
        mean = (db * mask).sum(dim=(1, 2), keepdim=True) / cnt
        var = ((db - mean).square() * mask).sum(
            dim=(1, 2), keepdim=True) / (cnt - 1.0).clamp(min=1.0)
        db = (db - mean) / (var.sqrt() + params.norm_eps)
    db = (db * mask).transpose(1, 2)  # (B, n_mels, T)
    if t >= target:
        db = db[:, :, :target].contiguous()
    else:
        db = torch.nn.functional.pad(db, (0, target - t))
    return db.to(out_dtype)


def log_mel_frontend_plain(waveforms: torch.Tensor, lengths: torch.Tensor,
                           params: FrontendParams, normalize: bool = True,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Batched waveforms -> log-mel features (plain PyTorch).

    Args:
      waveforms: (B, L) float32, zero-padded beyond each true length.
      lengths: (B,) integer true sample counts.
      params: from :func:`make_frontend_params`, on the waveforms' device.
      normalize: the masked per-utterance mean / ddof=1 std normalization;
        without it the features are raw dB.
      out_dtype: the features are computed in float32 and cast last.

    Returns (B, n_mels, target_length) ``out_dtype``, frames past each
    valid count zero.  The FFT and the mel projection run in float32; on
    CUDA the projection uses TF32 only if
    ``torch.backends.cuda.matmul.allow_tf32`` is set.
    """
    lengths = lengths.to(torch.int64).clamp(0, waveforms.shape[1])  # as K1
    frames = _frames(waveforms.float(), lengths, params.n_fft,
                     params.hop_length, params.frontend == "torchaudio")
    spec = torch.fft.rfft(frames * params.window, dim=-1)
    power = spec.real.square() + spec.imag.square()
    mel = torch.matmul(power, params.mel_fb)  # (B, T, n_mels)
    db = 10.0 * torch.log10(mel.clamp(min=1e-10))
    return _finish(db, lengths, params, normalize, out_dtype)


def log_mel_frontend(waveforms: torch.Tensor, lengths: torch.Tensor,
                     params: FrontendParams, normalize: bool = True,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`log_mel_frontend_plain`'s contract.  CPU tensors, and the
    librosa mode on any device, take the plain version.  CUDA tensors of
    the torchaudio mode run the K3 kernel at the reference geometry; at any
    other they are framed here, go through the K4 kernel as (B * T, n_fft)
    frames (one launch per batch) and are finished by :func:`_finish`."""
    from speech_intent_recognizer_tpu_torch.ops import frontend_kernels as fk

    if params.frontend != "torchaudio":  # no kernel serves this mode
        return log_mel_frontend_plain(waveforms, lengths, params, normalize,
                                      out_dtype)
    if waveforms.device.type == "cpu" or fk.is_reference_geometry(params):
        return fk.frontend(waveforms, lengths, params, normalize, out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    if waveforms.dim() != 2 or lengths.shape != waveforms.shape[:1]:
        raise ValueError(f"expected (B, L) waveforms and (B,) lengths, got "
                         f"{tuple(waveforms.shape)} / {tuple(lengths.shape)}")
    lengths = lengths.to(torch.int64).clamp(0, waveforms.shape[1])
    frames = _frames(waveforms.float(), lengths, params.n_fft,
                     params.hop_length)
    b, t, n_fft = frames.shape
    db = fk.mel_db(frames.reshape(b * t, n_fft), params)
    return _finish(db.view(b, t, params.n_mels), lengths, params, normalize,
                   out_dtype)


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
