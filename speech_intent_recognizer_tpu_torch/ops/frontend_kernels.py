"""The fused front-end kernels — wrappers, plain versions, counters.

* K1, :func:`frontend_conv1`, replaces
  ``speech_intent_recognizer_tpu/ops/frontend_pallas.py``
  ``_fused_conv1_kernel`` (wrapper ``fused_frontend_conv1_pallas``).  CUDA
  source ``csrc/frontend_conv1.cu``: one thread block per utterance does
  reflect padding, windowed FP32 FFT, |X|^2, HTK mel projection, dB, masked
  mean / ddof=1 std normalization, then conv1 (3x3, 1->C, BN-folded bias,
  bf16 operands, fp32 sums) + ReLU + 2x2 max-pool, all in shared memory.
* K3, :func:`frontend`, replaces ``_fused_kernel`` (wrapper
  ``fused_frontend_pallas``), the feature precompute's kernel.  CUDA source
  ``csrc/frontend.cu``: the same core (``csrc/frontend_core.cuh``) without
  conv1, storing (B, 64, 200) mel-major features, normalized or raw dB, in
  f32 or bf16.

Each source's header says what bounds it on the H100 and how the design
answers that.  Both kernels serve exactly the reference geometry:
torchaudio mode, n_fft 1024, hop 512, 64 mels, 200 output frames (and 32
conv1 channels for K1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from speech_intent_recognizer_tpu_torch import _build
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    FrontendParams, log_mel_frontend_plain)

# geometry compiled into csrc/frontend_core.cuh and csrc/frontend_conv1.cu
N_FFT, HOP, N_MELS, T_OUT, C1 = 1024, 512, 64, 200, 32


def _check_geometry(waveforms, lengths, params: FrontendParams, what: str):
    if waveforms.dim() != 2 or lengths.shape != waveforms.shape[:1]:
        raise ValueError(f"expected (B, L) waveforms and (B,) lengths, got "
                         f"{tuple(waveforms.shape)} / {tuple(lengths.shape)}")
    if (params.n_fft, params.hop_length, params.n_mels,
            params.target_length) != (N_FFT, HOP, N_MELS, T_OUT):
        raise ValueError(f"{what} supports n_fft=1024, hop=512, n_mels=64, "
                         "mel_spec_length=200 only")
    if 1 + waveforms.shape[1] // HOP > T_OUT:
        raise ValueError(f"buffer of {waveforms.shape[1]} samples holds more "
                         f"than {T_OUT} frames")


def _check_cuda_operands(waveforms, lengths) -> torch.device:
    if waveforms.device.type != "cuda":
        raise ValueError(f"unsupported device {waveforms.device}")
    dev = waveforms.device
    if waveforms.dtype != torch.float32 or not waveforms.is_contiguous():
        raise ValueError("waveforms must be contiguous float32")
    if (lengths.dtype != torch.int32 or lengths.device != dev
            or not lengths.is_contiguous()):
        raise ValueError("lengths must be contiguous int32 on the waveforms' "
                         "device")
    return dev


def _filterbank_operands(params: FrontendParams, dev) -> tuple:
    consts = (params.window, params.twiddle, params.fb_packed, params.fb_off,
              params.fb_lo)
    if any(c.device != dev or not c.is_contiguous() for c in consts):
        raise ValueError("front-end operands must be contiguous tensors on "
                         "the waveforms' device")
    return consts


def _frontend_conv1_plain(waveforms, lengths, params, conv1_weight,
                          conv1_bias):
    """Plain PyTorch K1: the plain front-end, the image rounded to bf16,
    conv1 on bf16-rounded operands with fp32 sums (exact products, so TF32
    changes nothing here), ReLU, 2x2 max-pool, bf16 out."""
    feats = log_mel_frontend_plain(waveforms, lengths, params)  # (B, M, T)
    x = feats.to(torch.bfloat16).float().unsqueeze(1)
    w = conv1_weight.to(torch.bfloat16).float()
    b = conv1_bias.to(torch.bfloat16).float()
    y = F.max_pool2d(F.relu(F.conv2d(x, w, b, padding=1)), 2)
    n, c, m, t = y.shape  # (B, C, M/2, T/2)
    return y.permute(0, 3, 2, 1).reshape(n, t, m * c).to(torch.bfloat16)


def frontend_conv1(waveforms: torch.Tensor, lengths: torch.Tensor,
                   params: FrontendParams, conv1_weight: torch.Tensor,
                   conv1_bias: torch.Tensor) -> torch.Tensor:
    """(B, L) f32 waveforms + (B,) lengths -> (B, 100, 1024) bf16 pooled
    conv1 output, lane = m_pooled * 32 + c.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise).  Both clamp lengths to [0, L]; callers keep them below L, as
    the reference requires.
    """
    _check_geometry(waveforms, lengths, params, "K1")
    if tuple(conv1_weight.shape) != (C1, 1, 3, 3) or \
            tuple(conv1_bias.shape) != (C1,):
        raise ValueError("K1 expects a (32, 1, 3, 3) conv1 weight and a "
                         "(32,) bias")
    if waveforms.device.type == "cpu":
        return _frontend_conv1_plain(waveforms, lengths, params,
                                     conv1_weight, conv1_bias)
    dev = _check_cuda_operands(waveforms, lengths)
    w = conv1_weight.to(torch.bfloat16).contiguous()
    b = conv1_bias.to(torch.bfloat16).contiguous()
    _filterbank_operands(params, dev)
    batch, width = waveforms.shape
    out = torch.empty((batch, T_OUT // 2, (N_MELS // 2) * C1),
                      dtype=torch.bfloat16, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.sir_frontend_conv1(
            waveforms.data_ptr(), lengths.data_ptr(), batch, width,
            params.window.data_ptr(), params.twiddle.data_ptr(),
            params.fb_packed.data_ptr(), params.fb_off.data_ptr(),
            params.fb_lo.data_ptr(), params.fb_packed.numel(),
            w.data_ptr(), b.data_ptr(), out.data_ptr(),
            float(params.norm_eps), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "frontend_conv1")
    frontend_conv1.launches += 1
    return out


frontend_conv1.launches = 0


def frontend(waveforms: torch.Tensor, lengths: torch.Tensor,
             params: FrontendParams, normalize: bool = True,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, L) f32 waveforms + (B,) lengths -> (B, 64, 200) log-mel
    features in ``out_dtype`` (float32 or bfloat16), normalized or raw dB,
    frames past each valid count zero (:func:`.frontend.
    log_mel_frontend_plain`'s contract).

    CPU tensors take the plain version (any geometry); CUDA tensors launch
    the kernel, which serves the reference geometry only, or raise.  Any
    buffer width with 1 + L // 512 <= 200 works: samples at or past L read
    as zero.
    """
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    if waveforms.device.type == "cpu":
        return log_mel_frontend_plain(waveforms, lengths, params, normalize,
                                      out_dtype)
    _check_geometry(waveforms, lengths, params, "K3")
    dev = _check_cuda_operands(waveforms, lengths)
    window, twiddle, fb_packed, fb_off, fb_lo = _filterbank_operands(
        params, dev)
    batch, width = waveforms.shape
    out = torch.empty((batch, N_MELS, T_OUT), dtype=out_dtype, device=dev)
    lib = _build.load()
    fn = (lib.sir_frontend_f32 if out_dtype == torch.float32
          else lib.sir_frontend_bf16)
    with torch.cuda.device(dev):
        rc = fn(waveforms.data_ptr(), lengths.data_ptr(), batch, width,
                window.data_ptr(), twiddle.data_ptr(), fb_packed.data_ptr(),
                fb_off.data_ptr(), fb_lo.data_ptr(), fb_packed.numel(),
                out.data_ptr(), int(normalize), float(params.norm_eps),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "frontend")
    frontend.launches += 1
    return out


frontend.launches = 0
