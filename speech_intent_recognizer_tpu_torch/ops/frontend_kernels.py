"""The fused front-end kernels — wrappers, plain versions, counters.

* K1, :func:`frontend_conv1`, replaces
  ``speech_intent_recognizer_tpu/ops/frontend_pallas.py``
  ``_fused_conv1_kernel`` (wrapper ``fused_frontend_conv1_pallas``).  CUDA
  source ``csrc/frontend_conv1.cu``: one thread block per utterance does
  reflect padding, windowed FP32 FFT (one warp per frame, a real-input
  transform in registers, ``csrc/warp_rfft.cuh``), |X|^2, HTK mel
  projection, dB, masked mean / ddof=1 std normalization, then conv1 (3x3,
  1->C, BN-folded bias, bf16 operands, fp32 sums) + ReLU + 2x2 max-pool, all
  in registers and shared memory.
* K3, :func:`frontend`, replaces ``_fused_kernel`` (wrapper
  ``fused_frontend_pallas``), the feature precompute's kernel.  CUDA source
  ``csrc/frontend.cu``: the same core (``csrc/frontend_core.cuh``) without
  conv1, storing (B, 64, 200) mel-major features, normalized or raw dB, in
  f32 or bf16.
* K4, :func:`mel_db`, replaces ``_mel_db_kernel`` (wrapper
  ``mel_db_pallas``), the kernel of the front-end off that geometry.  CUDA
  source ``csrc/mel_db.cu``: (N, n_fft) frames -> (N, n_mels) dB-mel rows
  through a windowed FFT, for any power-of-two n_fft from 32 to 4096 and any
  n_mels: the warp-resident transform of K1 and K3 at the sizes in
  :data:`WARP_FFT_SIZES`, radix-2 stages in shared memory at the others.

Each source's header says what bounds it on the H100 and how the design
answers that.  K1 and K3 serve exactly the reference geometry: torchaudio
mode, n_fft 1024, hop 512, 64 mels, 200 output frames (and 32 conv1
channels for K1).  No kernel serves the librosa mode (the JAX package
runs it in XLA only): on a CUDA tensor each wrapper refuses it.

Each kernel is also the ``sir`` op of its wrapper's name
(``ops/library.py``): the wrapper checks its operands and calls the op for
CUDA tensors; the op's ``CUDA`` implementation (``_*_cuda`` here) launches
the kernel and counts the launch, its ``CPU`` implementation is the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from speech_intent_recognizer_tpu_torch import _build
from speech_intent_recognizer_tpu_torch.ops import library
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    FrontendParams, log_mel_frontend_plain)

# geometry compiled into csrc/frontend_core.cuh and csrc/frontend_conv1.cu
N_FFT, HOP, N_MELS, T_OUT, C1 = 1024, 512, 64, 200, 32
# the n_fft that csrc/mel_db.cu transforms with csrc/warp_rfft.cuh
WARP_FFT_SIZES = (512, 1024, 2048)


def is_reference_geometry(params: FrontendParams) -> bool:
    """Whether K1 and K3 serve this front-end: the torchaudio mode at
    their geometry."""
    return params.frontend == "torchaudio" and (
        params.n_fft, params.hop_length, params.n_mels,
        params.target_length) == (N_FFT, HOP, N_MELS, T_OUT)


def conv1_fits(conv1_weight, conv1_bias) -> bool:
    """Whether K1 takes this conv1: a (32, 1, 3, 3) weight and a (32,)
    bias."""
    return (conv1_weight is not None and conv1_bias is not None
            and tuple(conv1_weight.shape) == (C1, 1, 3, 3)
            and tuple(conv1_bias.shape) == (C1,))


def conv1_engages(params: FrontendParams, conv1_weight, conv1_bias) -> bool:
    """Whether K1 serves this front-end and conv1: the reference geometry
    and a conv1 that :func:`conv1_fits`."""
    return is_reference_geometry(params) and conv1_fits(conv1_weight,
                                                        conv1_bias)


def _check_geometry(waveforms, lengths, params: FrontendParams, what: str):
    if waveforms.dim() != 2 or lengths.shape != waveforms.shape[:1]:
        raise ValueError(f"expected (B, L) waveforms and (B,) lengths, got "
                         f"{tuple(waveforms.shape)} / {tuple(lengths.shape)}")
    if not is_reference_geometry(params):
        raise ValueError(f"{what} supports the torchaudio mode at "
                         "n_fft=1024, hop=512, n_mels=64, mel_spec_length=200 "
                         "only")
    if 1 + waveforms.shape[1] // HOP > T_OUT:
        raise ValueError(f"buffer of {waveforms.shape[1]} samples holds more "
                         f"than {T_OUT} frames")


def _torchaudio_only(params: FrontendParams) -> None:
    if params.frontend != "torchaudio":
        raise ValueError("the front-end kernels serve the torchaudio mode "
                         f"only, not {params.frontend!r}")


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
    if not conv1_fits(conv1_weight, conv1_bias):
        raise ValueError("K1 expects a (32, 1, 3, 3) conv1 weight and a "
                         "(32,) bias")
    if waveforms.device.type == "cpu":
        return _frontend_conv1_plain(waveforms, lengths, params,
                                     conv1_weight, conv1_bias)
    _filterbank_operands(params, _check_cuda_operands(waveforms, lengths))
    return torch.ops.sir.frontend_conv1(waveforms, lengths, conv1_weight,
                                        conv1_bias, *params)


def _frontend_conv1_cuda(waveforms, lengths, conv1_weight, conv1_bias,
                         *flat):
    params = FrontendParams(*flat)
    _torchaudio_only(params)
    dev = waveforms.device
    w = conv1_weight.to(torch.bfloat16).contiguous()
    b = conv1_bias.to(torch.bfloat16).contiguous()
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
    _filterbank_operands(params, _check_cuda_operands(waveforms, lengths))
    return torch.ops.sir.frontend(waveforms, lengths, normalize,
                                  out_dtype == torch.bfloat16, *params)


def _frontend_cuda(waveforms, lengths, normalize, bf16, *flat):
    params = FrontendParams(*flat)
    _torchaudio_only(params)
    dev = waveforms.device
    batch, width = waveforms.shape
    out = torch.empty((batch, N_MELS, T_OUT),
                      dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=dev)
    lib = _build.load()
    fn = lib.sir_frontend_bf16 if bf16 else lib.sir_frontend_f32
    with torch.cuda.device(dev):
        rc = fn(waveforms.data_ptr(), lengths.data_ptr(), batch, width,
                params.window.data_ptr(), params.twiddle.data_ptr(),
                params.fb_packed.data_ptr(), params.fb_off.data_ptr(),
                params.fb_lo.data_ptr(), params.fb_packed.numel(),
                out.data_ptr(), int(normalize), float(params.norm_eps),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "frontend")
    frontend.launches += 1
    return out


frontend.launches = 0


def dft_matrices(params: FrontendParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dft_cos, dft_sin)``, each (n_fft, n_fft // 2 + 1) float32 with the
    window folded in (computed in float64): the dense operands of the JAX
    package's front-end, which only the plain K4 uses here."""
    n_fft = params.n_fft
    dev = params.window.device
    n = torch.arange(n_fft, dtype=torch.float64, device=dev)[:, None]
    f = torch.arange(n_fft // 2 + 1, dtype=torch.float64, device=dev)[None, :]
    angle = 2.0 * torch.pi * n * f / n_fft
    win = params.window.double()[:, None]
    return ((torch.cos(angle) * win).float(),
            (-torch.sin(angle) * win).float())


def _mel_db_plain(frames: torch.Tensor, params: FrontendParams,
                  dft: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> torch.Tensor:
    """Plain PyTorch K4, the JAX kernel's arithmetic: ``frames @ dft_cos``,
    ``frames @ dft_sin``, power, ``@ mel_fb``, dB, all float32 with TF32
    off.  ``dft`` takes :func:`dft_matrices`' result where a caller has it
    already."""
    wcos, wsin = dft if dft is not None else dft_matrices(params)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        c = frames @ wcos
        s = frames @ wsin
        mel = (c * c + s * s) @ params.mel_fb
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return 10.0 * torch.log10(mel.clamp(min=1e-10))


def mel_db(frames: torch.Tensor, params: FrontendParams) -> torch.Tensor:
    """(N, n_fft) float32 raw frames -> (N, n_mels) float32 dB-mel:
    window, DFT, power, mel projection, ``10 * log10(max(., 1e-10))``.

    CPU tensors take the plain version (any n_fft); CUDA tensors launch the
    kernel or raise.  The kernel transforms each frame with an FFT, so it
    serves the n_fft that are powers of two from 32 to 4096, with any
    window length up to n_fft, any n_mels and any N >= 0.  At n_fft 512,
    1024 and 2048 (:data:`WARP_FFT_SIZES`) one warp transforms one frame in
    registers, as a real-input transform of half the size; at 32, 64, 128,
    256 and 4096 a block runs radix-2 stages in shared memory.  The grid is
    what the frames need or the card holds at once, whichever is fewer
    (persistent blocks walk over the rest).
    """
    if frames.dim() != 2 or frames.shape[1] != params.n_fft:
        raise ValueError(f"expected (N, {params.n_fft}) frames, got "
                         f"{tuple(frames.shape)}")
    if frames.dtype != torch.float32:
        raise ValueError(f"mel_db takes float32 frames, got {frames.dtype}")
    if frames.device.type == "cpu":
        return _mel_db_plain(frames, params)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    _torchaudio_only(params)
    n_fft = params.n_fft
    if n_fft & (n_fft - 1) or not 32 <= n_fft <= 4096:
        raise ValueError(f"the K4 kernel transforms frames with a "
                         f"power-of-two FFT: n_fft must be a power of two "
                         f"from 32 to 4096, got {n_fft}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    _filterbank_operands(params, frames.device)
    return torch.ops.sir.mel_db(frames, *params)


def _mel_db_cuda(frames, *flat):
    params = FrontendParams(*flat)
    _torchaudio_only(params)
    dev = frames.device
    n = frames.shape[0]
    out = torch.empty((n, params.n_mels), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.sir_mel_db(frames.data_ptr(), n, params.n_fft,
                            params.n_mels, params.window.data_ptr(),
                            params.twiddle.data_ptr(),
                            params.fb_packed.data_ptr(),
                            params.fb_off.data_ptr(), params.fb_lo.data_ptr(),
                            params.fb_packed.numel(), out.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "mel_db")
    mel_db.launches += 1
    return out


mel_db.launches = 0

# the ops' CPU implementations: the plain versions on flattened params
def _frontend_conv1_cpu(waveforms, lengths, conv1_weight, conv1_bias, *flat):
    return _frontend_conv1_plain(waveforms, lengths, FrontendParams(*flat),
                                 conv1_weight, conv1_bias)


def _frontend_cpu(waveforms, lengths, normalize, bf16, *flat):
    return log_mel_frontend_plain(waveforms, lengths, FrontendParams(*flat),
                                  normalize,
                                  torch.bfloat16 if bf16 else torch.float32)


def _mel_db_cpu(frames, *flat):
    return _mel_db_plain(frames, FrontendParams(*flat))


library.implement("frontend_conv1", _frontend_conv1_cuda, _frontend_conv1_cpu)
library.implement("frontend", _frontend_cuda, _frontend_cpu)
library.implement("mel_db", _mel_db_cuda, _mel_db_cpu)

def kernel_resources(dev: "str | torch.device",
                     mel_db_params: Tuple[FrontendParams, ...] = ()
                     ) -> Dict[str, Dict[str, int]]:
    """What the built K1, K3 and K4 kernels take on the card ``dev``:
    registers per thread, bytes of local memory per thread (spills),
    shared memory per block, threads per block, and the blocks of that
    shape one SM holds (``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).  K4 is reported for
    each front-end of ``mel_db_params`` (its kernel and shared memory
    depend on n_fft, n_mels and the filterbank).  Launches nothing."""
    lib = _build.load()
    keys = ("registers", "local_bytes", "shared_bytes", "threads",
            "blocks_per_sm")

    def query(fn, *args) -> Dict[str, int]:
        out = (ctypes.c_int * len(keys))()
        _build.check(fn(*args, ctypes.addressof(out)), "kernel_resources")
        return dict(zip(keys, out))

    with torch.cuda.device(dev):
        found = {"frontend_conv1": query(lib.sir_frontend_conv1_info),
                 "frontend_f32": query(lib.sir_frontend_info, 0),
                 "frontend_bf16": query(lib.sir_frontend_info, 1)}
        for p in mel_db_params:
            found[f"mel_db_n{p.n_fft}_m{p.n_mels}"] = query(
                lib.sir_mel_db_info, p.n_fft, p.n_mels, p.fb_packed.numel())
    return found
