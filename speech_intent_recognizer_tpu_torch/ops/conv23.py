"""K5, conv2 + conv3 of the conv stack in one kernel — wrapper, plain
version, operands, counter.

Replaces ``speech_intent_recognizer_tpu/ops/conv23_pallas.py``
(``_conv23_kernel``, wrapper ``conv23_pallas``, operands
``conv23_operands``).  CUDA source ``csrc/conv23.cu``: nine tap products per
stage on the tensor cores (``nvcuda::wmma``), both stages in one launch with
stage 1's pooled output in shared memory; its header says what bounds it on
the H100.

Rounding points, the same in the kernel and the plain version: operands
bf16, sums fp32, bias added in fp32, ReLU, 2x2 max-pool, stage 1's pooled
output rounded to bf16 before conv3, bf16 out.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from speech_intent_recognizer_tpu_torch import _build

# geometry compiled into csrc/conv23.cu
M1, C1, C2, C3 = 32, 32, 64, 128
W2_LD, W3_LD = 72, 136  # padded output-channel strides of the weights


def _pack(w: torch.Tensor, ld: int) -> torch.Tensor:
    """(O, I, km, kt) reference-layout kernel -> (9, I, ld) bf16,
    [tap = kt * 3 + km][cin][cout], columns past O zero."""
    o, i = w.shape[:2]
    taps = w.detach().float().permute(3, 2, 1, 0).reshape(9, i, o)
    out = torch.zeros((9, i, ld), dtype=torch.bfloat16, device=w.device)
    out[:, :, :o] = taps.to(torch.bfloat16)
    return out


def _unpack(wp: torch.Tensor, o: int) -> torch.Tensor:
    """Inverse of :func:`_pack`: (9, I, ld) -> (O, I, km, kt) float32."""
    i = wp.shape[1]
    return wp[:, :, :o].float().reshape(3, 3, i, o).permute(3, 2, 1, 0)


def conv23_operands(conv2_weight: torch.Tensor, conv2_bias: torch.Tensor,
                    conv3_weight: torch.Tensor, conv3_bias: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """The kernel's operands from the BN-folded conv2 / conv3 stages.

    Takes the *original-orientation* reference-layout tensors (kernel dims
    (mel, time)): ``conv2.weight`` (64, 32, 3, 3), ``conv3.weight``
    (128, 64, 3, 3) and their biases.  Returns ``(w2, b2, w3, b3)`` on the
    weights' device: w2 (9, 32, 72) and w3 (9, 64, 136) bf16,
    [tap = kt * 3 + km][cin][cout] with the cout stride padded for the
    kernel's shared-memory layout; b2 (64,), b3 (128,) float32.
    """
    if tuple(conv2_weight.shape) != (C2, C1, 3, 3) or \
            tuple(conv3_weight.shape) != (C3, C2, 3, 3) or \
            tuple(conv2_bias.shape) != (C2,) or \
            tuple(conv3_bias.shape) != (C3,):
        raise ValueError("conv23 kernel requires channels (32, 64, 128)")
    return (_pack(conv2_weight, W2_LD),
            conv2_bias.detach().float().contiguous(),
            _pack(conv3_weight, W3_LD),
            conv3_bias.detach().float().contiguous())


def _check(x, w2, b2, w3, b3) -> None:
    if x.dim() != 3 or x.shape[2] != M1 * C1 or x.shape[1] % 4:
        raise ValueError("conv23 kernel requires (B, 4k, 1024) input")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"conv23 takes bfloat16 activations, got {x.dtype}")
    want = (((9, C1, W2_LD), torch.bfloat16), ((C2,), torch.float32),
            ((9, C2, W3_LD), torch.bfloat16), ((C3,), torch.float32))
    for t, (shape, dtype) in zip((w2, b2, w3, b3), want):
        if tuple(t.shape) != shape or t.dtype != dtype or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError("conv23 operands must come from "
                             "conv23_operands, on the activations' device")


def _stage(x, w, b):
    y = F.conv2d(x, w, None, padding=1) + b[None, :, None, None]
    return F.max_pool2d(F.relu(y), 2).to(torch.bfloat16).float()


def _conv23_plain(x, w2, b2, w3, b3) -> torch.Tensor:
    """Plain PyTorch K5 on the same operands: fp32 convolutions of the
    bf16-valued operands (exact products, fp32 sums), fp32 bias, ReLU, pool,
    each stage's result rounded to bf16."""
    b, t1, _ = x.shape
    # (B, T1, M1*C1) -> (B, C1, M1, T1): the standard (mel, time) orientation
    y = x.float().view(b, t1, M1, C1).permute(0, 3, 2, 1)
    y = _stage(y, _unpack(w2, C2), b2)
    y = _stage(y, _unpack(w3, C3), b3)
    # (B, C3, M3, T3) -> (B, T3, M3*C3), lane = m * 128 + c
    return y.permute(0, 3, 2, 1).reshape(b, t1 // 4, -1).to(torch.bfloat16)


def conv23(x: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
           w3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """conv2 + pool + conv3 + pool on K1's output.

    Args:
      x: (B, T1, 1024) bf16 pooled conv1 activations, lane = m * 32 + c
        (``log_mel_conv1_frontend``'s layout), T1 a multiple of 4 (100 at
        the reference geometry).
      w2, b2, w3, b3: from :func:`conv23_operands`.

    Returns (B, T1 / 4, 1024) bf16, lane = m * 128 + c with m in 0..7, the
    input of ``CNNAudioGRU(conv_external=True)``.  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise.
    """
    _check(x, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return _conv23_plain(x, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("conv23 takes contiguous activations")
    b, t1, _ = x.shape
    out = torch.empty((b, t1 // 4, (M1 // 4) * C3), dtype=torch.bfloat16,
                      device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.sir_conv23(x.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                            w3.data_ptr(), b3.data_ptr(), out.data_ptr(), b,
                            t1, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "conv23")
    conv23.launches += 1
    return out


conv23.launches = 0
