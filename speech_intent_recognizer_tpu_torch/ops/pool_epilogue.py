"""K6, the conv epilogue ``maxpool2x2(relu(y + bias))`` — wrapper, plain
version, counter.

Replaces ``speech_intent_recognizer_tpu/ops/pool_epilogue_pallas.py``
(``_pool_epilogue_kernel_f32`` / ``_pool_epilogue_kernel_bf16``, wrapper
``bias_relu_pool2_pallas``).  CUDA source ``csrc/pool_epilogue.cu``: one
thread per 16-byte channel vector of one output pixel; its header says what
bounds it on the H100.  The convolution before it stays a library call
(``F.conv2d`` without bias), as the JAX package leaves it to XLA.  The
kernel is the op ``sir::bias_relu_pool2`` (``ops/library.py``): the
wrapper calls it for CUDA tensors, and its ``CUDA`` implementation
(:func:`_bias_relu_pool2_cuda`) checks the layout, launches and counts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from speech_intent_recognizer_tpu_torch import _build
from speech_intent_recognizer_tpu_torch.ops import library


def _check(y: torch.Tensor, bias: torch.Tensor) -> None:
    if y.dim() != 4:
        raise ValueError(f"expected a (B, C, T, W) conv output, got "
                         f"{tuple(y.shape)}")
    b, c, t, w = y.shape
    if t % 2 or w < 4 or (w & (w - 1)) or (w * c) % 128:
        raise ValueError(f"unsupported pool epilogue geometry "
                         f"{(b, t, w, c)} (B, T, W, C)")
    if tuple(bias.shape) != (c,):
        raise ValueError(f"expected a ({c},) bias, got {tuple(bias.shape)}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {y.dtype}")
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad):
        raise RuntimeError("bias_relu_pool2 is inference-only: it has no "
                           "backward; run it under torch.no_grad()")


def _bias_relu_pool2_plain(y: torch.Tensor, bias: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch K6: the bias cast to ``y``'s type and added in it (for
    bf16: an fp32 add rounded once to bf16), ReLU, 2x2 max-pool."""
    return F.max_pool2d(F.relu(y + bias.to(y.dtype)[None, :, None, None]), 2)


def bias_relu_pool2(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``maxpool2x2(relu(y + bias))`` on the raw output of a convolution.

    Args:
      y: (B, C, T, W) float32 or bfloat16 **in channels-last memory**, that
        is (B, T, W, C) contiguous, as ``F.conv2d`` returns it for a
        channels-last input; T even, W a power of two >= 4, W * C a multiple
        of 128 (the JAX kernel's geometry).  No bias applied yet.
      bias: (C,) per-channel bias (the BN-folded conv bias), any float type;
        it is rounded to ``y``'s type first.

    Returns (B, C, T/2, W/2) in ``y``'s type, channels-last.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    reads the tensor in place and raises for any other stride (it does not
    copy).  float32 is exact.  bfloat16 adds the bf16-rounded bias in fp32
    and rounds the sum once to bf16 before ReLU and the maximum.  ReLU gives
    +0.0 for -0.0 and for every negative, so the kernel never returns -0.0
    (torch's ops may: the two compare equal); NaN passes through ReLU and
    the maximum, as in torch.  Inference-only: raises when gradients are
    enabled and an operand requires one.
    """
    _check(y, bias)
    if y.device.type == "cpu":
        return _bias_relu_pool2_plain(y, bias)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    return torch.ops.sir.bias_relu_pool2(y, bias)


def _bias_relu_pool2_cuda(y, bias):
    b, c, t, w = y.shape
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bias_relu_pool2 reads (B, T, W, C)-contiguous "
                         "memory: pass a channels-last (B, C, T, W) tensor")
    bias_t = bias.detach().to(y.device, y.dtype).contiguous()
    out = torch.empty((b, c, t // 2, w // 2), dtype=y.dtype, device=y.device,
                      memory_format=torch.channels_last)
    lib = _build.load()
    fn = (lib.sir_pool_epilogue_f32 if y.dtype == torch.float32
          else lib.sir_pool_epilogue_bf16)
    with torch.cuda.device(y.device):
        rc = fn(y.data_ptr(), bias_t.data_ptr(), out.data_ptr(), b, t, w, c,
                torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(rc, "pool_epilogue")
    bias_relu_pool2.launches += 1
    return out


library.implement("bias_relu_pool2", _bias_relu_pool2_cuda,
                  _bias_relu_pool2_plain)
bias_relu_pool2.launches = 0
