"""The forward kernels as PyTorch operators, in the ``sir`` namespace.

One op per forward kernel, each with a schema of tensors, ints, floats,
bools and strings, a fake implementation here (the output's shape and type
from the inputs' alone: it launches nothing and reads no data), and two
implementations registered beside each kernel's wrapper: ``CUDA``, the
kernel's launch, and ``CPU``, its plain PyTorch version.

======================  ======  ==========================================
op                      kernel  wrapper
======================  ======  ==========================================
``sir::frontend_conv1``  K1     ``ops/frontend_kernels.frontend_conv1``
``sir::frontend``        K3     ``ops/frontend_kernels.frontend``
``sir::mel_db``          K4     ``ops/frontend_kernels.mel_db``
``sir::gru_layer``       K2     ``ops/gru.gru_layer`` (forward)
``sir::gru_layer_btc``   K2     ``ops/gru.gru_layer_btc`` (served layout)
``sir::conv23``          K5     ``ops/conv23.conv23``
``sir::bias_relu_pool2`` K6     ``ops/pool_epilogue.bias_relu_pool2``
======================  ======  ==========================================

The wrappers keep their checks and run the plain version for CPU tensors
themselves; for CUDA tensors they call the op, so a graph traced on the
card (``torch.export``, ``infer/export.py``) holds each kernel as one node.
A front-end op takes a :class:`.frontend.FrontendParams` flattened in its
field order (:data:`PARAMS`).  ``gru_layer``'s ``kernel`` / ``rows`` and
``conv23``'s ``rows`` are what a caller forces; ``""`` and ``0`` let the
plan pick on the card that runs the call, as ``gru_layer_btc`` always does.

The ops are defined with :class:`torch.library.Library` and registered
with ``Library.impl``: ``torch.library.custom_op`` adds host work to every
call (PERF.md), and the batch-1 paths are host-bound.  K2's backward stays
inside ``ops/gru._GRULayer``.

A process that loads a serialized program holding these ops calls
:func:`load` first.
"""

from __future__ import annotations

import torch

LIB = torch.library.Library("sir", "DEF")

# FrontendParams, field for field (the kernels refuse any mode but
# torchaudio; the CPU implementations serve both)
PARAMS = ("Tensor window, Tensor mel_fb, Tensor twiddle, Tensor fb_packed, "
          "Tensor fb_off, Tensor fb_lo, int n_fft, int hop_length, "
          "int n_mels, int target_length, float norm_eps, str frontend, "
          "float global_mean, float global_std")

LIB.define("frontend_conv1(Tensor waveforms, Tensor lengths, "
           f"Tensor conv1_weight, Tensor conv1_bias, {PARAMS}) -> Tensor")
LIB.define("frontend(Tensor waveforms, Tensor lengths, bool normalize, "
           f"bool bf16, {PARAMS}) -> Tensor")
LIB.define(f"mel_db(Tensor frames, {PARAMS}) -> Tensor")
LIB.define("gru_layer(Tensor gx, Tensor w, Tensor bn, str kernel, int rows) "
           "-> Tensor")
LIB.define("gru_layer_btc(Tensor gx, Tensor w, Tensor bn) -> Tensor")
LIB.define("conv23(Tensor x, Tensor w2, Tensor b2, Tensor w3, Tensor b3, "
           "int rows) -> Tensor")
LIB.define("bias_relu_pool2(Tensor y, Tensor bias) -> Tensor")


def implement(name: str, cuda, cpu) -> None:
    """Register op ``name``'s kernel launch (``CUDA``) and plain version
    (``CPU``)."""
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")


def load() -> None:
    """Import the kernels' modules, which register the implementations."""
    from speech_intent_recognizer_tpu_torch.ops import (  # noqa: F401
        conv23, frontend_kernels, gru, pool_epilogue)


@torch.library.register_fake("sir::frontend_conv1", lib=LIB)
def _frontend_conv1_fake(waveforms, lengths, conv1_weight, conv1_bias,
                         window, mel_fb, twiddle, fb_packed, fb_off, fb_lo,
                         n_fft, hop_length, n_mels, target_length, norm_eps,
                         frontend, global_mean, global_std):
    return waveforms.new_empty(
        (waveforms.shape[0], target_length // 2,
         (n_mels // 2) * conv1_weight.shape[0]), dtype=torch.bfloat16)


@torch.library.register_fake("sir::frontend", lib=LIB)
def _frontend_fake(waveforms, lengths, normalize, bf16, window, mel_fb,
                   twiddle, fb_packed, fb_off, fb_lo, n_fft, hop_length,
                   n_mels, target_length, norm_eps, frontend, global_mean,
                   global_std):
    return waveforms.new_empty(
        (waveforms.shape[0], n_mels, target_length),
        dtype=torch.bfloat16 if bf16 else torch.float32)


@torch.library.register_fake("sir::mel_db", lib=LIB)
def _mel_db_fake(frames, window, mel_fb, twiddle, fb_packed, fb_off, fb_lo,
                 n_fft, hop_length, n_mels, target_length, norm_eps, frontend,
                 global_mean, global_std):
    return frames.new_empty((frames.shape[0], n_mels))


@torch.library.register_fake("sir::gru_layer", lib=LIB)
def _gru_layer_fake(gx, w, bn, kernel, rows):
    return gx.new_empty(gx.shape[:3] + (gx.shape[3] // 3,))


@torch.library.register_fake("sir::gru_layer_btc", lib=LIB)
def _gru_layer_btc_fake(gx, w, bn):
    return gx.new_empty(gx.shape[:2] + (gx.shape[2] // 3,))


@torch.library.register_fake("sir::conv23", lib=LIB)
def _conv23_fake(x, w2, b2, w3, b3, rows):
    # w2 is (9, C1 / 16, ...), w3 (9, C2 / 16, C3 / 8, ...); x's lanes are
    # M1 * C1 and the output's (M1 / 4) * C3
    mels = x.shape[2] // (16 * w2.shape[1])
    return x.new_empty((x.shape[0], x.shape[1] // 4,
                        (mels // 4) * 8 * w3.shape[2]))


@torch.library.register_fake("sir::bias_relu_pool2", lib=LIB)
def _bias_relu_pool2_fake(y, bias):
    b, c, t, w = y.shape
    return torch.empty((b, c, t // 2, w // 2), dtype=y.dtype,
                       device=y.device, memory_format=torch.channels_last)
