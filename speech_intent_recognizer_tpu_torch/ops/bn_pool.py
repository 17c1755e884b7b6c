"""K7, the training conv stage's epilogue: BatchNorm on the batch's
statistics, ReLU and 2x2 max-pool, forward and backward — wrapper, plain
version, counters and the rule that engages it.

Replaces no TPU kernel: the JAX package leaves its training epilogue to
XLA.  In the port the chain ``BatchNorm2d`` (an fp32 channels-last copy of
the bf16 conv output, ``torch.var_mean``, ``native_batch_norm``) ->
``F.relu`` -> cast to bf16 -> ``F.max_pool2d`` and its backward moved
about 88 bytes a value of the conv output; K7 (``csrc/bn_relu_pool.cu``,
whose header says what bounds it) moves 10.5 and rounds where that chain
rounds: the conv output in bf16, BatchNorm in fp32, one rounding to bf16
before the pool, the BatchNorm backward in fp32 rounded once to bf16.

:func:`engages` is the rule: a training-mode BatchNorm with no sync group,
on a bf16 CUDA tensor of even height and width and a multiple of 8
channels.  ``CNNAudioGRU._conv`` asks it and, where it holds, hands the
conv a channels-last input and calls :func:`bn_relu_pool2_train` on its
output; every other input keeps the torch chain.  The kernels save the
conv output and, for each pooled value, the conv output at its window's
argmax; the backward finds each argmax again with the forward's
arithmetic.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from speech_intent_recognizer_tpu_torch import _build
from speech_intent_recognizer_tpu_torch.utils.profiling import span

VEC = 8                # bf16 channels in the kernels' 16-byte vectors
MAX_CHANNELS = 2048    # 256 threads x VEC
_DIMS = (0, 2, 3)      # every axis of an NCHW tensor but the channel's


def _kernel_device(t: torch.Tensor) -> bool:
    """Whether ``t`` lies where the kernels run."""
    return t.device.type == "cuda"


def _fits(dtype: torch.dtype, b: int, c: int, h: int, w: int) -> bool:
    """Whether K7 takes a (b, c, h, w) tensor of type ``dtype``: bfloat16,
    height and width even, channels a multiple of 8 up to 2048, 0 < b * h
    * w < 2^31 (the C side's ``bad_shape``)."""
    return (dtype == torch.bfloat16 and h % 2 == 0 and w % 2 == 0
            and 0 < c <= MAX_CHANNELS and c % VEC == 0
            and 0 < b * h * w < 2 ** 31)


def engages(bn, x: torch.Tensor) -> bool:
    """Whether the epilogue of the BatchNorm ``bn`` runs K7 on the output
    of the conv whose input is ``x`` (the output has ``x``'s device, type,
    batch, height and width and ``bn.num_features`` channels): ``bn`` in
    training mode with no sync group, ``x`` a CUDA tensor of a shape and
    type K7 takes."""
    b, _c, h, w = x.shape
    return (bn.training and bn.sync_group is None and _kernel_device(x)
            and _fits(x.dtype, b, bn.num_features, h, w))


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` with channels-last strides, so that a conv on it writes its
    output channels-last.  A contiguous one-channel tensor is already laid
    out so, but torch keeps its NCHW strides (and cuDNN then writes the
    output NCHW): it is restrided in place, without a copy."""
    b, c, h, w = x.shape
    if c == 1 and x.is_contiguous():
        return x.as_strided(x.shape, (h * w, 1, w, 1))
    return x.contiguous(memory_format=torch.channels_last)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


# ------------------------------------------------------- plain versions

def _stats_plain(y: torch.Tensor, eps: float):
    """The batch's mean, biased variance and invstd per channel, fp32."""
    var, mean = torch.var_mean(y.float(), _DIMS, correction=0)
    return mean, var, 1.0 / torch.sqrt(var + eps)


def _apply_plain(y, weight, bias, mean, invstd):
    """The apply pass on given statistics: (pooled output, y at each
    window's argmax), both in ``y``'s type.  z = (y - mean) * (invstd *
    weight) + bias, each op rounded, as the kernel rounds it."""
    z = (y.float() - _col(mean)) * _col(invstd * weight) + _col(bias)
    out, idx = F.max_pool2d(F.relu(z).to(y.dtype), 2, return_indices=True)
    yarg = torch.gather(y.flatten(2), 2, idx.flatten(2)).view(out.shape)
    return out, yarg


def _forward_plain(y, weight, bias, eps):
    """Plain K7 forward: (out, yarg, mean, var, invstd)."""
    mean, var, invstd = _stats_plain(y, eps)
    return (*_apply_plain(y, weight, bias, mean, invstd), mean, var, invstd)


def _backward_plain(y, yarg, dout, weight, bias, mean, invstd):
    """Plain K7 backward on the forward's statistics: (dy in ``y``'s type,
    weight and bias gradients in fp32).  The sums come from the argmax
    values alone; each window's gradient goes where torch's max_pool2d
    sends it, and through ReLU where z > 0."""
    b, c, h, w = y.shape
    m, scale = _col(mean), _col(invstd * weight)
    a = yarg.float() - m
    dz_arg = torch.where(a * scale + _col(bias) > 0, dout.float(), 0.0)
    sum_dy = dz_arg.sum(_DIMS)
    sum_dy_xmu = (dz_arg * a).sum(_DIMS)
    norm = 1.0 / torch.tensor(float(b * h * w), device=y.device)
    k1 = sum_dy * norm
    k2 = invstd * invstd * sum_dy_xmu * norm
    k3 = weight * invstd
    xmu = y.float() - m
    r = F.relu(xmu * scale + _col(bias)).to(y.dtype)
    _, idx = F.max_pool2d(r, 2, return_indices=True)
    dz = torch.zeros((b, c, h * w), device=y.device).scatter_(
        2, idx.flatten(2), dz_arg.flatten(2)).view(b, c, h, w)
    dy = ((dz - _col(k1)) - xmu * _col(k2)) * _col(k3)
    return dy.to(y.dtype), sum_dy_xmu * invstd, sum_dy


# ------------------------------------------------------------ the kernel

def _check(y, weight, bias) -> None:
    b, c, h, w = y.shape
    if not _fits(y.dtype, b, c, h, w):
        raise ValueError(f"K7 takes a bfloat16 (B, C, H, W) tensor, H and W "
                         f"even, C a multiple of {VEC} up to {MAX_CHANNELS}, "
                         f"0 < B * H * W < 2^31; got {y.dtype} "
                         f"{tuple(y.shape)}")
    if not y.is_contiguous(memory_format=torch.channels_last) \
            or y.data_ptr() % 16:
        raise ValueError("K7 reads (B, H, W, C)-contiguous memory, 16-byte "
                         "aligned: pass a channels-last (B, C, H, W) tensor")
    for t in (weight, bias):
        if (t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or t.device != y.device or not t.is_contiguous()):
            raise ValueError(f"K7 takes a float32 ({c},) weight and bias on "
                             f"{y.device}")


@functools.lru_cache(maxsize=None)
def _scratch_floats(c: int) -> int:
    """The floats of scratch the kernels take at ``c`` channels, as the C
    side lays it out."""
    n = ctypes.c_longlong()
    _build.check(_build.load().sir_bn_pool_scratch(c, ctypes.addressof(n)),
                 "bn_pool scratch")
    return n.value


def _scratch(y: torch.Tensor) -> torch.Tensor:
    return torch.empty((_scratch_floats(y.shape[1]),), dtype=torch.float32,
                       device=y.device)


def _launch_forward(y, weight, bias, eps):
    """K7's forward on the card: statistics, their merge, apply."""
    _check(y, weight, bias)
    b, c, h, w = y.shape
    out = torch.empty((b, c, h // 2, w // 2), dtype=y.dtype, device=y.device,
                      memory_format=torch.channels_last)
    yarg = torch.empty_like(out)
    mean, var, invstd = (torch.empty(c, dtype=torch.float32, device=y.device)
                         for _ in range(3))
    part = _scratch(y)
    with torch.cuda.device(y.device):
        rc = _build.load().sir_bn_pool_forward(
            y.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            yarg.data_ptr(), mean.data_ptr(), var.data_ptr(),
            invstd.data_ptr(), part.data_ptr(), b, h, w, c, eps,
            torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(rc, "bn_relu_pool2_train")
    return out, yarg, mean, var, invstd


def _launch_backward(y, yarg, dout, weight, bias, mean, invstd):
    """K7's backward on the card: reduce, merge, gradient."""
    b, c, h, w = y.shape
    dout = dout.to(y.dtype).contiguous(memory_format=torch.channels_last)
    dy = torch.empty_like(y, memory_format=torch.channels_last)
    dweight, dbias = (torch.empty(c, dtype=torch.float32, device=y.device)
                      for _ in range(2))
    part = _scratch(y)
    with torch.cuda.device(y.device):
        rc = _build.load().sir_bn_pool_backward(
            y.data_ptr(), yarg.data_ptr(), dout.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
            dy.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
            part.data_ptr(), b, h, w, c,
            torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(rc, "bn_relu_pool2_train backward")
    return dy, dweight, dbias


class _BnReluPool2Train(torch.autograd.Function):
    """K7 forward and backward (or, with ``plain``, their plain versions);
    saves y, y at each argmax, weight, bias, mean and invstd."""

    @staticmethod
    def forward(ctx, y, weight, bias, eps, plain):
        weight, bias = weight.detach(), bias.detach()
        if plain:
            out, yarg, mean, var, invstd = _forward_plain(y, weight, bias,
                                                          eps)
        else:
            out, yarg, mean, var, invstd = _launch_forward(y, weight, bias,
                                                           eps)
            bn_relu_pool2_train.launches += 1
        ctx.plain = plain
        ctx.save_for_backward(y, yarg, weight, bias, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        with span("sir.conv.bn_pool.backward"):
            if ctx.plain:
                dy, dw, db = _backward_plain(*ctx.saved_tensors[:2], dout,
                                             *ctx.saved_tensors[2:])
            else:
                dy, dw, db = _launch_backward(*ctx.saved_tensors[:2], dout,
                                              *ctx.saved_tensors[2:])
                bn_relu_pool2_train.backward_launches += 1
        return dy, dw, db, None, None


def _bn_relu_pool2_train_plain(y, weight, bias, eps):
    """Plain K7 under autograd: (pooled output, mean, biased variance) of
    ``maxpool2x2(bf16(relu(batch_norm(y))))``, the backward the plain
    kernels' arithmetic; any device and float type."""
    return _BnReluPool2Train.apply(y, weight, bias, eps, True)


def bn_relu_pool2_train(y: torch.Tensor, bn) -> torch.Tensor:
    """The training epilogue of a conv stage: ``bn`` (a ``BatchNorm2d`` in
    training mode) on the batch's statistics, ReLU, the cast to ``y``'s
    type and a 2x2 max-pool, differentiable; ``bn``'s running statistics
    are updated by ``bn.update_running_stats``.

    ``y``: (B, C, H, W), the conv's output.  On the card (bfloat16,
    channels-last, as :func:`engages` asks) K7 runs and counts its
    launches; elsewhere the plain version.  Returns (B, C, H/2, W/2) in
    ``y``'s type, channels-last on the card.
    """
    card = _kernel_device(y)
    if card:
        y = y.contiguous(memory_format=torch.channels_last)
    out, mean, var = _BnReluPool2Train.apply(y, bn.weight, bn.bias, bn.eps,
                                             not card)
    bn.update_running_stats(mean, var)
    return out


# forward calls that ran the kernels, and backward calls
bn_relu_pool2_train.launches = 0
bn_relu_pool2_train.backward_launches = 0


def kernel_resources(dev: "str | torch.device", c: int) -> dict:
    """What K7's four streaming kernels take on the card ``dev`` at ``c``
    channels: registers and local bytes per thread, shared memory, threads
    per block, resident blocks per SM and the blocks a launch takes."""
    lib = _build.load()
    keys = ("registers", "local_bytes", "shared_bytes", "threads",
            "blocks_per_sm", "blocks")
    found = {}
    with torch.cuda.device(dev):
        for i, name in enumerate(("stats", "apply", "reduce", "grad")):
            out = (ctypes.c_int * len(keys))()
            _build.check(lib.sir_bn_pool_info(i, c, ctypes.addressof(out)),
                         "bn_pool kernel_resources")
            found[name] = dict(zip(keys, out))
    return found
