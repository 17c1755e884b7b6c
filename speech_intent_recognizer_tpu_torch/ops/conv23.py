"""K5, conv2 + conv3 of the conv stack in one kernel — wrapper, plain
version, operands, plan, counter.

Replaces ``speech_intent_recognizer_tpu/ops/conv23_pallas.py``
(``_conv23_kernel``, wrapper ``conv23_pallas``, operands
``conv23_operands``).  CUDA source ``csrc/conv23.cu``: persistent blocks
with both weight sets resident in shared memory walk (utterance, range of
output rows) work items in time order; one warpgroup makes pooled conv2
rows, the other conv3's output rows, both as nine tap products on
``wgmma``; its header says what bounds it on the H100.
:func:`conv23_plan` picks the range length.  The kernel is the op
``sir::conv23`` (``ops/library.py``): the wrapper calls it for CUDA
tensors, and its ``CUDA`` implementation (:func:`_conv23_cuda`) plans on
the card it runs on, launches and counts.

Rounding points, the same in the kernel and the plain version: operands
bf16, sums fp32, bias added in fp32, ReLU, 2x2 max-pool, stage 1's pooled
output rounded to bf16 before conv3, bf16 out.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from speech_intent_recognizer_tpu_torch import _build
from speech_intent_recognizer_tpu_torch.ops import library

# geometry compiled into csrc/conv23.cu
M1, C1, C2, C3 = 32, 32, 64, 128
# the packed weights: [tap][k16 slice][8-column group][k half][8 output
# channels][8 input channels], the no-swizzle K-major core-matrix layout
# of the kernel's wgmma B operand
W2_SHAPE = (9, C1 // 16, C2 // 8, 2, 8, 8)
W3_SHAPE = (9, C2 // 16, C3 // 8, 2, 8, 8)
# fixed cost of a work item in the plan, in pooled conv2 rows
ITEM_OVERHEAD = 2


class Conv23Plan(NamedTuple):
    """A launch: ``rows`` output rows per work item, ``grid`` persistent
    blocks walking the items round-robin."""
    rows: int
    grid: int


def _range_cost(batch: int, t3: int, rows: int, sm_count: int) -> int:
    chunks = -(-t3 // rows)
    items = batch * chunks
    per_block = -(-items // min(items, sm_count))
    steps = -(-min(rows, t3) // 2)
    return per_block * (4 * steps + 2 + ITEM_OVERHEAD)


def range_lengths(t1: int) -> list:
    """The range lengths :func:`conv23_plan` chooses among for T1 input
    rows: whole utterances and every even length below T1 / 4."""
    t3 = t1 // 4
    return sorted({max(t3, 1)} | set(range(2, t3, 2)))


def conv23_plan(batch: int, t1: int, sm_count: int) -> Conv23Plan:
    """How a CUDA call of :func:`conv23` cuts the batch into work items.

    A work item is a range of ``rows`` output rows of one utterance; a
    block makes ``4 ceil(rows / 2) + 2`` pooled conv2 rows for it (two
    warm-up rows) and walks its items in turn.  The candidates are whole
    utterances and every even range length below T1 / 4; the one whose
    busiest block has the least work wins (``ceil(items / grid)`` items of
    ``4 steps + 2 + ITEM_OVERHEAD`` pooled rows), the longer on a tie.
    Whole utterances win where the batch covers the SMs several times
    (B=2048: 15.5 an SM); near or under the SM count shorter ranges keep
    every SM busy.
    """
    t3 = t1 // 4
    if batch <= 0 or t3 <= 0:
        return Conv23Plan(max(t3, 1), 0)
    sm_count = max(int(sm_count), 1)
    rows = min(range_lengths(t1),
               key=lambda r: (_range_cost(batch, t3, r, sm_count), -r))
    return Conv23Plan(rows, min(batch * -(-t3 // rows), sm_count))


def _pack(w: torch.Tensor) -> torch.Tensor:
    """(O, I, km, kt) reference-layout kernel -> (9, I/16, O/8, 2, 8, 8)
    bf16: element [tap = kt * 3 + km][kk][j][h][r][e] is
    w[8 j + r, 16 kk + 8 h + e, km, kt]."""
    o, i = w.shape[:2]
    taps = w.detach().float().permute(3, 2, 1, 0).reshape(9, i, o)
    return (taps.reshape(9, i // 16, 2, 8, o // 8, 8)
            .permute(0, 1, 4, 2, 5, 3).contiguous().to(torch.bfloat16))


def _unpack(wp: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack`: -> (O, I, km, kt) float32."""
    _, kks, js = wp.shape[:3]
    i, o = 16 * kks, 8 * js
    taps = wp.float().permute(0, 1, 3, 5, 2, 4).reshape(9, i, o)
    return taps.reshape(3, 3, i, o).permute(3, 2, 1, 0)


def engages(channels) -> bool:
    """Whether K5 serves the 3x3 conv2 and conv3 of a model whose conv
    stages have these output channels: (32, 64, 128)."""
    return tuple(channels) == (C1, C2, C3)


def conv23_operands(conv2_weight: torch.Tensor, conv2_bias: torch.Tensor,
                    conv3_weight: torch.Tensor, conv3_bias: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """The kernel's operands from the BN-folded conv2 / conv3 stages.

    Takes the *original-orientation* reference-layout tensors (kernel dims
    (mel, time)): ``conv2.weight`` (64, 32, 3, 3), ``conv3.weight``
    (128, 64, 3, 3) and their biases.  Returns ``(w2, b2, w3, b3)`` on the
    weights' device: w2 ``W2_SHAPE`` and w3 ``W3_SHAPE`` bf16 in the
    kernel's B layout (:func:`_pack`); b2 (64,), b3 (128,) float32.
    """
    c2, c1 = conv2_weight.shape[:2]
    c3 = conv3_weight.shape[0]
    if not engages((c1, c2, c3)) or [tuple(t.shape) for t in (
            conv2_weight, conv2_bias, conv3_weight, conv3_bias)] != [
                (c2, c1, 3, 3), (c2,), (c3, c2, 3, 3), (c3,)]:
        raise ValueError("conv23 kernel requires channels (32, 64, 128)")
    return (_pack(conv2_weight),
            conv2_bias.detach().float().contiguous(),
            _pack(conv3_weight),
            conv3_bias.detach().float().contiguous())


def _check(x, w2, b2, w3, b3) -> None:
    if x.dim() != 3 or x.shape[2] != M1 * C1 or x.shape[1] % 4:
        raise ValueError("conv23 kernel requires (B, 4k, 1024) input")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"conv23 takes bfloat16 activations, got {x.dtype}")
    want = ((W2_SHAPE, torch.bfloat16), ((C2,), torch.float32),
            (W3_SHAPE, torch.bfloat16), ((C3,), torch.float32))
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
    y = _stage(y, _unpack(w2), b2)
    y = _stage(y, _unpack(w3), b3)
    # (B, C3, M3, T3) -> (B, T3, M3*C3), lane = m * 128 + c
    return y.permute(0, 3, 2, 1).reshape(b, t1 // 4, -1).to(torch.bfloat16)


def conv23(x: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
           w3: torch.Tensor, b3: torch.Tensor,
           rows: "int | None" = None) -> torch.Tensor:
    """conv2 + pool + conv3 + pool on K1's output.

    Args:
      x: (B, T1, 1024) bf16 pooled conv1 activations, lane = m * 32 + c
        (``log_mel_conv1_frontend``'s layout), T1 a multiple of 4 (100 at
        the reference geometry).
      w2, b2, w3, b3: from :func:`conv23_operands`.
      rows: None launches what :func:`conv23_plan` picks for the card; an
        int forces that many output rows per work item (checks, timing).
        Ignored on the CPU.

    Returns (B, T1 / 4, 1024) bf16, lane = m * 128 + c with m in 0..7, the
    sheet ``CNNAudioGRU(conv23=True)`` flattens for its GRU.  CPU tensors
    take the
    plain version; CUDA tensors launch the kernel or raise.
    """
    _check(x, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return _conv23_plain(x, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("conv23 takes contiguous 16-byte aligned tensors")
    if rows is not None and rows < 1:
        raise ValueError(f"rows must be positive, got {rows}")
    return torch.ops.sir.conv23(x, w2, b2, w3, b3, rows or 0)


def _conv23_cuda(x, w2, b2, w3, b3, rows):
    if x.data_ptr() % 16 or w2.data_ptr() % 16 or w3.data_ptr() % 16:
        raise ValueError("conv23 takes contiguous 16-byte aligned tensors")
    b, t1, _ = x.shape
    out = torch.empty((b, t1 // 4, (M1 // 4) * C3), dtype=torch.bfloat16,
                      device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = conv23_plan(b, t1, sms) if rows == 0 else Conv23Plan(rows, sms)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.sir_conv23(x.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                            w3.data_ptr(), b3.data_ptr(), out.data_ptr(), b,
                            t1, plan.rows, max(plan.grid, 1),
                            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "conv23")
    conv23.launches += 1
    return out


def _conv23_cpu(x, w2, b2, w3, b3, rows):
    return _conv23_plain(x, w2, b2, w3, b3)


library.implement("conv23", _conv23_cuda, _conv23_cpu)
conv23.launches = 0


def kernel_resources(dev: "str | torch.device") -> dict:
    """What the built K5 takes on the card ``dev``: registers per thread,
    local (spilled) bytes per thread, shared memory per block, threads per
    block, resident blocks per SM.  Launches nothing."""
    lib = _build.load()
    keys = ("registers", "local_bytes", "shared_bytes", "threads",
            "blocks_per_sm")
    out = (ctypes.c_int * len(keys))()
    with torch.cuda.device(dev):
        _build.check(lib.sir_conv23_info(ctypes.addressof(out)),
                     "kernel_resources")
    return {"conv23": dict(zip(keys, out))}
