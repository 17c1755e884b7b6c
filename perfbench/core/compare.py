"""Precisions the references can compute in, and the numbers compared.

A reference computes every convolution and matrix product on operands
passed through one of :data:`CASTS` and sums in float32:

* ``fp32``: unchanged (TF32 is off for the whole run);
* ``tf32``: each operand rounded to TF32's 10-bit mantissa, to nearest
  even, what a tensor core does with float32 inputs when TF32 is on;
* ``bf16``: each operand rounded to bfloat16;
* ``fp8``: each operand scaled by its largest magnitude to float8 e4m3's
  range (448), rounded to it and scaled back, as fp8 inference does with a
  scale per tensor; in training the gradients a product's backward takes
  go to e5m2 the same way (``GRAD_CASTS``).

The rounding is explicit, so a control computes the same on the CPU and
on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def _tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


def _fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


CASTS = {
    "fp32": lambda x: x.float(),
    "tf32": _tf32,
    "bf16": lambda x: x.bfloat16().float(),
    "fp8": _fp8,
}

# the gradients a product's backward takes in each precision: fp8
# training keeps them in e5m2 (its range), scaled by their largest value
GRAD_CASTS = dict(CASTS, fp8=lambda x: _fp8(x, torch.float8_e5m2))

# the nearest precision below each stated one: the control's
BELOW = {"fp32": "tf32", "bf16": "fp8"}


# the number compared for an answer of the wrong shape or not a number:
# above every limit, and still a number in the result's JSON
WRONG = 1e30


def logp_gap(probs, ref) -> float:
    """The widest gap between the natural logs of two sets of
    probabilities, over every row and class."""
    p = np.asarray(probs, np.float64)
    q = np.asarray(ref, np.float64)
    if p.shape != q.shape:
        return WRONG
    gap = np.max(np.abs(np.log(np.maximum(p, 1e-30))
                        - np.log(np.maximum(q, 1e-30))))
    return float(gap) if np.isfinite(gap) else WRONG


def leaf_gap(got: dict, ref: dict, leaves: list) -> float:
    """The worst leaf's | |got| - |ref| | over the larger of the
    reference's norm of that leaf and of the median leaf, over
    ``leaves``."""
    norms = {k: float(ref[k].float().norm()) for k in leaves}
    med = float(np.median(list(norms.values())))
    gap = max(abs(float(got[k].float().norm()) - norms[k])
              / max(norms[k], med) for k in leaves)
    return gap if np.isfinite(gap) else WRONG
