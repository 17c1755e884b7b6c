"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates without
sparsity, at its full 700 W power limit (NVIDIA's data sheet)."""

from __future__ import annotations

# operations per second by the precision of the operands
FLOPS = {
    "fp8": 1979e12,
    "bf16": 989e12,
    "tf32": 495e12,
    "fp32": 67e12,  # outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: dict, nbytes: float) -> float:
    """The least time the chip could take for ``flops`` (operations by
    precision, summed at each precision's peak) and ``nbytes`` moved to or
    from HBM: the larger of the two."""
    compute = sum(n / FLOPS[p] for p, n in flops.items())
    return max(compute, nbytes / HBM_BYTES_PER_S)


def compute_seconds(flops: dict) -> float:
    """The least time of ``flops`` alone, at each precision's peak."""
    return sum(n / FLOPS[p] for p, n in flops.items())
