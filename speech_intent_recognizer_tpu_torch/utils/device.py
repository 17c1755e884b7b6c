"""CUDA device checks and the GPU label for measurements.

Replaces the reference's TPU probes (``infer/predict._default_gru_impl``,
``ops/frontend_jax.pallas_usable``): the port has one path per device and
no probe.  Code that must run on the card calls :func:`require_cuda`, which
raises rather than carrying on elsewhere.
"""

from __future__ import annotations

import subprocess

import torch

# the kernels in csrc/ are compiled for sm_90a only
REQUIRED_CAPABILITY = (9, 0)


def require_cuda() -> torch.device:
    """Return the current CUDA device, or raise unless it is a Hopper GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "an NVIDIA GPU is required, but torch.cuda.is_available() is "
            "False")
    dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if tuple(cap) != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap}; the kernels are built for sm_90a "
            f"{REQUIRED_CAPABILITY}")
    return dev


def gpu_label() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them.

    Written beside every time or rate, since a card set below its maximum
    power limit runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
