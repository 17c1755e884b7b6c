"""Traffic generation from a seed.

The signals are those of the program's chip smoke test, copied here so
that the yardstick does not move with the program: ``speech_like`` is a
tone of amplitude 0.25 plus Gaussian noise of 0.05 (every 64 ms chunk of
it lies far above the voice detector's 0.01 mean-absolute threshold),
``room_noise`` Gaussian noise at -60 dBFS (far below it).  The smoke test
gives every row a 220 Hz tone; here each row or segment draws its tone's
pitch from ``TONE_HZ``, so that rows differ in what the model answers and
a row answered with another's answer shows.
The batch pool is made on the device by a ``torch.Generator`` there, in a
few large calls; lengths and schedules come from NumPy's generator.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TONE_HZ = (100.0, 1000.0)
TONE_AMP = 0.25
NOISE_AMP = 0.05
ROOM_NOISE = 0.001  # -60 dBFS


def seed_of(seed: int) -> int:
    """A seed of any size as a generator seed (non-negative, 63 bits)."""
    return int(seed) % (2 ** 63)


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The host generator of ``seed``; ``stream`` separates independent
    draws of one run."""
    return np.random.default_rng([seed_of(seed), stream])


def device_generator(seed: int, device, stream: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed * 1000003 + stream))
    return g


def speech_like(r: np.random.Generator, n: int, hz: float = 220.0
                ) -> np.ndarray:
    """``n`` samples of the ``hz`` tone plus noise (host NumPy)."""
    t = np.arange(n) / 16000.0
    return (TONE_AMP * np.sin(2 * np.pi * hz * t)
            + NOISE_AMP * r.standard_normal(n)).astype(np.float32)


def room_noise(r: np.random.Generator, n: int) -> np.ndarray:
    return (ROOM_NOISE * r.standard_normal(n)).astype(np.float32)


def uniform_lengths(r: np.random.Generator, n: int, lo_s: float,
                    hi_s: float, sample_rate: int) -> np.ndarray:
    """``n`` lengths in samples, uniform over [lo_s, hi_s] seconds."""
    lo, hi = int(round(lo_s * sample_rate)), int(round(hi_s * sample_rate))
    return r.integers(lo, hi + 1, size=n).astype(np.int64)


def speech_like_rows(lengths: torch.Tensor, hz: torch.Tensor, width: int,
                     g: torch.Generator, sample_rate: int = 16000
                     ) -> torch.Tensor:
    """(B, width) float32 rows of ``speech_like`` at the (B,) pitches
    ``hz``, zero past each length, made on ``lengths``' device by ``g``."""
    dev = lengths.device
    t = torch.arange(width, device=dev, dtype=torch.float64) / sample_rate
    tone = (TONE_AMP * torch.sin(2 * math.pi * hz.double()[:, None]
                                 * t[None, :])).float()
    rows = torch.randn((lengths.shape[0], width), generator=g, device=dev)
    rows.mul_(NOISE_AMP).add_(tone)
    keep = torch.arange(width, device=dev)[None, :] < lengths[:, None]
    return rows.mul_(keep)


def batch_pool(seed: int, batches: int, batch: int, width: int,
               lo_s: float, hi_s: float, device, sample_rate: int = 16000):
    """``batches`` batches of ``batch`` rows: a list of ((B, width) float32
    waveforms, (B,) int32 lengths) on ``device``, all made from ``seed``."""
    r = rng(seed, 1)
    g = device_generator(seed, device, 1)
    pool = []
    for _ in range(batches):
        ln = torch.from_numpy(uniform_lengths(r, batch, lo_s, hi_s,
                                              sample_rate)).to(device)
        ln = ln.clamp(max=width - 1)
        hz = torch.from_numpy(r.uniform(*TONE_HZ, batch)).to(device)
        wf = speech_like_rows(ln, hz, width, g, sample_rate)
        pool.append((wf, ln.to(torch.int32)))
    return pool
