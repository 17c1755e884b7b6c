"""On-device waveform augmentation and batch mixup.

Counterpart of ``speech_intent_recognizer_tpu/ops/augment.py``.  The
reference's waveform augmentations (``scripts/augment.py:6-135``, per
sample on the host through libsox) become batched tensor ops on the
waveforms' device, run inside the train step of waveform-resident training
(``data.use_waveform_augment``):

* time shift by up to +-10 % of the length, zero-filled;
* pitch shift by up to +-2 semitones: a linear-interpolation resample that
  keeps the buffer's length;
* speed change by U(0.85, 1.15): the same resample, and the true length
  scales by 1 / rate;
* additive Gaussian noise of level U(1e-3, 1e-2), below the true length.

Gating as in ``apply_augmentation`` (``augment.py:98-135``): under an outer
gate of probability ``augment_prob`` each sub-op fires with ``gate_prob``;
the order is shift, pitch, speed, noise.  Rates are quantized to k / 64
with k in 55..73 (``RATE_KS``), the JAX package's grid.

The JAX package resamples through a polyphase matmul bank over all 19
rates and shifts through one-hot matmuls, because per-row gathers were
slow on its TPU backend.  Here each row is gathered directly: the resample
reads positions i * k / 64 (exact in float32) and interpolates linearly,
zero beyond the stretched end (``cutoff = ((n - 1) * 64) // k + 1``), and
the shift is one gather.  The values equal the JAX batched path's for any
input: the resample reads zeros past the buffer where the JAX bank reads
its zero padding, and the shift moves the whole row without a length mask.

Every random number comes from the caller's ``torch.Generator`` in
:func:`draw_augment`; :func:`apply_augment` takes those draws explicitly,
so a test can feed it the draws the JAX function makes from its key.
:func:`time_shift` and :func:`_linear_resample` are the scalar goldens.

In a data-parallel step the generator is an
``ops.global_batch.ShardedGenerator``: each process draws the global
batch's numbers (the (B, L) noise too) and keeps its rows, and
:func:`mixup` takes its partners from every process's rows through the
process group it is given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from speech_intent_recognizer_tpu_torch.ops.global_batch import (
    base_generator, gather_rows, rand_rows, randn_rows, row_shard)

RATE_DEN = 64
RATE_KS = tuple(range(55, 74))


class AugmentDraws(NamedTuple):
    """The random numbers of one :func:`apply_augment` call, B rows of L
    samples; the JAX function's ``ks[0..9]`` draws, scaled as it scales
    them."""

    gates: torch.Tensor  # (4, B) U(0, 1): noise, shift, pitch, speed gates
    outer: torch.Tensor  # (B,) U(0, 1): the augment_prob gate
    shift_frac: torch.Tensor  # (B,) U(-shift_limit, shift_limit)
    semitones: torch.Tensor  # (B,) U(-pitch_semitones, pitch_semitones)
    speed: torch.Tensor  # (B,) U(speed_range)
    level: torch.Tensor  # (B,) U(noise_range)
    noise: torch.Tensor  # (B, L) N(0, 1)


def draw_augment(b: int, n: int, generator,
                 device: "str | torch.device", shift_limit: float = 0.1,
                 noise_range: tuple = (1e-3, 1e-2),
                 speed_range: tuple = (0.85, 1.15),
                 pitch_semitones: float = 2.0) -> AugmentDraws:
    """All draws for B rows of n samples from ``generator`` (on
    ``device``)."""
    u = rand_rows((9, b), generator, device, dim=1)

    def scaled(row, lo, hi):
        return u[row] * (hi - lo) + lo

    return AugmentDraws(
        gates=u[:4], outer=u[4],
        shift_frac=scaled(5, -shift_limit, shift_limit),
        semitones=scaled(6, -pitch_semitones, pitch_semitones),
        speed=scaled(7, *speed_range), level=scaled(8, *noise_range),
        noise=randn_rows((b, n), generator, device))


def _linear_resample(x: torch.Tensor, rate: float) -> torch.Tensor:
    """Scalar golden: sample the 1-D ``x`` at positions i * rate with
    linear interpolation (same length, zeros beyond the stretched end)."""
    n = x.shape[0]
    pos = torch.arange(n, dtype=torch.float32, device=x.device) * rate
    i0 = torch.floor(pos).long()
    frac = pos - i0.float()
    out = (x[i0.clamp(0, n - 1)] * (1.0 - frac)
           + x[(i0 + 1).clamp(0, n - 1)] * frac)
    return torch.where(pos <= n - 1, out, 0.0)


def time_shift(x: torch.Tensor, length: int, shift: int) -> torch.Tensor:
    """Scalar golden: shift the 1-D ``x`` by ``shift`` samples (positive =
    right), zero-filled, reading only below ``length``."""
    n = x.shape[0]
    idx = torch.arange(n, device=x.device) - shift
    valid = (idx >= 0) & (idx < length)
    return torch.where(valid, x[idx.clamp(0, n - 1)], 0.0)


def batched_time_shift(x: torch.Tensor, shifts: torch.Tensor
                       ) -> torch.Tensor:
    """Row i of (B, L) shifted right by ``shifts[i]`` samples (negative =
    left), zero-filled: one gather."""
    b, n = x.shape
    src = (torch.arange(n, device=x.device)[None, :]
           - shifts.long()[:, None])
    valid = (src >= 0) & (src < n)
    return torch.where(valid, x.gather(1, src.clamp_(0, n - 1)), 0.0)


def batched_resample(x: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Row i of (B, L) resampled at rate ``ks[i] / 64``: out[j] =
    interpolation of x at j * k / 64, zero at positions past L - 1.

    Two gathers of one int64 index tensor, advanced in place; the
    positions are exact in float32 (j * k < 2**23 for L up to 114,000)."""
    b, n = x.shape
    ks = ks.to(torch.int64)
    pos = (torch.arange(n, dtype=torch.float32, device=x.device)[None, :]
           * (ks.float() / RATE_DEN)[:, None])
    idx = pos.floor().long()
    frac = pos.sub_(idx)  # pos now holds the fractional part
    keep = (torch.arange(n, device=x.device)[None, :]
            < (((n - 1) * RATE_DEN) // ks + 1)[:, None])
    out = x.gather(1, idx.clamp_(max=n - 1)).mul_(1.0 - frac)
    out.add_(x.gather(1, idx.add_(1).clamp_(max=n - 1)).mul_(frac))
    return torch.where(keep, out, 0.0)


def _rate_k(rate: torch.Tensor) -> torch.Tensor:
    """Nearest k / 64 grid rate, clipped to RATE_KS."""
    return torch.round(rate * RATE_DEN).to(torch.int32).clamp_(
        RATE_KS[0], RATE_KS[-1])


def apply_augment(waves: torch.Tensor, lengths: torch.Tensor,
                  draws: AugmentDraws, augment_prob: float = 0.7,
                  gate_prob: float = 0.5) -> tuple:
    """(B, L) float waveforms and (B,) int32 lengths -> augmented waveforms
    and the lengths after the speed change, with the given draws.

    The JAX batched path's semantics: each sub-op is computed for every
    row and kept where its gate fires; the noise lands below the updated
    lengths only."""
    b, n = waves.shape
    outer = draws.outer < augment_prob

    def gate(i):
        return (outer & (draws.gates[i] < gate_prob))[:, None]

    x = waves
    shift = (draws.shift_frac * lengths.float()).to(torch.int32)
    x = torch.where(gate(1), batched_time_shift(x, shift), x)

    pitch_k = _rate_k(torch.exp2(draws.semitones / 12.0))
    x = torch.where(gate(2), batched_resample(x, pitch_k), x)

    speed_k = _rate_k(draws.speed)
    do_speed = gate(3)
    x = torch.where(do_speed, batched_resample(x, speed_k), x)
    new_len = (lengths.float() * RATE_DEN / speed_k.float()).to(
        torch.int32).clamp_(max=n)
    lengths = torch.where(do_speed[:, 0], new_len, lengths)

    below = (torch.arange(n, device=x.device)[None, :]
             < lengths[:, None]).to(x.dtype)
    noisy = x + draws.noise * draws.level[:, None] * below
    return torch.where(gate(0), noisy, x), lengths


def augment_waveforms(waves: torch.Tensor, lengths: torch.Tensor,
                      generator, augment_prob: float = 0.7,
                      shift_limit: float = 0.1,
                      noise_range: tuple = (1e-3, 1e-2),
                      speed_range: tuple = (0.85, 1.15),
                      pitch_semitones: float = 2.0,
                      gate_prob: float = 0.5) -> tuple:
    """Batched waveform augmentation: (B, L), (B,) -> augmented (B, L),
    (B,) int32 lengths; every draw from ``generator``."""
    b, n = waves.shape
    draws = draw_augment(b, n, generator, waves.device, shift_limit,
                         noise_range, speed_range, pitch_semitones)
    return apply_augment(waves, lengths, draws, augment_prob, gate_prob)


def _beta_symmetric(n: int, alpha: float, generator: torch.Generator,
                    device) -> torch.Tensor:
    """n draws of Beta(alpha, alpha) by Johnk's method: with U, V uniform on
    (0, 1], X = U^(1/alpha), Y = V^(1/alpha), accept X / (X + Y) when
    X + Y <= 1 (in logs, so small alpha does not underflow)."""
    out = torch.zeros(n, device=device)
    todo = torch.ones(n, dtype=torch.bool, device=device)
    while bool(todo.any()):
        u = 1.0 - torch.rand((2, n), generator=generator, device=device)
        lx = torch.log(u[0]) / alpha
        ly = torch.log(u[1]) / alpha
        ls = torch.logaddexp(lx, ly)
        accept = todo & (ls <= 0.0)
        out = torch.where(accept, torch.exp(lx - ls), out)
        todo = todo & ~accept
    return out


def mixup(mels: torch.Tensor, labels_onehot: torch.Tensor,
          generator, alpha: float = 0.2, group=None):
    """(B, n_mels, T) features and (B, C) one-hot labels -> mixed pair:
    each sample mixes with a random partner by a Beta(alpha, alpha) weight
    lambda, kept >= 0.5 so the dominant sample comes first.

    With a ``ShardedGenerator`` the weights and the permutation are the
    global batch's, and the partners come from every process's rows,
    gathered over ``group`` (required then)."""
    rank, world = row_shard(generator)
    gen = base_generator(generator)
    n = mels.shape[0]
    lam = _beta_symmetric(n * world, alpha, gen, mels.device)
    lam = torch.maximum(lam, 1.0 - lam)
    perm = torch.randperm(n * world, generator=gen, device=mels.device)
    mine = slice(rank * n, (rank + 1) * n)  # this process's rows
    lam, perm = lam[mine], perm[mine]
    mels_all = gather_rows(mels, generator, group)
    labels_all = gather_rows(labels_onehot, generator, group)
    lam_m = lam[:, None, None].to(mels.dtype)
    mixed = lam_m * mels + (1.0 - lam_m) * mels_all[perm]
    lam_l = lam[:, None].to(labels_onehot.dtype)
    mixed_labels = lam_l * labels_onehot + (1.0 - lam_l) * labels_all[perm]
    return mixed, mixed_labels
