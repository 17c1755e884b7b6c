"""Batch mixup.

Counterpart of ``mixup`` in ``speech_intent_recognizer_tpu/ops/augment.py``
(the waveform-domain augmentations there wait for waveform-resident
training): each sample mixes with a random partner by a Beta(alpha, alpha)
weight lambda, kept >= 0.5 so the dominant sample comes first.  Every draw
comes from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import torch


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
          generator: torch.Generator, alpha: float = 0.2):
    """(B, n_mels, T) features and (B, C) one-hot labels -> mixed pair."""
    b = mels.shape[0]
    lam = _beta_symmetric(b, alpha, generator, mels.device)
    lam = torch.maximum(lam, 1.0 - lam)
    perm = torch.randperm(b, generator=generator, device=mels.device)
    lam_m = lam[:, None, None].to(mels.dtype)
    mixed = lam_m * mels + (1.0 - lam_m) * mels[perm]
    lam_l = lam[:, None].to(labels_onehot.dtype)
    mixed_labels = lam_l * labels_onehot + (1.0 - lam_l) * labels_onehot[perm]
    return mixed, mixed_labels
