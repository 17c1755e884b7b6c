"""On-device SpecAugment (time / frequency masking).

Counterpart of ``speech_intent_recognizer_tpu/ops/specaugment.py`` with the
same gating and masking semantics (reference ``scripts/dataset.py:69-71,
160-176``; torchaudio's ``_apply_mask_along_axis``): per sample, with
probability ``augment_prob``, a time mask and a frequency mask each applied
with probability ``GATE_PROB`` (0.5); the mask width is drawn uniformly from
[0, param), the start uniformly from [0, size - width), masked bins are 0.
Batched on the features' device; every draw comes from the caller's
``torch.Generator`` (the streams cannot match JAX's), or from an
``ops.global_batch.ShardedGenerator``: the global batch's draws, this
process's rows.
"""

from __future__ import annotations

import torch

from speech_intent_recognizer_tpu_torch.ops.global_batch import rand_rows

GATE_PROB = 0.5  # each of the time and frequency masks, once augmented


def _axis_keep(width: torch.Tensor, start: torch.Tensor, size: int
               ) -> torch.Tensor:
    """(B,) widths and starts -> (B, size) 1 = keep, 0 = masked."""
    idx = torch.arange(size, device=width.device, dtype=torch.float32)
    return ((idx[None, :] < start[:, None])
            | (idx[None, :] >= (start + width)[:, None]))


def spec_augment(mels: torch.Tensor, generator,
                 augment_prob: float = 0.7, time_mask_param: int = 20,
                 freq_mask_param: int = 10) -> torch.Tensor:
    """Batched SpecAugment: (B, n_mels, T) -> (B, n_mels, T)."""
    b, n_mels, t = mels.shape
    u = rand_rows((7, b), generator, mels.device, dim=1)
    outer = u[0] < augment_prob
    tgate = outer & (u[1] < GATE_PROB)
    fgate = outer & (u[2] < GATE_PROB)
    t_width = u[3] * float(time_mask_param)
    t_start = u[4] * (float(t) - t_width).clamp(min=0.0)
    f_width = u[5] * float(freq_mask_param)
    f_start = u[6] * (float(n_mels) - f_width).clamp(min=0.0)
    tkeep = _axis_keep(t_width, t_start, t) | ~tgate[:, None]
    fkeep = _axis_keep(f_width, f_start, n_mels) | ~fgate[:, None]
    return (mels * tkeep[:, None, :].to(mels.dtype)
            * fkeep[:, :, None].to(mels.dtype))
