"""Raw-waveform batching and train-time noise for the wav2vec path.

Counterpart of ``speech_intent_recognizer_tpu/data/wav2vec_data.py``
(the reference's bytecode-only wav2vec dataset: mono 16 kHz waveforms,
Gaussian noise in training, padded batches with attention masks).  Batches
are padded to a fixed ``max_length``, so every step has one shape.

The noise is split into a draw (:func:`draw_train_noise`, from an explicit
generator) and its application (:func:`apply_train_noise`), so the JAX
package's own draws can be fed to the same arithmetic.
"""

from __future__ import annotations

import logging
from typing import Sequence, Tuple

import numpy as np
import torch

from speech_intent_recognizer_tpu_torch.data.audio_io import load_audio
from speech_intent_recognizer_tpu_torch.ops.global_batch import (
    rand_rows, randn_rows)

logger = logging.getLogger(__name__)


def load_waveform(path: str, sample_rate: int = 16000,
                  max_length: int = 80000) -> np.ndarray:
    x, _ = load_audio(path, target_sample_rate=sample_rate)
    return x[:max_length]


def batch_waveforms(
    paths: Sequence[str],
    sample_rate: int = 16000,
    max_length: int = 80000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (waveforms (B, max_length) f32, attention_mask (B, max_length)
    i32, ok (B,) bool).  A failed decode becomes a zero row with a 1-sample
    mask and ``ok`` false."""
    b = len(paths)
    buf = np.zeros((b, max_length), np.float32)
    mask = np.zeros((b, max_length), np.int32)
    ok = np.ones(b, bool)
    for i, p in enumerate(paths):
        try:
            x = load_waveform(p, sample_rate, max_length)
        except Exception as e:  # unreadable or undecodable, as the reference
            logger.error("error loading %s: %s", p, e)
            mask[i, 0] = 1
            ok[i] = False
            continue
        buf[i, :len(x)] = x
        mask[i, :max(len(x), 1)] = 1
    return buf, mask, ok


def draw_train_noise(shape: Tuple[int, int], device, generator=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The noise's random draws for a (B, L) batch: gate uniforms (B, 1) and
    standard normals (B, L); with an ``ops.global_batch.ShardedGenerator``,
    this process's rows of the global batch's draws."""
    gate_u = rand_rows((shape[0], 1), generator, device)
    normals = randn_rows(shape, generator, device)
    return gate_u, normals


def apply_train_noise(waveforms: torch.Tensor, mask: torch.Tensor,
                      gate_u: torch.Tensor, normals: torch.Tensor,
                      prob: float = 0.8, level: float = 1e-3
                      ) -> torch.Tensor:
    """``x + gate * noise * mask`` with ``gate = u < prob`` and ``noise =
    normals * level`` (the reference dataset's train-time noise)."""
    gate = (gate_u < prob).to(waveforms.dtype)
    noise = normals * level
    return waveforms + gate * noise * mask.to(waveforms.dtype)
