"""Energy-based voice activity detection.

Counterpart of ``speech_intent_recognizer_tpu/infer/vad.py``, the detector
of the reference's live demo (``scripts/testing.py:38-47,63-112``):
mean-absolute-energy threshold (default 0.01), a pre-roll ring buffer
(0.5 s) prepended when speech starts, and end-of-utterance after a fixed
silence duration (1 s).  Host code over float32 chunks, so it works the
same on microphone streams and file replays.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

_native_energy = None


def _energy_impl():
    """Native mean-abs when libsirdsp is built (NumPy's abs + mean pair
    allocates twice per chunk, which shows at serving concurrency), else
    NumPy.  Resolved once."""
    global _native_energy
    if _native_energy is None:
        from speech_intent_recognizer_tpu_torch.data import native

        _native_energy = native.mean_abs if native.available() else False
    return _native_energy


def chunk_energy(chunk: np.ndarray) -> float:
    if chunk.size == 0:
        return 0.0
    fn = _energy_impl()
    if fn:
        return fn(chunk)
    return float(np.mean(np.abs(chunk)))


@dataclass
class EnergyVAD:
    threshold: float = 0.01

    def is_speech(self, chunk: np.ndarray) -> bool:
        return chunk_energy(chunk) > self.threshold


@dataclass
class VADSegmenter:
    """Stateful segmenter: feed chunks, get completed utterances back."""

    sample_rate: int = 16000
    chunk_size: int = 1024
    threshold: float = 0.01
    silence_limit: float = 1.0
    prior_recording: float = 0.5

    _vad: EnergyVAD = field(init=False)
    _prior: deque = field(init=False)
    _recording: bool = field(default=False, init=False)
    _chunks: List[np.ndarray] = field(default_factory=list, init=False)
    _silence_chunks: int = field(default=0, init=False)

    def __post_init__(self):
        self._vad = EnergyVAD(self.threshold)
        n_prior = max(1, int(self.prior_recording * self.sample_rate
                             / self.chunk_size))
        self._prior = deque(maxlen=n_prior)

    @property
    def recording(self) -> bool:
        return self._recording

    def feed(self, chunk: np.ndarray) -> Optional[np.ndarray]:
        """Feed one float32 chunk; returns a finished utterance or None."""
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        self._prior.append(chunk)
        speech = self._vad.is_speech(chunk)

        if not self._recording:
            if speech:
                self._recording = True
                self._chunks = list(self._prior)
                self._silence_chunks = 0
            return None

        self._chunks.append(chunk)
        self._silence_chunks = 0 if speech else self._silence_chunks + 1
        silence_seconds = (self._silence_chunks * self.chunk_size
                           / self.sample_rate)
        if silence_seconds >= self.silence_limit:
            utterance = np.concatenate(self._chunks)
            self._recording = False
            self._chunks = []
            self._silence_chunks = 0
            return utterance
        return None

    def flush(self) -> Optional[np.ndarray]:
        """Return any in-progress utterance (end of stream)."""
        if self._recording and self._chunks:
            utterance = np.concatenate(self._chunks)
            self._recording = False
            self._chunks = []
            return utterance
        return None
