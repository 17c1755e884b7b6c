"""The audio section of the configuration schema.

Copy of ``AudioConfig`` and ``ConfigError`` from
``speech_intent_recognizer_tpu/config/schema.py`` (the port imports nothing
of the JAX package), with the one reader the slice needs:
:func:`audio_config_from_dict` takes a config in either of that schema's
forms (the reference's flat keys or nested sections) and builds its audio
section.  The other sections (data, model, train, parallel) drive training
and the mesh, which the port does not run yet; their keys are passed over
unread.  ``tests/test_torch_host.py`` pins this module and the loader to
the originals on every config in ``configs/``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional


class ConfigError(ValueError):
    """Raised when a config fails validation."""


@dataclass
class AudioConfig:
    """Feature front-end parameters.

    Defaults mirror the reference contract at
    ``scripts/precompute_features.py:21-36`` (16 kHz, n_fft 1024, hop 512,
    64 mels) and ``configs/config.yaml:43-45`` (200-frame pad/trim).
    """

    sample_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 512
    win_length: Optional[int] = None  # defaults to n_fft
    n_mels: int = 64
    f_min: float = 0.0
    f_max: Optional[float] = None  # defaults to sample_rate / 2
    mel_spec_length: int = 200
    max_duration: float = 5.0  # seconds; reference caps at 5 s (:59-61)
    # "torchaudio": HTK mel, unit ref dB, per-utterance norm (training path)
    # "librosa": Slaney mel, ref=max dB, top_db 80, global norm (mic path,
    #            reference scripts/testing.py:193-217 — kept for parity tests)
    frontend: str = "torchaudio"
    # dB conversion / normalization details of the torchaudio path
    norm_eps: float = 1e-5

    def __post_init__(self) -> None:
        if self.win_length is None:
            self.win_length = self.n_fft
        if self.f_max is None:
            self.f_max = self.sample_rate / 2.0
        if self.frontend not in ("torchaudio", "librosa"):
            raise ConfigError(f"unknown frontend {self.frontend!r}")
        if self.n_fft < self.win_length:
            raise ConfigError("n_fft must be >= win_length")
        if self.hop_length <= 0 or self.n_fft <= 0 or self.n_mels <= 0:
            raise ConfigError("audio params must be positive")

    @property
    def max_samples(self) -> int:
        return int(self.max_duration * self.sample_rate)

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


# flat reference YAML keys of the audio section -> AudioConfig field
_FLAT_AUDIO_KEYS = ("sample_rate", "n_mels", "n_fft", "hop_length",
                    "mel_spec_length", "max_duration", "frontend")


def audio_config_from_dict(raw: Optional[dict]) -> AudioConfig:
    """Build the audio section from a flat reference-style dict or a
    nested one, validated and coerced as the full schema does."""
    section: dict[str, Any] = {}
    for key, value in (raw or {}).items():
        if key == "audio" and isinstance(value, dict):
            section.update(value)
        elif key in _FLAT_AUDIO_KEYS:
            section[key] = value
    return _build(AudioConfig, section)


def _build(cls, kwargs: dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    bad = set(kwargs) - fields
    if bad:
        raise ConfigError(f"unknown keys for {cls.__name__}: {sorted(bad)}")
    coerced = {}
    for f in dataclasses.fields(cls):
        if f.name not in kwargs:
            continue
        v = kwargs[f.name]
        # YAML writes "5e-05" as str sometimes; coerce numerics like the
        # reference does with float(config.get('lr')) (train.py:243).
        if f.type in ("int", int) and v is not None:
            v = int(v)
        elif f.type in ("float", float) and v is not None:
            v = float(v)
        coerced[f.name] = v
    return cls(**coerced)
