"""Configuration: the JAX package's schema and reader, used as they are.

``speech_intent_recognizer_tpu.config`` is pure dataclasses plus a YAML
reader with its own mini-YAML fallback; importing it imports no JAX (the
JAX package's ``__init__`` imports only its version).  So the port reads
the same configs with the same validation and keeps no copy.
"""

from speech_intent_recognizer_tpu.config.loader import load_config
from speech_intent_recognizer_tpu.config.schema import (
    AudioConfig,
    Config,
    ConfigError,
)


def load_audio_config(path: str) -> AudioConfig:
    """The audio section of the config file at ``path``."""
    return load_config(path).audio


__all__ = [
    "AudioConfig",
    "Config",
    "ConfigError",
    "load_audio_config",
    "load_config",
]
