"""Configuration: the port's own schema and reader.

``schema.py`` and ``loader.py`` are copies of the JAX package's
``config/schema.py`` and ``config/loader.py`` (typed, validated sections,
the reference's flat key names, a YAML reader with a mini-YAML fallback):
the port imports nothing of that package and reads the same config files.
"""

from speech_intent_recognizer_tpu_torch.config.loader import load_config
from speech_intent_recognizer_tpu_torch.config.schema import (
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
