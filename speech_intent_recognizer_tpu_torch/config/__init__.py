from speech_intent_recognizer_tpu_torch.config.schema import (
    AudioConfig,
    ConfigError,
    audio_config_from_dict,
)
from speech_intent_recognizer_tpu_torch.config.loader import load_audio_config

__all__ = [
    "AudioConfig",
    "ConfigError",
    "audio_config_from_dict",
    "load_audio_config",
]
