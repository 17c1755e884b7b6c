"""Synthetic utterances from a sentence sheet (the TTS holdout corpus)."""

from speech_intent_recognizer_tpu_torch.tts.generate import (
    generate_audio_files,
    sanitize_filename,
    synthesize_text,
)

__all__ = ["generate_audio_files", "sanitize_filename", "synthesize_text"]
