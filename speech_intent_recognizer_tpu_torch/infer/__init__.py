"""Inference: batch waveforms to intent probabilities, streaming sessions
with voice activity detection, and the multi-session server."""

from speech_intent_recognizer_tpu_torch.infer.predict import Predictor
from speech_intent_recognizer_tpu_torch.infer.streaming import (
    BatchFinalizer, PendingResult, StreamingFeaturizer, StreamingRecognizer)
from speech_intent_recognizer_tpu_torch.infer.vad import (
    EnergyVAD, VADSegmenter)

__all__ = [
    "BatchFinalizer",
    "EnergyVAD",
    "PendingResult",
    "Predictor",
    "StreamingFeaturizer",
    "StreamingRecognizer",
    "VADSegmenter",
]
