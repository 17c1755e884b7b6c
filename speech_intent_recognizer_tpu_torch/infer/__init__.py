"""Inference: batch waveforms to intent probabilities, streaming sessions
with voice activity detection, the multi-session server, and serving
artifacts.

The names below are imported from their modules at first use, so that
importing one module of this package (``infer.export`` to serve an
artifact) imports nothing else of it."""

import importlib

_HOMES = {
    "BatchFinalizer": "streaming",
    "EnergyVAD": "vad",
    "PendingResult": "streaming",
    "Predictor": "predict",
    "ServingModel": "export",
    "StreamingArtifactPredictor": "export",
    "StreamingFeaturizer": "streaming",
    "StreamingRecognizer": "streaming",
    "VADSegmenter": "vad",
    "Wav2VecPredictor": "predict",
}

__all__ = sorted(_HOMES)


def __getattr__(name: str):
    if name not in _HOMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_HOMES[name]}"),
                   name)
