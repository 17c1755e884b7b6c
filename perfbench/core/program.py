"""The program under test, built through its public entries from the
benchmark's own weights.

* ``cnn_gru``: the training-form state dict written to a checkpoint file
  under ``TMPDIR`` and loaded by ``Predictor.from_checkpoint``, which folds
  BatchNorm and serves K1 -> conv2 / conv3 -> K2 in bf16; its ``model`` is
  the fp32 folded model that streaming serves;
* ``wav2vec2``: ``Wav2VecIntent`` built on the device (torch's default
  initialisation runs there, not on the host), the state loaded into it,
  served by ``Wav2VecPredictor`` in its default float32.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch


def label_map(n: int) -> dict:
    return {f"intent_{i:02d}": i for i in range(n)}


def _cnn_gru(cfg: dict, state: dict, device):
    from speech_intent_recognizer_tpu_torch.config import AudioConfig
    from speech_intent_recognizer_tpu_torch.infer.predict import Predictor

    audio = AudioConfig(sample_rate=cfg["sample_rate"], n_fft=cfg["n_fft"],
                        hop_length=cfg["hop_length"], n_mels=cfg["n_mels"],
                        mel_spec_length=cfg["mel_spec_length"],
                        max_duration=cfg["max_duration"],
                        frontend=cfg["frontend"])
    with tempfile.TemporaryDirectory(prefix="perfbench_") as d:
        model = os.path.join(d, "model.pt")
        labels = os.path.join(d, "labels.json")
        torch.save({k: v.cpu() for k, v in state.items()}, model)
        with open(labels, "w") as f:
            json.dump(label_map(cfg["num_classes"]), f)
        return Predictor.from_checkpoint(model, labels, audio, device=device)


def _wav2vec2(cfg: dict, state: dict, device):
    from speech_intent_recognizer_tpu_torch.config import AudioConfig
    from speech_intent_recognizer_tpu_torch.infer.predict import (
        Wav2VecPredictor)
    from speech_intent_recognizer_tpu_torch.models.wav2vec import (
        Wav2Vec2Config, Wav2VecIntent)

    with torch.device(device):  # torch's default init on the card
        model = Wav2VecIntent(Wav2Vec2Config.from_dict(cfg),
                              cfg["num_classes"])
    model.load_state_dict(state)
    audio = AudioConfig(sample_rate=cfg["sample_rate"],
                        max_duration=cfg["max_duration"])
    return Wav2VecPredictor(model, label_map(cfg["num_classes"]), audio,
                            device=device)


BUILD = {"cnn_gru": _cnn_gru, "wav2vec2": _wav2vec2}
