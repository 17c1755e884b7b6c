"""Shared CLI plumbing: logging, config/flag merging, model loading."""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional

from speech_intent_recognizer_tpu_torch.config import (
    AudioConfig, Config, load_config)


def setup_logging(level=logging.INFO) -> logging.Logger:
    logging.basicConfig(
        level=level,
        format="%(asctime)s - %(levelname)s - %(message)s",
        handlers=[logging.StreamHandler(sys.stdout)],
        force=True,
    )
    return logging.getLogger("sir_torch")


def load_config_or_default(path: Optional[str]) -> Config:
    """The config at ``path``, or the defaults."""
    if path and os.path.exists(path):
        return load_config(path)
    if path:
        raise FileNotFoundError(f"config not found: {path}")
    return Config.from_dict({})


def add_config_arg(parser: argparse.ArgumentParser,
                   default: Optional[str] = None) -> None:
    parser.add_argument("--config", type=str, default=default,
                        help="path to YAML config (default: "
                             f"{default or 'built-in defaults'})")


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda runs the kernels, cpu their "
                             "plain versions")


def add_model_type_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--model_type", default="cnn_gru",
                        choices=["cnn_gru", "wav2vec"],
                        help="cnn_gru: the log-mel CNN + GRU model; wav2vec: "
                             "the raw-waveform Wav2VecIntent")


def make_predictor(model_path: str, label_map_path: str,
                   audio_cfg: AudioConfig, device: str = "cuda",
                   model_type: str = "cnn_gru"):
    """The predictor of ``model_type`` for a checkpoint."""
    from speech_intent_recognizer_tpu_torch.infer.predict import (
        Predictor, Wav2VecPredictor)

    if model_type == "wav2vec":
        return Wav2VecPredictor.from_checkpoint(
            model_path, label_map_path, audio_cfg=audio_cfg, device=device)
    return Predictor.from_checkpoint(model_path, label_map_path,
                                     audio_cfg=audio_cfg, device=device)
