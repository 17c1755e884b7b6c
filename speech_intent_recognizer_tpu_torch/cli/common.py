"""Shared CLI plumbing: logging, config/flag merging, model loading."""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional

from speech_intent_recognizer_tpu_torch.config.loader import (
    load_audio_config)
from speech_intent_recognizer_tpu_torch.config.schema import AudioConfig


def setup_logging(level=logging.INFO) -> logging.Logger:
    logging.basicConfig(
        level=level,
        format="%(asctime)s - %(levelname)s - %(message)s",
        handlers=[logging.StreamHandler(sys.stdout)],
        force=True,
    )
    return logging.getLogger("sir_torch")


def load_config_or_default(path: Optional[str]) -> AudioConfig:
    """The audio section of the config at ``path``, or the defaults."""
    if path and os.path.exists(path):
        return load_audio_config(path)
    if path:
        raise FileNotFoundError(f"config not found: {path}")
    return AudioConfig()


def add_config_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config", type=str, default=None,
                        help="path to YAML config (default: built-in "
                             "defaults)")


def make_predictor(model_path: str, label_map_path: str,
                   audio_cfg: AudioConfig, device: str = "cuda"):
    from speech_intent_recognizer_tpu_torch.infer.predict import Predictor

    return Predictor.from_checkpoint(model_path, label_map_path,
                                     audio_cfg=audio_cfg, device=device)
