"""CLI: TTS-holdout evaluation with plots.

Mirrors the JAX package's ``cli/test_tts_samples.py`` (the reference's
``python -m scripts.test_tts_samples``): ``--config --model --label_map
--audio_dir --details_csv --report_dir``, plus ``--device`` (default
``cuda``).  Evaluates a directory of synthetic utterances against its
``details.csv`` and writes detailed_results.csv / classification_report.csv
and, where matplotlib is installed, the plot PNGs::

    python -m speech_intent_recognizer_tpu_torch.cli.test_tts_samples \\
        --model best_model.pt --label_map label_map.json \\
        --audio_dir tts_samples
"""

from __future__ import annotations

import argparse

from speech_intent_recognizer_tpu_torch.cli.common import (
    add_config_arg, add_device_arg, load_config_or_default, make_predictor,
    setup_logging)
from speech_intent_recognizer_tpu_torch.evaluation.tts_holdout import (
    evaluate_tts_directory)


def main(argv=None):
    logger = setup_logging()
    p = argparse.ArgumentParser(description="Evaluate on TTS holdout corpus")
    add_config_arg(p, default=None)
    p.add_argument("--model", default="checkpoints/best_model.msgpack")
    p.add_argument("--label_map", default="data/processed/label_map.json")
    p.add_argument("--audio_dir", required=True)
    p.add_argument("--details_csv", default=None)
    p.add_argument("--report_dir", default="checkpoints/tts_test_results")
    add_device_arg(p)
    args = p.parse_args(argv)

    cfg = load_config_or_default(args.config)
    predictor = make_predictor(args.model, args.label_map, cfg.audio,
                               device=args.device)
    result = evaluate_tts_directory(predictor, args.audio_dir,
                                    args.details_csv, args.report_dir)
    logger.info("TTS holdout accuracy: %.4f", result["accuracy"])
    return result


if __name__ == "__main__":
    main()
