"""CLI: synthetic sample generation.

Mirrors the JAX package's ``cli/generate_tts_samples.py`` (reference
``scripts/generate_tts_samples.py:72-89``): ``--csv --output_dir --accent
--slow --engine``, with the hermetic ``synthetic`` engine as the last
fallback (:mod:`speech_intent_recognizer_tpu_torch.tts.generate`).  Runs
on the host; no device is involved::

    python -m speech_intent_recognizer_tpu_torch.cli.generate_tts_samples \\
        --csv configs/custom_intents_sentences.csv --output_dir tts_samples \\
        --engine synthetic
"""

from __future__ import annotations

import argparse

from speech_intent_recognizer_tpu_torch.cli.common import setup_logging
from speech_intent_recognizer_tpu_torch.tts.generate import (
    generate_audio_files)


def main(argv=None):
    logger = setup_logging()
    p = argparse.ArgumentParser(description="Generate synthetic TTS samples")
    p.add_argument("--csv", required=True,
                   help="sentence sheet (transcription/action/object/label)")
    p.add_argument("--output_dir", default="tts_samples")
    p.add_argument("--accent", default="en",
                   choices=["en", "en-us", "en-uk", "en-au"])
    p.add_argument("--slow", action="store_true")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "gtts", "pyttsx3", "synthetic"])
    args = p.parse_args(argv)
    details = generate_audio_files(args.csv, args.output_dir,
                                   engine=args.engine, accent=args.accent,
                                   slow=args.slow)
    logger.info("details written to %s", details)
    return details


if __name__ == "__main__":
    main()
