"""CLI: dataset preprocessing (manifest validation + label map).

Mirrors the JAX package's ``cli/preprocess.py`` (reference ``python -m
scripts.preprocess_fsc``, ``scripts/preprocess_fsc.py:209-219``); host only,
no device::

    python -m speech_intent_recognizer_tpu_torch.cli.preprocess \\
        --train_csv train.csv --valid_csv valid.csv --test_csv test.csv \\
        --output_dir data/processed
"""

from __future__ import annotations

import argparse

from speech_intent_recognizer_tpu_torch.cli.common import setup_logging
from speech_intent_recognizer_tpu_torch.data.preprocess import (
    preprocess_dataset)


def main(argv=None) -> dict:
    logger = setup_logging()
    p = argparse.ArgumentParser(description="Preprocess an intent dataset")
    p.add_argument("--train_csv", required=True)
    p.add_argument("--valid_csv", required=True)
    p.add_argument("--test_csv", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--label_map_path", default=None)
    p.add_argument("--no_validate", action="store_true",
                   help="skip audio decode validation (existence check only)")
    args = p.parse_args(argv)
    result = preprocess_dataset(
        args.train_csv, args.valid_csv, args.test_csv, args.output_dir,
        label_map_path=args.label_map_path, validate=not args.no_validate)
    logger.info("preprocessing complete: %s", result)
    return result


if __name__ == "__main__":
    main()
