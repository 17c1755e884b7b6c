"""CLI: offline inference — single file, directory batch, or interactive.

Mirrors ``python -m scripts.test_model`` (reference
``scripts/test_model.py:225-281``) and the JAX package's
``cli/test_model.py``: ``--model --label_map --audio [--interactive]`` with
the same top-3 console report, plus ``--device`` (default ``cuda``),
``--model_type wav2vec`` (a ``Wav2VecIntent`` checkpoint: the port's
``.pt``, a reference-layout ``.pt`` or the JAX trainer's ``.msgpack``)::

    python -m speech_intent_recognizer_tpu_torch.cli.test_model \\
        --model best_model.pt --label_map label_map.json --audio x.wav
    python -m speech_intent_recognizer_tpu_torch.cli.test_model \\
        --model_type wav2vec --model checkpoints/wav2vec_intent.pt \\
        --label_map label_map.json --audio x.wav
"""

from __future__ import annotations

import argparse
import os

from speech_intent_recognizer_tpu_torch.cli.common import (
    add_config_arg, add_device_arg, add_model_type_arg, load_config_or_default,
    make_predictor, setup_logging)


def _print_prediction(result: dict) -> None:
    print("\n----- PREDICTION RESULTS -----")
    print(f"Predicted intent: {result['predicted_label']}")
    print(f"Confidence: {result['confidence'] * 100:.2f}%")
    print("\nTop predictions:")
    for i, p in enumerate(result["top_predictions"]):
        print(f"  {i + 1}. {p['label']} ({p['probability'] * 100:.2f}%)")


def interactive_loop(predictor) -> None:
    print("\n===== INTERACTIVE TESTING =====")
    print("Enter the path to an audio file (or 'q' to quit):")
    while True:
        try:
            user_input = input("\nAudio file path (or 'q' to quit): ")
        except EOFError:
            break
        if user_input.strip().lower() == "q":
            break
        if not os.path.exists(user_input):
            print(f"File not found: {user_input}")
            continue
        result = predictor.predict_file(user_input)
        if result is None:
            print("Failed to make prediction.")
            continue
        _print_prediction(result)


def main(argv=None):
    logger = setup_logging()
    p = argparse.ArgumentParser(
        description="Test speech intent recognition model")
    add_config_arg(p)
    p.add_argument("--model", default="checkpoints/best_model.pt")
    p.add_argument("--label_map", default="data/processed/label_map.json")
    p.add_argument("--audio", default=None,
                   help="audio file or directory")
    p.add_argument("--interactive", action="store_true")
    add_model_type_arg(p)
    add_device_arg(p)
    args = p.parse_args(argv)

    cfg = load_config_or_default(args.config)
    predictor = make_predictor(args.model, args.label_map, cfg.audio,
                               args.device, model_type=args.model_type)

    if args.interactive or not args.audio:
        interactive_loop(predictor)
        return None
    if os.path.isdir(args.audio):
        results = predictor.predict_directory(args.audio)
        print("\n----- BATCH RESULTS SUMMARY -----")
        for r in results:
            print(f"{r['file']}: {r['predicted_label']} "
                  f"({r['confidence'] * 100:.2f}%)")
        return results
    result = predictor.predict_file(args.audio)
    if result:
        _print_prediction(result)
    else:
        logger.error("prediction failed for %s", args.audio)
    return result


if __name__ == "__main__":
    main()
