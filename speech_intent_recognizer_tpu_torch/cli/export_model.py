"""CLI: export a trained checkpoint as a serving artifact.

Counterpart of ``speech_intent_recognizer_tpu/cli/export_model.py``.  The
artifact is the traced batch path (``torch.export``) plus its weights and
the label map; a serving host runs it with ``infer.export.ServingModel``
and needs neither the model's code nor the config.  ``--model_type
wav2vec`` exports a ``Wav2VecIntent`` checkpoint (``infer/export.py``).

    python -m speech_intent_recognizer_tpu_torch.cli.export_model \\
        --model checkpoints/best_model.pt \\
        --label_map data/label_map.json --out serving_artifact/ \\
        --flavor production
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from speech_intent_recognizer_tpu_torch.cli.common import (
        add_config_arg, add_device_arg, add_model_type_arg,
        load_config_or_default, make_predictor, setup_logging)
    from speech_intent_recognizer_tpu_torch.infer.export import (
        export_predictor)

    logger = setup_logging()
    p = argparse.ArgumentParser(
        description="Export a serving artifact (traced program + weights)")
    add_config_arg(p)
    p.add_argument("--model", required=True)
    p.add_argument("--label_map", required=True)
    p.add_argument("--out", required=True, help="artifact directory")
    add_model_type_arg(p)
    p.add_argument("--platforms", nargs="*", default=None,
                   help="torch device types named in the manifest (default: "
                        "cuda for a program of kernel ops, else cpu cuda)")
    p.add_argument("--flavor", default="portable",
                   choices=["portable", "production"],
                   help="portable: the unfused model on the plain front-end, "
                        "traced on the CPU, symbolic batch, any device; "
                        "production: the predictor's kernel path traced on "
                        "the card, one program per --batch_sizes entry")
    p.add_argument("--batch_sizes", nargs="*", type=int,
                   default=[8, 256, 2048],
                   help="pinned batch sizes for --flavor production")
    add_device_arg(p)
    args = p.parse_args(argv)
    cfg = load_config_or_default(args.config)
    predictor = make_predictor(args.model, args.label_map, cfg.audio,
                               args.device, model_type=args.model_type)
    out = export_predictor(predictor, args.out, platforms=args.platforms,
                           flavor=args.flavor,
                           batch_sizes=tuple(args.batch_sizes))
    logger.info("serving artifact written to %s", out)
    return 0


if __name__ == "__main__":
    main()
