"""CLI: a pretrained wav2vec2 checkpoint -> a ``Wav2VecIntent`` model file.

Counterpart of the JAX package's ``cli/convert_wav2vec.py``.  The input is
a LOCAL ``save_pretrained`` directory (``config.json`` with
``model.safetensors`` or ``pytorch_model.bin``), read without
``transformers`` or ``safetensors``; the output is the port's ``.pt`` (the
converted backbone under ``wav2vec.``, the positional convolution's weight
norm folded, a fresh attention / classifier head from ``--seed``) and a
``.json`` beside it with the backbone config, which
``Wav2VecPredictor.from_checkpoint`` and ``cli.train_wav2vec`` read.  As
the JAX converter initialises the model with one forward pass, this one
runs the converted model once on one second of silence on ``--device``
(default ``cuda``) and refuses a result that is not finite::

    python -m speech_intent_recognizer_tpu_torch.cli.convert_wav2vec \\
        --checkpoint /path/to/wav2vec2-base-dir --num_classes 31 \\
        --output checkpoints/wav2vec_intent.pt
"""

from __future__ import annotations

import argparse
import logging

import torch

from speech_intent_recognizer_tpu_torch.cli.common import add_device_arg
from speech_intent_recognizer_tpu_torch.models.wav2vec import (
    Wav2VecIntent, init_wav2vec)

logger = logging.getLogger(__name__)


def convert(checkpoint: str, num_classes: int, output: str,
            seed: int = 0, device: str = "cuda") -> Wav2VecIntent:
    from speech_intent_recognizer_tpu_torch.convert.wav2vec_import import (
        load_pretrained_dir)
    from speech_intent_recognizer_tpu_torch.train.checkpoint import (
        save_model)

    try:
        config, backbone = load_pretrained_dir(checkpoint)
    except (OSError, KeyError, ValueError) as e:
        raise SystemExit(f"no loadable pretrained weights at {checkpoint!r} "
                         f"(expected a save_pretrained directory): {e}")
    model = init_wav2vec(Wav2VecIntent(config, num_classes), seed,
                         {f"wav2vec.{k}": v for k, v in backbone.items()})
    with torch.no_grad():
        logits = model.to(device).eval()(
            torch.zeros((1, 16000), device=device),
            torch.ones((1, 16000), dtype=torch.bool, device=device))
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"the model converted from {checkpoint!r} gives "
                         f"non-finite logits on {device}")
    save_model(output, model.state_dict(), meta={
        "num_classes": num_classes, "source_checkpoint": checkpoint,
        "wav2vec_config": config.to_dict()})
    logger.info("wrote %s (backbone from %s, fresh %d-class head)",
                output, checkpoint, num_classes)
    return model


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="a local save_pretrained directory")
    ap.add_argument("--num_classes", type=int, default=31)
    ap.add_argument("--output", required=True, help="output .pt path")
    ap.add_argument("--seed", type=int, default=0, help="head-init seed")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    convert(args.checkpoint, args.num_classes, args.output, seed=args.seed,
            device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
