"""CLI: live or replayed streaming intent recognition.

Mirrors ``python -m scripts.testing`` (reference ``scripts/testing.py:
349-376``) and the JAX package's ``cli/stream.py``: ``--model --label_map
--threshold --silence_limit`` with the incremental streaming front-end,
``--audio`` to replay files through the same VAD + streaming stack when no
microphone exists, and ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions).  ``--model`` takes a ``.msgpack`` of the JAX
trainer or a ``.pt`` state dict::

    python -m speech_intent_recognizer_tpu_torch.cli.stream \\
        --model best_model.msgpack --label_map label_map.json --audio x.wav
"""

from __future__ import annotations

import argparse
import os

from speech_intent_recognizer_tpu_torch.cli.common import (
    add_config_arg, add_device_arg, load_config_or_default, make_predictor,
    setup_logging)
from speech_intent_recognizer_tpu_torch.infer.mic import (
    FileAudioSource, MicrophoneSource, print_result, run_live)
from speech_intent_recognizer_tpu_torch.infer.streaming import (
    StreamingRecognizer)


def main(argv=None):
    logger = setup_logging()
    p = argparse.ArgumentParser(
        description="Speech intent recognition from microphone or replay")
    add_config_arg(p)
    p.add_argument("--model", default="checkpoints/best_model.msgpack")
    p.add_argument("--label_map", default="data/processed/label_map.json")
    p.add_argument("--threshold", type=float, default=0.01,
                   help="energy threshold for speech detection")
    p.add_argument("--silence_limit", type=float, default=1.0,
                   help="seconds of silence before end-of-utterance")
    p.add_argument("--audio", default=None, nargs="*",
                   help="replay audio file(s) instead of live capture")
    p.add_argument("--save_dir", default=None,
                   help="save detected utterances as WAVs (mic_recordings "
                        "flow)")
    p.add_argument("--realtime", action="store_true",
                   help="pace file replay at real time")
    add_device_arg(p)
    args = p.parse_args(argv)

    cfg = load_config_or_default(args.config)
    predictor = make_predictor(args.model, args.label_map, cfg.audio,
                               args.device)
    recognizer = StreamingRecognizer(
        predictor, threshold=args.threshold,
        silence_limit=args.silence_limit)

    results = []
    if args.audio:
        for path in args.audio:
            if not os.path.exists(path):
                logger.error("missing audio file: %s", path)
                continue
            src = FileAudioSource(path, cfg.audio.sample_rate,
                                  realtime=args.realtime)
            results += run_live(recognizer, src, on_result=print_result,
                                save_dir=args.save_dir)
    else:
        src = MicrophoneSource(cfg.audio.sample_rate)
        logger.info("listening... (Ctrl+C to stop)")
        results = run_live(recognizer, src, on_result=print_result,
                           save_dir=args.save_dir)
    return results


if __name__ == "__main__":
    main()
