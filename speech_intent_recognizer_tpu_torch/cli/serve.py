"""CLI: run the multi-session streaming intent server.

Counterpart of the JAX package's ``cli/serve.py``: many concurrent audio
sessions over one device, newline-delimited JSON protocol (see
``infer/server.py``), plus ``--device`` (default ``cuda``).  Only the
CNN-GRU model is served by the port::

    python -m speech_intent_recognizer_tpu_torch.cli.serve \\
        --model best_model.msgpack --label_map label_map.json \\
        --socket /tmp/sir.sock
"""

from __future__ import annotations

import argparse
import asyncio


def main(argv=None):
    from speech_intent_recognizer_tpu_torch.cli.common import (
        add_config_arg, add_device_arg, load_config_or_default,
        make_predictor, setup_logging)
    from speech_intent_recognizer_tpu_torch.infer.server import IntentServer

    logger = setup_logging()
    p = argparse.ArgumentParser(
        description="Multi-session streaming intent server")
    add_config_arg(p)
    p.add_argument("--model", required=True)
    p.add_argument("--label_map", required=True)
    p.add_argument("--model_type", default="cnn_gru", choices=["cnn_gru"])
    p.add_argument("--socket", default=None, help="unix socket path")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7071)
    p.add_argument("--threshold", type=float, default=0.01)
    p.add_argument("--silence_limit", type=float, default=1.0)
    add_device_arg(p)
    args = p.parse_args(argv)
    cfg = load_config_or_default(args.config)
    predictor = make_predictor(args.model, args.label_map, cfg.audio,
                               args.device)
    server = IntentServer(predictor, threshold=args.threshold,
                          silence_limit=args.silence_limit)
    logger.info("serving (ctrl-c to stop)")
    try:
        if args.socket:
            asyncio.run(server.serve_forever(socket_path=args.socket))
        else:
            asyncio.run(server.serve_forever(host=args.host,
                                             port=args.port))
    except KeyboardInterrupt:
        logger.info("server stopped")
    return 0


if __name__ == "__main__":
    main()
