#!/usr/bin/env python
"""Host-bound serving steps of the PyTorch port on one H100, timed in
whichever checkout of the port is on ``sys.path``: the batch step at B=256
(K1 once, K2 twice) and the B=1 end of speech (K4 once, the fp32 K2
twice), to see what the kernels' calls going through their
``torch.library`` ops (``ops/library.py``) cost on the host.

In a checkout that has the ops, both steps run in one process through
the ops as shipped (``op``) and with every op swapped for its kernel's
launch body, the route before the ops (``direct``): ten rounds, each
timing one block of each route, the order alternating from round to
round, so that the host's drift falls on both.  Run it in a checkout from
before the ops too, for the steps as they were:

    env PYTHONPATH=<checkout> python3 <checkout>/bench_torch_op_dispatch.py

Each step runs on seeded full-width weights (CNNAudioGRU, 31 classes) with
device-resident input and ends in the copy of the probabilities to the
host; a block is 50 calls after ten warm-up calls, ended by a synchronize.
Prints the card's name and power limit, then one JSON line: for each route
and step the host-clock ms per call of every block, their least, median
and most, the median of the rounds' differences (op minus direct), and
where the package came from.  Needs one card.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 256
ROUNDS, ITERS = 10, 50


def block(fn) -> float:
    """Host ms per call of ITERS calls after ten warm-up calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / ITERS


def direct_route():
    """{op name: its kernel's launch body} of this checkout's ``sir`` ops,
    or None in a checkout without them."""
    try:
        from speech_intent_recognizer_tpu_torch.ops import library
    except ImportError:
        return None
    from speech_intent_recognizer_tpu_torch.ops import (
        conv23, frontend_kernels as fk, gru, pool_epilogue)

    library.load()
    return {"frontend_conv1": fk._frontend_conv1_cuda,
            "frontend": fk._frontend_cuda, "mel_db": fk._mel_db_cuda,
            "gru_layer": gru._gru_layer_cuda, "conv23": conv23._conv23_cuda,
            "bias_relu_pool2": pool_epilogue._bias_relu_pool2_cuda}


def main() -> int:
    import speech_intent_recognizer_tpu_torch as pkg
    from speech_intent_recognizer_tpu_torch.infer.predict import Predictor
    from speech_intent_recognizer_tpu_torch.infer.streaming import (
        StreamingRecognizer)
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
    from speech_intent_recognizer_tpu_torch.utils.device import (
        gpu_label, require_cuda)

    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = CNNAudioGRU(num_classes=31)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(model.state_dict(), f"{tmp}/m.pt")
        with open(f"{tmp}/lm.json", "w") as f:
            json.dump({str(i): i for i in range(31)}, f)
        pred = Predictor.from_checkpoint(f"{tmp}/m.pt", f"{tmp}/lm.json",
                                         device=dev)
    width = pred._buffer_width()
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, 80000, BATCH).astype(np.int32)
    buf = (0.1 * rng.standard_normal((BATCH, width))).astype(np.float32)
    buf[np.arange(width)[None, :] >= lengths[:, None]] = 0.0
    wf = torch.from_numpy(buf).to(dev)
    ln = torch.from_numpy(lengths).to(dev)

    # the end of speech: one session fed a 1.5 s tone, then its finalize
    # (tail frames, K4, normalization, the fp32 model) read again and again
    rec = StreamingRecognizer(pred, featurizer_mode="host")
    t = np.arange(24000) / 16000
    tone = (0.3 * np.sin(2 * np.pi * 300 * t)
            + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    for i in range(0, tone.size, 1024):
        rec.feed(tone[i:i + 1024])
    assert rec.recording

    steps = {f"predict_b{BATCH}": lambda: pred.predict_waveform_batch(wf, ln),
             "finalize_b1": rec._fused_finalize}
    direct = direct_route()
    if direct is None:
        swaps = {"as_is": {}}
    else:  # the attribute torch.ops.sir.<name> is what the wrappers call
        swaps = {"op": {k: getattr(torch.ops.sir, k) for k in direct},
                 "direct": direct}
    times = {route: {step: [] for step in steps} for route in swaps}
    for r in range(ROUNDS):
        for route in list(swaps)[::1 if r % 2 == 0 else -1]:
            for name, fn in swaps[route].items():
                setattr(torch.ops.sir, name, fn)
            for step, fn in steps.items():
                times[route][step].append(block(fn))
    for name, fn in swaps.get("op", {}).items():
        setattr(torch.ops.sir, name, fn)
    found = {route: {step: {"blocks": t, "least": min(t),
                            "median": float(np.median(t)), "most": max(t)}
                     for step, t in per.items()}
             for route, per in times.items()}
    if direct is not None:
        found["op_minus_direct_median"] = {
            step: float(np.median(np.subtract(times["op"][step],
                                              times["direct"][step])))
            for step in steps}
    print(gpu_label())
    print(json.dumps({"package": pkg.__file__, "device":
                      torch.cuda.get_device_name(dev), "steps_ms": found}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
