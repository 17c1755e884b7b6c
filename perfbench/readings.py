"""The readings a cell's limits are set from, on the card, in one
process:

* lower: the program's numbers on each seed (a short window at the cell's
  own load that drives every distinct input of the pool once);
* upper: the control's, the plain reference computed in the nearest
  precision below the configuration's (``core.compare.BELOW``) put in the
  program's place, on the same inputs; and a fault's (``FAULTS``) planted
  in the program.

    python3 perfbench/readings.py --workload <cell> --seeds 1 2 3 ... \
        --control-seeds 1 2 3 [--fault half_batch --fault-seeds 1 2 3]

Prints one JSON line per reading.  The benchmark's own runs never run
this; ``PERF.md`` gives the readings each limit was set from.
"""

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


@contextlib.contextmanager
def half_batch():
    """A training step whose loss leaves out the second half of its rows
    and takes the mean over the rest."""
    import torch

    from speech_intent_recognizer_tpu_torch.train import loop

    whole = loop.cross_entropy

    def half(logits, labels_onehot, weights, total_weight=None):
        n = weights.shape[0]
        keep = torch.arange(n, device=weights.device) < n // 2
        return whole(logits, labels_onehot, weights * keep)

    loop.cross_entropy = half
    try:
        yield
    finally:
        loop.cross_entropy = whole


FAULTS = {"half_batch": half_batch}


def control_predict(drv, precision: str):
    """The reference at ``precision`` in the program's place: a predict
    that answers each pool batch with the reference's probabilities."""
    cast = __import__("core.compare", fromlist=["CASTS"]).CASTS[precision]
    index = {id(wf): i for i, (wf, _ln) in enumerate(drv.pool)}
    cache = {}

    def predict(wf, ln):
        i = index[id(wf)]
        if i not in cache:
            cache[i] = drv.reference.probabilities(drv.state, drv.cfg, wf, ln,
                                                   cast).astype("float32")
        return cache[i]
    return predict


def reading(cell, seed: int, control: bool, device: str = "cuda") -> dict:
    """One seed's numbers: the program's, or (``control``) the control's.
    A driver with ``control_check`` serves the window with the program and
    puts the control in its place afterwards (the streaming server's
    results are judged by utterance); the others answer each call of a
    short window with the control."""
    import torch

    from core import compare

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = cell.driver().Driver(cell.config, cell.traffic, cell.reference(),
                               seed, device)
    low = compare.BELOW[drv.precision]
    side = "control:" + low if control else "program"
    t0 = time.perf_counter()
    if hasattr(drv, "control_check"):
        drv.window(cell.traffic.get("readings_seconds",
                                    cell.bench["run_seconds"]))
        checks = drv.control_check(low) if control else drv.check()
    else:
        if control:
            drv.free()
            drv.predict = control_predict(drv, low)
        drv.window(0.0, min_calls=len(drv.pool))
        checks = drv.check()
    return {"cell": cell.name, "seed": seed, "side": side,
            "seconds": time.perf_counter() - t0,
            "checks": {n: v for n, v, _lim in checks}}


def main():
    from core.bench import Cell

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = p.parse_args()
    cell = Cell(args.workload)
    for seeds, control in ((args.seeds, False), (args.control_seeds, True)):
        for s in seeds:
            print(json.dumps(reading(cell, s, control)), flush=True)
    for s in args.fault_seeds:
        with FAULTS[args.fault]():
            out = reading(cell, s, False)
        out["side"] = "fault:" + args.fault
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
