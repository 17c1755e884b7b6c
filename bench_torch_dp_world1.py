#!/usr/bin/env python
"""What the port's data-parallel machinery costs at world 1 on one H100.

Joins a process group of one over NCCL (a ``file://`` store in a
temporary directory) and builds ``chip_smoke.py``'s bf16 train steps of
the full-width model: the feature step at B=256 and the waveform step at
B=1024, each three ways:

* ``one``: one process, no mesh;
* ``dp``: ``Trainer(mesh=)`` at world 1: synchronized BatchNorm, the
  global-batch draws, the flat gradient all-reduce, the metric
  all-reduce;
* ``dp_local_bn``: the same with BatchNorm unsynchronized
  (``set_sync_group(None)``): the all-reduces of the gradients and
  metrics alone.

A block times six windows, one ``dp`` ``dp_local_bn`` ``dp_local_bn``
``dp`` one, so that a drift of the host falls alike on each; a window is
``--iters`` steps after two warm-up steps.  Each window gives ms per step
by CUDA events and the main thread's CPU ms per step
(``time.thread_time``: the host work that a host-bound step waits on).  A
block's cost of ``dp`` (or ``dp_local_bn``) is its two windows over the
two ``one`` windows, minus one.  Prints each block's costs, then their
mean, standard error, least and most, beside the card's name and power
limit, and as its last line one JSON object with every window::

    python3 bench_torch_dp_world1.py [--blocks 16] [--wave-blocks 6]

Needs one card and the kernels' sources (built on the first call).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

WAYS = ("one", "dp", "dp_local_bn")
ORDER = ("one", "dp", "dp_local_bn", "dp_local_bn", "dp", "one")


def window(fn, iters: int) -> tuple:
    """(CUDA-event ms, main-thread CPU ms) per step over ``iters`` steps
    after two warm-up steps."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    c0 = time.thread_time()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    cpu = (time.thread_time() - c0) * 1e3 / iters
    return start.elapsed_time(end) / iters, cpu


def cell(steps: dict, blocks: int, iters: int, name: str) -> dict:
    """Every block of ORDER over ``steps``; the costs against ``one``."""
    times = []
    for b in range(blocks):
        t = [(way, *window(steps[way], iters)) for way in ORDER]
        times.append(t)
        by = {w: [(ms, cpu) for way, ms, cpu in t if way == w] for w in WAYS}
        cost = {w: (sum(ms for ms, _ in by[w]) / sum(ms for ms, _ in
                                                     by["one"]) - 1,
                    sum(c for _, c in by[w]) / sum(c for _, c in
                                                   by["one"]) - 1)
                for w in WAYS[1:]}
        print(f"{name} block {b}: " + ", ".join(
            f"{way} {ms:.3f} ms / cpu {cpu:.3f}" for way, ms, cpu in t)
            + "; cost " + ", ".join(f"{w} {c[0]:+.2%} (cpu {c[1]:+.2%})"
                                    for w, c in cost.items()), flush=True)
    out = {"iters": iters, "windows": times, "cost": {}}
    for w in WAYS[1:]:
        for k, clock in ((1, "ms"), (2, "cpu")):
            costs = []
            for t in times:
                mine = sum(x[k] for x in t if x[0] == w)
                base = sum(x[k] for x in t if x[0] == "one")
                costs.append(mine / base - 1)
            c = np.asarray(costs)
            out["cost"][f"{w}_{clock}"] = {
                "blocks": costs, "mean": float(c.mean()),
                "stderr": float(c.std(ddof=1) / np.sqrt(len(c))),
                "least": float(c.min()), "most": float(c.max())}
    means = {w: float(np.mean([x[1] for t in times for x in t
                               if x[0] == w])) for w in WAYS}
    out["ms"] = means
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=16,
                    help="blocks of the feature step at B=256")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--wave-blocks", type=int, default=6,
                    help="blocks of the waveform step at B=1024")
    ap.add_argument("--wave-iters", type=int, default=6)
    args = ap.parse_args(argv)

    import chip_smoke as cs
    from speech_intent_recognizer_tpu_torch import _build
    from speech_intent_recognizer_tpu_torch.parallel.distributed import (
        initialize_distributed)
    from speech_intent_recognizer_tpu_torch.parallel.mesh import create_mesh

    dev = cs.require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = cs.gpu_label()
    print(f"{label} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    _build.build()
    _build.load()
    result = {"device": label}
    with tempfile.TemporaryDirectory(prefix="sir_dp1_") as tmp:
        initialize_distributed("file://" + os.path.join(tmp, "store"), 1, 0,
                               device="cuda")
        mesh = create_mesh()
        for name, b, blocks, iters in (
                ("feature", 256, args.blocks, args.iters),
                ("waveform", 1024, args.wave_blocks, args.wave_iters)):
            if name == "feature":
                make = lambda m: (cs.train_step_timer(dev, b, m), None)
            else:
                make = lambda m: cs.wave_step_timer(dev, b, m)[:2]
            steps = {}
            for way in WAYS:
                fn, _ = make(None if way == "one" else mesh)
                steps[way] = fn
            # the third way's model: BatchNorm over its own rows
            for c in steps["dp_local_bn"].__closure__ or ():
                obj = c.cell_contents
                if hasattr(obj, "mesh") and hasattr(obj, "model"):
                    obj.model.set_sync_group(None)
            result[f"{name}_b{b}"] = r = cell(steps, blocks, iters, name)
            for w in WAYS[1:]:
                for clock in ("ms", "cpu"):
                    c = r["cost"][f"{w}_{clock}"]
                    print(f"{name} B={b}, {w} vs one ({clock}, {blocks} "
                          f"blocks x {iters} steps): mean {c['mean']:+.2%} "
                          f"+- {c['stderr']:.2%} (standard error), least "
                          f"{c['least']:+.2%}, most {c['most']:+.2%}",
                          flush=True)
            print(f"{name} B={b} ms per step: " + ", ".join(
                f"{w} {v:.3f}" for w, v in r["ms"].items()), flush=True)
            del steps
        torch.distributed.destroy_process_group()
    print(label)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
