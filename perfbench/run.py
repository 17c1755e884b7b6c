"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s`` from the start of this process to the
first timed call) builds the program and its inputs from the seed and
warms up every shape the cell uses.  The window measures the cell's
end-to-end metrics for ``--seconds``.  With ``--trace 1`` a short slice of
the same traffic then runs under the profiler, and the cell's per-layer
metrics are read from the window and the slice.  After the device's peak
memory is read and the program's state is freed, the plain reference
checks every output the window produced.  The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error and the last key of that object.

Exit codes: 0 a result was printed; 2 no card, or fewer cards than the
cell asks for; 3 the process holds a JAX module after the window.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)
# a library the program uses may load JAX by itself; keep it from doing so
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
os.environ.setdefault("USE_TF", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "speech_intent_recognizer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (the port's own name starts with the latter's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(i))
                                     for i in range(chips))}


def per_layer(cell, driver, window: dict, trace) -> dict:
    """The cell's per-layer metrics that their readers find something to
    read for."""
    from core.reader import Context

    ctx = Context(cell, driver, window, trace)
    out = {}
    for m in cell.per_layer():
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(args, device: str = "cuda", cell=None) -> dict:
    """One run of the cell; returns the result object (without printing).
    ``device`` and ``cell`` serve the CPU tests, which skip the look for a
    card."""
    import torch

    from core import host, trace as tr
    from core.bench import Cell

    cell = cell or Cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = cell.driver().Driver(cell.config, cell.traffic, cell.reference(),
                               args.seed, device)
    if args.trace:
        tr.warm_profiler()
    watch = host.Watch().start()
    window = drv.window(args.seconds, tr.Profiler() if args.trace else None)
    watch.stop()
    setup_s = window["start"] - T0
    report = host.summary(window, watch, args.seconds)
    result = {"correct": False, "attempted": int(window["attempted"]),
              "failed": int(window["failed"])}
    trace = window.get("trace")
    if args.trace:
        metrics = per_layer(cell, drv, window, trace)
    else:
        metrics = dict(window["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(metrics[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end()}
    if device == "cuda":
        dev = device_info(torch, cell.chips)
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if args.trace:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.idle_gaps()}
    for line in host.lines(report):
        print(line, file=sys.stderr)
    checks = drv.check()
    result["correct"] = bool(checks) and all(v <= lim
                                             for _n, v, lim in checks)
    result.update(metrics=metrics, device=dev)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from core.bench import Cell

    cell = Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(args, "cuda", cell)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
