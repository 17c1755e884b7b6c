"""Sets of runs of one cell, each a fresh process as the benchmark's own
runs are, and the spreads a bound is set from.

    python3 perfbench/sets.py --workload <cell> --seeds 11 12 ... \
        [--sets 2] [--seconds 20] [--trees A B] [--out runs.jsonl]

Each set runs every seed once, in every tree (a checkout's root; the
current directory by default), alternating which tree goes first from
seed to seed (A B, B A, ...).  Every run's last line and its ``host``
line (``core/host.py``) go to ``--out`` as one JSON line.  Then, for each
tree and set, each end-to-end metric's runs, median and spread: the
distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) over the median, of all the runs
and with the run farthest from the median left out where that narrows
it; and for a cell whose window gives its calls, each run's shortfall
from its set's fastest, split into (a) a slower typical call, (b) the
calls slower than 1.5x the median call (the collector's passes and other
pauses) and (c) the harness's time between calls.  The benchmark's own
runs never run this.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values: list) -> float:
    """The middle half over the median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def spread_out(values: list) -> float:
    """The spread with the run farthest from the median left out, where
    that narrows it."""
    if len(values) < 4:
        return spread(values)
    med = statistics.median(values)
    rest = list(values)
    rest.remove(max(values, key=lambda v: abs(v - med)))
    return min(spread(values), spread(rest))


def parts(runs: list, metric: str) -> list:
    """[(seed, shortfall, a, b, c)] in % of each run's own time a call,
    from the set's fastest run by ``metric`` (higher is better)."""
    def split(r):
        h = r["host"]
        t = h["wall_s"] * 1e3 / h["calls"]
        b = h["slow_excess_ms"] / h["calls"]
        c = h["harness_ms"] / h["calls"]
        return t, t - b - c, b, c

    best = max(runs, key=lambda r: r["metrics"][metric])
    tf, af, bf, cf = split(best)
    out = []
    for r in runs:
        t, a, b, c = split(r)
        out.append((r["seed"], 100 * (t - tf) / t, 100 * (a - af) / t,
                    100 * (b - bf) / t, 100 * (c - cf) / t))
    return out


def run_once(tree: str, args, seed: int) -> dict:
    cmd = [sys.executable, "perfbench/run.py", "--workload", args.workload,
           "--seed", str(seed), "--seconds", str(args.seconds),
           "--trace", str(args.trace)]
    t = time.perf_counter()
    p = subprocess.run(cmd, cwd=tree, capture_output=True, text=True,
                       timeout=args.timeout)
    rec = {"tree": tree, "seed": seed, "rc": p.returncode,
           "elapsed_s": time.perf_counter() - t}
    lines = p.stdout.strip().splitlines()
    try:
        rec.update({k: v for k, v in json.loads(lines[-1]).items()
                    if k != "breakdown"})
        rec["metrics"] = {k: v["value"] for k, v in rec["metrics"].items()}
    except (IndexError, ValueError):
        rec["stderr"] = p.stderr[-4000:]
    for line in p.stderr.splitlines():
        if line.startswith("host {"):
            rec["host"] = json.loads(line[5:])
    return rec


def report(runs: list) -> None:
    metrics = sorted({k for r in runs for k in r.get("metrics", {})})
    for m in metrics:
        vals = [r["metrics"][m] for r in runs if m in r.get("metrics", {})]
        if len(vals) < 2:
            continue
        print(f"  {m}: median {statistics.median(vals)!r}, spread "
              f"{100 * spread(vals):.3f} %, farthest out "
              f"{100 * spread_out(vals):.3f} %; runs {vals}")
    e2e = [m for m in metrics if m != "setup_s"]
    timed = [r for r in runs if "calls" in r.get("host", {})]
    if e2e and len(timed) == len(runs) >= 2:
        print("  seed, shortfall from the fastest % = (a) typical call + "
              "(b) slow calls + (c) harness; median call ms, collector "
              "ms, its generation-2 passes ms")
        rows = parts(timed, e2e[0])
        for (seed, s, a, b, c), r in zip(rows, timed):
            h = r["host"]
            print(f"  {seed} {s:.3f} = {a:.3f} + {b:.3f} + {c:.3f}; "
                  f"{h['call_ms'][1]:.3f}, {h['gc_ms']:.1f}, {h['gc2_ms']}")
        for i, name in ((2, "a"), (3, "b"), (4, "c")):
            col = [row[i] for row in rows]
            q1, med, q3 = statistics.quantiles(col, n=4)
            print(f"  part ({name}): median {med:.3f} %, quartiles "
                  f"{q1:.3f} / {q3:.3f} %")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=20)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--trees", nargs="+", default=["."])
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("--out")
    args = p.parse_args(argv)
    runs = []
    out = open(args.out, "a") if args.out else None
    for s in range(args.sets):
        for i, seed in enumerate(args.seeds):
            for tree in (args.trees if i % 2 == 0 else args.trees[::-1]):
                rec = dict(run_once(tree, args, seed), set=s)
                runs.append(rec)
                print(json.dumps({k: rec.get(k) for k in
                                  ("tree", "set", "seed", "rc", "correct",
                                   "metrics", "elapsed_s")}), flush=True)
                if out:
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
    for tree in args.trees:
        for s in range(args.sets):
            mine = [r for r in runs if r["tree"] == tree and r["set"] == s
                    and r["rc"] == 0 and "metrics" in r]
            print(f"{tree} set {s}: {len(mine)} runs, "
                  f"{sum(bool(r.get('correct')) for r in mine)} correct")
            report(mine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
