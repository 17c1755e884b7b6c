"""What the host did during a run's window, read without changing anything.

* the cyclic collector's passes (``gc.callbacks``): generation, start and
  length of each;
* the process's CPU affinity, and the CPU the main thread was on as the
  window closed (``/proc/thread-self/stat``);
* the window's calls: their quartiles, the calls slower than 1.5x the
  median, and the wall time that lies outside every call (the harness's
  own time between calls).

The one read of ``/proc`` happens after the window: on the card's host,
that read after each training call put 0.56-1.10 ms a call, 0.9-1.7 % of
the window, into the harness's time between calls.

:func:`lines` turns them into standard-error lines: readable ones, and one
``host {json}`` line that ``perfbench/sets.py`` reads.  Nothing of it
enters the result line.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import time

SLOW = 1.5


def cpu() -> int:
    """The CPU the calling thread last ran on."""
    with open("/proc/thread-self/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[36])


class Watch:
    """The collector's passes from :meth:`start` to :meth:`stop`, and the
    main thread's CPU at :meth:`stop`."""

    def __init__(self):
        self.passes, self._open = [], {}

    def _on_gc(self, phase, info):
        now = time.perf_counter()
        if phase == "start":
            self._open[info["generation"]] = now
        elif info["generation"] in self._open:
            t = self._open.pop(info["generation"])
            self.passes.append((info["generation"], t, now - t))

    def start(self):
        gc.callbacks.append(self._on_gc)
        return self

    def stop(self):
        gc.callbacks.remove(self._on_gc)
        self.cpu = cpu()
        return self


def summary(window: dict, watch: Watch, seconds: float) -> dict:
    """The numbers of the window that ``lines`` prints.  ``window`` is a
    driver's: its ``start`` on ``time.perf_counter``, its ``seconds``
    where it gives them (else ``seconds``), and where it gives them
    ``call_spans``, each call's start and end (the train driver's: the
    rows' views and the program's ``train_epoch``)."""
    t0, wall = window["start"], window.get("seconds", seconds)
    inside = [(g, t, d) for g, t, d in watch.passes if t0 <= t <= t0 + wall]
    gens = {}
    for g, _t, d in inside:
        n, s, top = gens.get(g, (0, 0.0, 0.0))
        gens[g] = (n + 1, s + d, max(top, d))
    out = {"wall_s": wall,
           "gc": {str(g): {"passes": n, "ms": s * 1e3, "max_ms": top * 1e3}
                  for g, (n, s, top) in sorted(gens.items())},
           "gc_ms": sum(d for _g, _t, d in inside) * 1e3,
           "gc2_ms": [round(d * 1e3, 3) for g, _t, d in inside if g == 2],
           "affinity": sorted(os.sched_getaffinity(0)),
           "main_cpu": watch.cpu}
    spans = window.get("call_spans")
    if spans:
        ms = [(b - a) * 1e3 for a, b in spans]
        q1, med, q3 = (statistics.quantiles(ms, n=4) if len(ms) > 1
                       else (ms[0],) * 3)
        slow = [m for m in ms if m > SLOW * med]
        slow_gc = sum(d for _g, t, d in inside for a, b in spans
                      if a <= t <= b and (b - a) * 1e3 > SLOW * med)
        out.update(calls=len(ms), call_ms=[q1, med, q3], calls_ms=sum(ms),
                   slow_calls=len(slow), slow_ms=sum(slow),
                   slow_excess_ms=sum(slow) - med * len(slow),
                   slow_gc_ms=slow_gc * 1e3,
                   harness_ms=wall * 1e3 - sum(ms))
    return out


def lines(s: dict) -> list:
    """Standard-error lines of :func:`summary`'s numbers."""
    out = [f"host: affinity {s['affinity']}, main thread on CPU "
           f"{s['main_cpu']} at the close; collector in the window "
           + (", ".join(f"gen {g} {v['passes']} passes {v['ms']:.1f} ms "
                        f"(max {v['max_ms']:.1f})"
                        for g, v in s["gc"].items()) or "no pass")
           + f"; gen 2 passes ms {s['gc2_ms']}"]
    if "calls" in s:
        q1, med, q3 = s["call_ms"]
        out.append(
            f"host: {s['calls']} calls, ms a call q1 / median / q3 "
            f"{q1:.3f} / {med:.3f} / {q3:.3f}; {s['slow_calls']} slower "
            f"than {SLOW}x the median: {s['slow_ms']:.1f} ms, "
            f"{s['slow_excess_ms']:.1f} past the median, "
            f"{s['slow_gc_ms']:.1f} of it the collector's; harness "
            f"{s['harness_ms']:.2f} ms between calls")
    out.append("host " + json.dumps(s))
    return out
