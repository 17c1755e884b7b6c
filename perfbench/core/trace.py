"""A profiled slice of a run, reduced to what the per-layer readers need.

:class:`Profiler` runs ``torch.profiler`` over a slice inside the span
``perfbench.slice``, which it ends with a device synchronisation, so that
the span covers every device operation the slice started.  The Chrome
trace is read back into a :class:`Trace`:

* device operations (kernels, copies, fills) with their start and length;
* the host span of each kernel's launch: a kernel belongs to a span when
  the runtime call that launched it lies inside the span, on the same
  thread (the ``correlation`` id links the two);
* the harness's own spans (``record_function``), opened around the calls
  it makes into the program and by forward hooks on its submodules
  (:class:`SpanHooks`).

The device's busy time is the union of the device operations' intervals
inside the slice, its idle share one minus that over the slice's length.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

SLICE = "perfbench.slice"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class SpanHooks:
    """Hooks that open a ``record_function`` span named for each of
    ``modules`` (pairs of module and span name) while its forward runs,
    and for each of ``backward`` while autograd computes the gradients of
    its inputs (on autograd's thread, with a stack of its own)."""

    def __init__(self, modules, backward=()):
        self.modules = list(modules)
        self.backward = list(backward)
        self._handles = []
        self._open = {"fwd": [], "bwd": []}

    def __enter__(self):
        for module, name in self.modules:
            self._handles.append(module.register_forward_pre_hook(
                lambda _m, _a, name=name: self._enter("fwd", name)))
            self._handles.append(module.register_forward_hook(
                lambda _m, _a, _o: self._exit("fwd")))
        for module, name in self.backward:
            self._handles.append(module.register_full_backward_pre_hook(
                lambda _m, _g, name=name: self._enter("bwd", name)))
            self._handles.append(module.register_full_backward_hook(
                lambda _m, _gi, _go: self._exit("bwd")))
        return self

    def _enter(self, stack, name):
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        self._open[stack].append(rf)

    def _exit(self, stack):
        self._open[stack].pop().__exit__(None, None, None)

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles = []
        for stack, spans in self._open.items():
            while spans:
                self._exit(stack)
        return False


class Trace:
    """Device operations and host spans of one profiled slice (times in
    microseconds, the profiler's clock)."""

    def __init__(self, events: list):
        self.ops = []      # (name, start, end, cat, correlation)
        self.spans = []    # (name, start, end, tid)
        launches = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in _DEVICE_CATS:
                self.ops.append((e["name"], ts, ts + dur, cat,
                                 args.get("correlation")))
            elif cat in _LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (ts, e.get("tid"))
            elif cat == "user_annotation":
                self.spans.append((e["name"], ts, ts + dur, e.get("tid")))
        self.ops.sort(key=lambda o: o[1])
        self.launch = {}
        for op in self.ops:
            if op[4] in launches:
                self.launch[id(op)] = launches[op[4]]
        whole = [s for s in self.spans if s[0] == SLICE]
        self.start, self.end = ((whole[0][1], whole[0][2]) if whole
                                else (0.0, 0.0))

    # ------------------------------------------------------------- kernels

    @property
    def kernels(self) -> list:
        return [o for o in self.ops if o[3] == "kernel"]

    def kernels_in(self, span: str) -> list:
        """Kernels launched from inside any span named ``span``."""
        ranges = defaultdict(list)
        for name, s, e, tid in self.spans:
            if name == span:
                ranges[tid].append((s, e))
        out = []
        for k in self.kernels:
            at = self.launch.get(id(k))
            if at is None:
                continue
            ts, tid = at
            if any(s <= ts <= e for s, e in ranges.get(tid, ())):
                out.append(k)
        return out

    def per_span(self, span: str) -> list:
        """[(start, end, device operations launched inside)] for each
        span named ``span``."""
        out = [(s, e, tid, []) for name, s, e, tid in self.spans
               if name == span]
        for op in self.ops:
            at = self.launch.get(id(op))
            if at is None:
                continue
            for s, e, tid, ops in out:
                if tid == at[1] and s <= at[0] <= e:
                    ops.append(op)
                    break
        return [(s, e, ops) for s, e, _tid, ops in out]

    def kernels_named(self, pattern: str) -> list:
        rx = re.compile(pattern)
        return [k for k in self.kernels if rx.search(k[0])]

    def span_starts(self, span: str) -> list:
        return sorted(s for name, s, _e, _t in self.spans if name == span)

    @staticmethod
    def seconds(ops) -> float:
        return sum(o[2] - o[1] for o in ops) / 1e6

    # -------------------------------------------------------------- device

    def _busy_intervals(self) -> list:
        merged = []
        for _n, s, e, _c, _k in self.ops:
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy_intervals()) / 1e6

    def top_ops(self, n: int = 10) -> list:
        """The device operations that took the most time: [name, s]."""
        by = defaultdict(float)
        for name, s, e, _c, _k in self.ops:
            by[name] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time in the slice, summed by the innermost
        harness span the host was in when each gap began (``host`` where
        it was in none): [label, s], longest first."""
        busy = self._busy_intervals()
        gaps, t = [], self.start
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        inner = sorted((s for s in self.spans if s[0] != SLICE),
                       key=lambda s: s[1])
        starts = [s[1] for s in inner]
        longest = max((s[2] - s[1] for s in inner), default=0.0)
        by = defaultdict(float)
        for a, b in gaps:
            # the innermost span holding a: the latest to start of those
            # that have not ended, among those that started since a minus
            # the longest span
            label = "host"
            for sp in reversed(inner[bisect.bisect_left(starts, a - longest):
                                     bisect.bisect_right(starts, a)]):
                if sp[2] >= a:
                    label = sp[0]
                    break
            by[label] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


class Profiler:
    """``torch.profiler`` over a slice that starts and stops where the
    caller says (an event loop's callbacks, for a server): :meth:`start`
    opens the ``perfbench.slice`` span, :meth:`stop` synchronises the
    device, closes it and returns the :class:`Trace`."""

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        if cuda:
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.start()
        self._span = torch.profiler.record_function(SLICE)
        self._span.__enter__()

    def stop(self) -> Trace:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json",
                                    prefix="perfbench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            with contextlib.suppress(OSError):
                os.remove(path)
        return Trace(events)


def warm_profiler() -> None:
    """Start and stop the profiler once on a small device operation: its
    first start initialises the device tracer, which can take seconds,
    and belongs in set-up, not in a slice."""
    prof = Profiler()
    prof.start()
    if torch.cuda.is_available():
        torch.ones(1, device="cuda").add_(1)
    prof.stop()
