"""Tracing, the program's own spans and records, a per-kernel breakdown
of device time, device memory.

Counterpart of ``speech_intent_recognizer_tpu/utils/profiling.py`` for the
card: ``torch.profiler`` takes the place of ``jax.profiler``.

* :func:`trace` — context manager writing a Chrome trace (``chrome://tracing``,
  Perfetto) of the host and the card;
* :func:`trace_annotation` — a named region inside a trace;
* :func:`span`, :func:`record` — the program's own spans (every name starts
  with ``sir.``) and per-request records.  Tracing is on exactly while a
  ``torch.profiler`` runs in the process: a span is then a
  ``record_function``, an event of the profiler's trace beside the kernels
  it launched, and a record (a tuple of ``time.perf_counter_ns()`` stamps
  and an identifier) is kept in memory for :func:`records`.  With no
  profiler a span is one shared null context and a record is dropped, at
  the cost of one read of the profiler's flag;
* :func:`device_memory_stats` — per-card live / peak bytes;
* :func:`step_times` / :func:`kernel_breakdown` — the port's own: the
  ``--profile`` phase of ``chip_smoke.py`` drives them on the main path.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

NULL = contextlib.nullcontext()  # the span of an untraced call
_records: Dict[str, list] = {}

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def tracing() -> bool:
        """True while a ``torch.profiler`` runs in this process (the flag
        the profiler sets as it starts and clears as it stops)."""
        return _autograd_profiler._is_profiler_enabled
else:  # a torch that keeps the flag in C++ alone
    def tracing() -> bool:
        """True while a ``torch.profiler`` runs in this process."""
        return torch._C._autograd._profiler_enabled()


def span(name: str):
    """``with span("sir.predict"):`` — a named region of the program on
    the profiler's timeline while a profiler runs, else :data:`NULL`
    (``record_function`` costs microseconds even with no profiler)."""
    return torch.profiler.record_function(name) if tracing() else NULL


def stamp() -> Optional[int]:
    """``time.perf_counter_ns()`` while tracing, else None."""
    return time.perf_counter_ns() if tracing() else None


def record(kind: str, *fields) -> None:
    """Keep the tuple ``fields`` among the records of ``kind`` while
    tracing; drop it otherwise."""
    if tracing():
        _records.setdefault(kind, []).append(fields)


def records(kind: str) -> list:
    """The records of ``kind`` kept since the last :func:`clear_records`,
    in the order they were made."""
    return list(_records.get(kind, ()))


def clear_records() -> None:
    _records.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host + card trace: ``with trace('/tmp/trace'): step()``
    writes ``<logdir>/trace_<pid>_<n>.json`` (Chrome trace format), with
    the card's kernels where CUDA is available."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


def trace_annotation(name: str):
    """Named region for the profiler timeline (``record_function``)."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card memory in bytes: this process's live and peak tensor bytes
    (the caching allocator's counters) and the card's total; empty without
    CUDA."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        _free, total = torch.cuda.mem_get_info(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
            "bytes_limit": int(total),
        }
    return stats


def step_times(fn: Callable[[], object], steps: int = 30,
               warmup: int = 3) -> Dict[str, float]:
    """Host-clock milliseconds of ``fn`` over ``steps`` calls.

    ``fn`` must end in a copy to the host (as ``predict_waveform_batch``
    does), so each call's time covers its device work.  Returns median,
    p25, p75 and p90."""
    for _ in range(warmup):
        fn()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    q = np.percentile(ms, [50, 25, 75, 90])
    return {"median": float(q[0]), "p25": float(q[1]), "p75": float(q[2]),
            "p90": float(q[3])}


def kernel_breakdown(fn: Callable[[], object], steps: int = 5,
                     warmup: int = 3
                     ) -> Tuple[float, List[Tuple[str, float, int]]]:
    """Profile ``steps`` calls of ``fn`` with ``torch.profiler``.

    Returns (profiled wall ms per step, kernels), where ``kernels`` holds
    (name, device ms per step, launches per step), longest first.  The
    profiler slows the host, so the device's idle share is one minus the
    summed kernel time over an unprofiled step time (:func:`step_times`);
    kernels do not overlap on the one stream."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # a user annotation's device row (``Optimizer.step#AdamW.step``) spans
    # the kernels inside it, which are counted on their own
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps,
                e.count // steps)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda k: -k[1])
    return wall_ms, kernels
