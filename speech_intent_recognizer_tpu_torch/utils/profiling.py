"""Tracing, the program's own spans and records, device memory.

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
* :func:`device_memory_stats` — per-card live / peak bytes.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

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
