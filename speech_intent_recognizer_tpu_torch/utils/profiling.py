"""Tracing, step timing, a per-kernel breakdown of device time, device
memory.

Counterpart of ``speech_intent_recognizer_tpu/utils/profiling.py`` for the
card: ``torch.profiler`` takes the place of ``jax.profiler``.

* :func:`trace` — context manager writing a Chrome trace (``chrome://tracing``,
  Perfetto) of the host and the card;
* :func:`trace_annotation` — a named region inside a trace;
* :func:`device_memory_stats` — per-card live / peak bytes;
* :class:`StepTimer` — EMA step timing on the host clock, with derived
  rates;
* :func:`step_times` / :func:`kernel_breakdown` — the port's own: the
  ``--profile`` phase of ``chip_smoke.py`` drives them on the main path,
  and ``PERF.md`` section 5 is written from what they print.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


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


class StepTimer:
    """Exponential-moving-average step timer (host clock): the time from
    entering to leaving the ``with`` block.  Device work is asynchronous,
    so a step's time covers its device work only where the step ends in a
    copy to the host, as in the JAX package."""

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.ema: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else (
            self.decay * self.ema + (1 - self.decay) * dt)
        return False

    def rate(self, items_per_step: int) -> float:
        return items_per_step / self.ema if self.ema else 0.0


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
