"""Step timing and a per-kernel breakdown of device time.

Counterpart of ``speech_intent_recognizer_tpu/utils/profiling.py`` for the
card: ``torch.profiler`` takes the place of ``jax.profiler``.  The
``--profile`` phase of ``chip_smoke.py`` drives both functions on the main
path, and ``PERF.md`` section 5 is written from what they print.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch


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
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps,
                e.count // steps)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    return wall_ms, kernels
