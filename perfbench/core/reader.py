"""What a per-layer metric's reader is given, and the arithmetic they
share.

A reader is ``metrics/<metric>.py`` with ``read(ctx) -> float | None``.
It returns None where it finds nothing to read (no kernel of its layer in
the slice, no span of its kind), and the harness then leaves the metric
out of the result.  A share of a roofline or of a peak is never made up:
with no measured time there is no share.
"""

from __future__ import annotations

from core import peaks
from core.trace import Trace


class Context:
    def __init__(self, cell, driver, window: dict, trace: Trace):
        self.cell = cell
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.driver = driver
        self.window = window
        self.trace = trace
        self.work = cell.work()

    def slice_work(self, layer: str) -> tuple:
        """(operations by precision, bytes) of ``layer`` over every call
        of the traced slice (the driver's ``layer_work`` of each)."""
        flops, nbytes = {}, 0.0
        for call in self.window["slice"]["calls"]:
            w = self.driver.layer_work(self.work, call)[layer]
            for p, n in w["flops"].items():
                flops[p] = flops.get(p, 0.0) + n
            nbytes += w["bytes"]
        return flops, nbytes

    def roofline(self, layer: str, kernels: list):
        """100 x the least time of ``layer``'s work in the slice over the
        time its kernels took; None without kernels."""
        measured = Trace.seconds(kernels)
        if not kernels or measured <= 0:
            return None
        return 100.0 * peaks.least_seconds(*self.slice_work(layer)) / measured

    def mfu(self):
        """100 x the least compute time of every call of the window, at
        each precision's peak, over the window's wall time."""
        flops = {}
        for call in self.window["calls"]:
            for p, n in self.driver.call_flops(self.work, call).items():
                flops[p] = flops.get(p, 0.0) + n
        if not flops or self.window["seconds"] <= 0:
            return None
        return 100.0 * peaks.compute_seconds(flops) / self.window["seconds"]

    def idle_share(self):
        """100 x the share of the slice in which no device operation ran;
        None where the slice saw no device operation."""
        if not self.trace.ops or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)
