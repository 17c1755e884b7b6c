"""The program's own per-request records, for the readers of the metrics
that read them.

The program keeps them in memory while a profiler runs
(``speech_intent_recognizer_tpu_torch.utils.profiling.records``), so in a
run they are those of its one traced slice.  A program that keeps none (a
checkout from before the records) reads as an empty list, and the metric
is then left out.
"""

from __future__ import annotations


def records(kind: str) -> list:
    from speech_intent_recognizer_tpu_torch.utils import profiling

    read = getattr(profiling, "records", None)
    return read(kind) if read is not None else []


def union_length(intervals, lo: float, hi: float) -> float:
    """The length of the union of ``intervals`` ((start, end) pairs) inside
    [lo, hi], in the intervals' unit."""
    total, reach = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total
