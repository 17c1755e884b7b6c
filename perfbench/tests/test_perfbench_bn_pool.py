"""``bn_pool_ms.train`` on small synthetic traces: nothing without the
program's epilogue spans, and the device ms a step of the kernels
launched inside them (forward on the caller's thread, backward on
autograd's) with both."""

from types import SimpleNamespace

from core.bench import load_module
from core.trace import SLICE, Trace


def _span(name, ts, dur, tid):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def _launched(corr, at, tid, start, dur, name="bn_pool_apply_kernel"):
    """A runtime launch at ``at`` on ``tid`` and its kernel on the card."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": at, "dur": 1, "tid": tid, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "ts": start,
             "dur": dur, "tid": 7, "args": {"correlation": corr}}]


def _read(events, calls=2, steps_per_call=4):
    ctx = SimpleNamespace(trace=Trace(events),
                          window={"slice": {"calls": [1024] * calls}},
                          traffic={"steps_per_call": steps_per_call})
    return load_module("metrics", "bn_pool_ms.train.py").read(ctx)


def test_reads_nothing_without_the_spans():
    events = [_span(SLICE, 0, 2000, 1), _span("sir.train.forward", 5, 50, 1),
              *_launched(1, 10, 1, 100, 300)]
    assert _read(events) is None


def test_device_ms_a_step_inside_both_spans():
    events = [_span(SLICE, 0, 5000, 1),
              _span("sir.conv.bn_pool", 10, 20, 1),
              *_launched(1, 15, 1, 100, 50),
              *_launched(2, 25, 1, 160, 30, "bn_stats_kernel"),
              # outside any epilogue span: the conv, the GRU
              *_launched(3, 40, 1, 200, 1000, "cudnn_conv"),
              # the backward span on autograd's thread
              _span("sir.conv.bn_pool.backward", 60, 20, 2),
              *_launched(4, 65, 2, 1300, 40, "bn_pool_grad_kernel"),
              # a launch on the main thread while that span is open
              *_launched(5, 70, 1, 1400, 500, "cudnn_conv")]
    # (50 + 30 + 40) us over 2 calls x 4 steps
    assert abs(_read(events) - 0.120 / 8) < 1e-12
