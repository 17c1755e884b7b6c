"""What a run reports of its host on standard error (``core/host.py``):
the window's calls, the collector's passes and the harness's time between
calls, with the last line's keys as they were; and the spreads and the
split of a run's shortfall that ``sets.py`` takes from those lines."""

import argparse
import gc
import json
import time

import pytest

import run
import sets
from core import host
from tiny_cells import small_cell

TRAIN = "cnn_gru.train.b1024"


def test_a_train_run_reports_its_host(capsys):
    args = argparse.Namespace(workload=TRAIN, seed=2 ** 31 + 13, seconds=1.0,
                              trace=0)
    res = run.run(args, "cpu", small_cell(TRAIN))
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    err = capsys.readouterr().err.splitlines()
    said = [line for line in err if line.startswith("host: ")]
    assert any("collector in the window" in line for line in said)
    assert any("ms a call q1 / median / q3" in line
               and "ms between calls" in line for line in said)
    h = json.loads(next(line for line in err if line.startswith("host {"))[5:])
    assert h["calls"] >= 1 and len(h["call_ms"]) == 3
    # the window lies inside its calls, but for a clock read and an append
    # each
    assert 0 <= h["harness_ms"] < 0.01 * 1e3 * h["wall_s"]
    rows = res["attempted"]
    assert res["metrics"]["train_utt_per_s"]["value"] == pytest.approx(
        rows / h["wall_s"])


def test_summary_of_a_window():
    watch = host.Watch().start()
    t0 = time.perf_counter()
    spans, t = [], t0
    for ms in (10, 10, 10, 40):
        while time.perf_counter() < t + 1e-3:
            pass
        a = time.perf_counter()
        if ms == 40:
            gc.collect()
        while time.perf_counter() < a + ms / 1e3:
            pass
        t = time.perf_counter()
        spans.append((a, t))
    watch.stop()
    s = host.summary({"start": t0, "seconds": t - t0, "call_spans": spans},
                     watch, 1.0)
    assert s["calls"] == 4 and s["slow_calls"] == 1
    assert s["gc"]["2"]["passes"] == 1 and s["gc2_ms"]
    assert s["slow_gc_ms"] == pytest.approx(s["gc"]["2"]["ms"])
    assert 4.0 <= s["harness_ms"] < 10.0
    assert s["main_cpu"] in s["affinity"]
    assert any("harness" in line for line in host.lines(s))


def test_spreads_and_parts():
    vals = [100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110, 150]
    assert sets.spread(vals) == pytest.approx(
        (108.25 - 101.75) / 105.5)
    assert sets.spread_out(vals) < sets.spread(vals)

    def one(seed, n, med_ms, slow_ms, harness_ms):
        wall = (n * med_ms + slow_ms + harness_ms) / 1e3
        return {"seed": seed, "metrics": {"r": n / wall},
                "host": {"wall_s": wall, "calls": n,
                         "slow_excess_ms": slow_ms,
                         "harness_ms": harness_ms}}

    runs = [one(1, 100, 10.0, 0.0, 1.0), one(2, 100, 11.0, 50.0, 1.0),
            one(3, 100, 10.0, 0.0, 21.0)]
    got = {seed: (s, a, b, c) for seed, s, a, b, c in sets.parts(runs, "r")}
    assert got[1] == (0, 0, 0, 0)
    s, a, b, c = got[2]
    assert s == pytest.approx(a + b + c)
    assert a == pytest.approx(100 / 11.51) and b == pytest.approx(50 / 11.51)
    assert c == pytest.approx(0)
    s, a, b, c = got[3]
    assert c == pytest.approx(s) and a == pytest.approx(0)
