"""``BENCHMARK.json`` against the benchmark's contract, every part it
names found by name, and the last line of a run at a small size on the
CPU (the look for a card skipped)."""

import argparse
import json
import os
import re

import pytest

import run
from core.bench import PERFBENCH, ROOT, load_benchmark
from tiny_cells import SECONDS, small_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in load_benchmark()["workloads"]]


def test_benchmark_keys_names_and_parts():
    b = load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["reduced"] == []
        assert c["file"].startswith("perfbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
        for part in ("work", "reference"):
            assert os.path.exists(os.path.join(PERFBENCH, part,
                                               c["name"] + ".py"))
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and w["config"] in configs
        used.add(w["config"])
        with open(os.path.join(PERFBENCH, "traffic",
                               w["traffic"] + ".json")) as f:
            driver = json.load(f)["driver"]
        assert os.path.exists(os.path.join(PERFBENCH, "drivers",
                                           driver + ".py"))
    assert used == set(configs)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(PERFBENCH, "metrics",
                                           m["name"] + ".py"))
        for cell in m["workloads"]:
            mv = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
            assert cell in mv.get("workloads", CELLS)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(name, trace):
    cell = small_cell(name)
    args = argparse.Namespace(workload=name, seed=2 ** 31 + 7,
                              seconds=SECONDS.get(name, 1.0), trace=trace)
    res = run.run(args, "cpu", cell)
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1
    # the training cell's loss limit holds a mean over 1,024 rows; the
    # small cell's 64-row mean can read past it, which the control test
    # covers on a seed where it does not
    assert res["correct"] is True or name == "cnn_gru.train.b1024"
    want = ({m["name"] for m in cell.per_layer()} if trace
            else {m["name"] for m in cell.end_to_end()})
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(res["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(res))
