"""The benchmark's description and its parts, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells, their
configurations and metrics.  Each part lives in a file of its own under
``perfbench/``, found by the name that ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the traffic mix's parameters and the driver
  that runs it;
* ``drivers/<driver>.py``: the loop that drives one entry of the program;
* ``metrics/<metric>.py``: one reader per per-layer metric;
* ``work/<config>.py``: operations and bytes of each layer, from shapes;
* ``reference/<config>.py``: the plain reference.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERFBENCH)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find(entries: list, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def load_json(*parts: str) -> dict:
    with open(os.path.join(PERFBENCH, *parts)) as f:
        return json.load(f)


def load_module(*parts: str) -> ModuleType:
    """Import ``perfbench/<parts>`` by its path: names hold dots
    (``metrics/mfu.infer.py``), which an import statement cannot."""
    path = os.path.join(PERFBENCH, *parts)
    key = "perfbench_part." + "/".join(parts)
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its parts loaded."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or load_benchmark()
        self.bench = bench
        self.entry = find(bench["workloads"], name)
        self.name = name
        self.config_entry = find(bench["configs"], self.entry["config"])
        with open(os.path.join(ROOT, self.config_entry["file"])) as f:
            self.config = json.load(f)
        self.traffic = load_json("traffic", self.entry["traffic"] + ".json")
        self.chips = int(self.entry["chips"])

    def driver(self) -> ModuleType:
        return load_module("drivers", self.traffic["driver"] + ".py")

    def work(self) -> ModuleType:
        return load_module("work", self.entry["config"] + ".py")

    def reference(self) -> ModuleType:
        return load_module("reference", self.entry["config"] + ".py")

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list that move an end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric: str) -> ModuleType:
        return load_module("metrics", metric + ".py")
