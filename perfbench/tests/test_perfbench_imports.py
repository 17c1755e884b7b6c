"""No module a run or a reference imports is JAX's or the JAX package's,
compared by whole top-level names (the program's own name starts with the
JAX package's), and the references import nothing of the program."""

import ast
import glob
import json
import os
import subprocess
import sys

from core.bench import PERFBENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "speech_intent_recognizer_tpu"}
PROGRAM = "speech_intent_recognizer_tpu_torch"


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join([PERFBENCH, ROOT])))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = """
import argparse, sys
sys.path.insert(0, 'perfbench/tests')
import run
from tiny_cells import small_cell
for name in ('cnn_gru.infer.b2048', 'w2v2_base.infer.b64'):
    for trace in (0, 1):
        run.run(argparse.Namespace(workload=name, seed=3, seconds=0.2,
                                   trace=trace), 'cpu', small_cell(name))
from core.bench import Cell, load_benchmark
for w in load_benchmark()['workloads']:
    c = Cell(w['name'])
    c.driver(); c.work(); c.reference()
    for m in c.per_layer():
        c.reader(m['name'])
import readings
"""
    loaded = _loaded(code)
    assert PROGRAM in loaded
    assert not loaded & FORBIDDEN


def test_references_import_nothing_of_the_program():
    code = """
import glob, importlib.util
for path in sorted(glob.glob('perfbench/reference/*.py')):
    spec = importlib.util.spec_from_file_location('ref_' + path, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
"""
    loaded = _loaded(code)
    assert not loaded & (FORBIDDEN | {PROGRAM})
    for path in glob.glob(os.path.join(PERFBENCH, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] in {"__future__", "math", "numpy",
                                           "torch"}, (path, n)


def test_run_refuses_without_a_card_and_names_what_it_found():
    import run

    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "cnn_gru.infer.b2048", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2 and out.stdout.strip() == ""
    sys.modules["jaxlib.xla_client"] = sys.modules["os"]
    try:
        assert run.forbidden_modules() == ["jaxlib"]
    finally:
        del sys.modules["jaxlib.xla_client"]
