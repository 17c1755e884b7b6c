"""The cell ``wavlm_large.infer.b64`` at a size a CPU test can hold: its
plain reference against the program, the TF32 control and the faults of
the relative position bias (``wavlm_faults``) not correct, a small run's
last line with ``--trace 0`` and ``1``, and the work counted by hand."""

import argparse

import pytest

import readings
import run
from core import compare, program, traffic, weights
from core.bench import Cell
from tiny_cells import SECONDS, small_cell as tiny
from wavlm_faults import FAULTS

NAME = "wavlm_large.infer.b64"


def small_cell() -> Cell:
    cell = tiny(NAME)
    cell.bench["run_seconds"] = SECONDS[NAME]
    return cell


def _run(trace=0) -> dict:
    args = argparse.Namespace(workload=NAME, seed=2 ** 31 + 21,
                              seconds=SECONDS[NAME], trace=trace)
    return run.run(args, "cpu", small_cell())


def test_reference_matches_the_program():
    cell = small_cell()
    cfg, ref = cell.config, cell.reference()
    state = weights.make_state(ref.weight_spec(cfg),
                               traffic.device_generator(8, "cpu"), "cpu")
    pred = program.BUILD["wav2vec2"](cfg, state, "cpu")
    assert pred.model.config.model_type == "wavlm"
    (wf, ln), = traffic.batch_pool(8, 1, 3, 16000, 0.3, 1.0, "cpu")
    want = pred.predict_waveform_batch(wf, ln)
    got = ref.probabilities(state, cfg, wf, ln, compare.CASTS["fp32"])
    # float32 on both sides, other summation orders: 1e-5 is the base
    # model's bar (test_perfbench_reference.py)
    assert compare.logp_gap(got, want) < 1e-5


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(trace):
    cell = small_cell()
    res = _run(trace)
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert res["correct"] is True and res["attempted"] >= 3
    want = ({m["name"] for m in cell.per_layer()} if trace
            else {m["name"] for m in cell.end_to_end()})
    if trace:
        # the CPU's trace holds no kernel: only the host's metrics read
        assert {"relpos_ms.infer", "attention_roofline.infer"} <= want
        assert set(res["metrics"]) <= want
        assert {"busy_s", "window_s"} <= set(res["device"])
    else:
        assert set(res["metrics"]) == want == {"infer_utt_per_s", "setup_s"}


def test_control_is_not_correct():
    limit = small_cell().traffic["limits"]["logp_gap"]
    prog = readings.reading(small_cell(), 3, False, "cpu")["checks"]
    ctl = readings.reading(small_cell(), 3, True, "cpu")["checks"]
    assert prog["logp_gap"] <= limit < ctl["logp_gap"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_of_the_bias_is_not_correct(fault):
    with FAULTS[fault]():
        res = _run()
    assert res["correct"] is False
    assert res["checks"]["logp_gap"]["value"] > \
        res["checks"]["logp_gap"]["limit"]


def test_work_per_utterance():
    cell = Cell(NAME)
    w = cell.work().layers(cell.config, "fp32", [80000], 80000)
    t, h, f, heads, nl = 249, 1024, 4096, 16, 24
    assert w["encoder"]["flops"]["fp32"] == pytest.approx(24.535e9, rel=1e-4)
    core = 4 * t * t * h + 2 * heads * t * t
    layer = 8 * t * h * h + 2 * t * h * 8 + core + 4 * t * h * f
    pos = 2 * h * 64 * 128 * t
    assert w["transformer"]["flops"]["fp32"] == pos + nl * layer
    assert w["attention"]["flops"]["fp32"] == nl * core
    assert w["attention"]["bytes"] == nl * (4 * t * h * 4 + heads * t * 4
                                           + 4 + 320 * heads * 4)
    total = sum(cell.work().model_flops(cell.config, "fp32", [80000],
                                        80000).values())
    # the four disjoint layers; the attention core is inside the
    # transformer's count and not added again
    assert total == pytest.approx(185.6e9, rel=1e-3)
    assert total == sum(w[k]["flops"]["fp32"] for k in
                        ("encoder", "projection", "transformer", "head"))
