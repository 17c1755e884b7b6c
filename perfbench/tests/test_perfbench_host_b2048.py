"""The traffic ``infer.host_b2048`` and its driver ``batch_infer_host``
in the cell ``cnn_gru.infer.host_b2048``, which ``BENCHMARK.json`` does
not hold yet (its runs spread past the rule that admits a cell; PERF.md
section 7): the entry it would have is added to a copy of the benchmark.
At a size a CPU test can hold, every call of the window hands the
predictor host NumPy arrays, a small run's last line with ``--trace 0``
and ``1`` is correct, and an altered answer and the fp8 control are
not."""

import argparse

import numpy as np
import pytest

import readings
import run
from core.bench import Cell, load_benchmark

NAME = "cnn_gru.infer.host_b2048"
ENTRY = {"name": NAME, "config": "cnn_gru_fsc", "traffic": "infer.host_b2048",
         "chips": 1, "why": "closed loop of B=2048 x 5 s rows (0.8-5.0 s "
         "speech) handed over as host NumPy: the 671 MB pageable copy in, "
         "then K1, the conv stage and K2"}
METRICS = ("infer_utt_per_s", "mfu.infer", "idle_share.infer",
           "call_idle_ms.infer")


def small_cell() -> Cell:
    bench = load_benchmark()
    bench["workloads"].append(ENTRY)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"].append(NAME)
    cell = Cell(NAME, bench)
    cell.traffic.update(batch=3, pool_batches=2, warmup_calls=1,
                        slice_calls=2)
    cell.bench["run_seconds"] = 0.2
    return cell


def _run(trace=0) -> dict:
    args = argparse.Namespace(workload=NAME, seed=2 ** 31 + 23, seconds=0.2,
                              trace=trace)
    return run.run(args, "cpu", small_cell())


@pytest.fixture
def calls(monkeypatch):
    """The types of the arguments of every predictor call."""
    from speech_intent_recognizer_tpu_torch.infer.predict import Predictor

    seen, orig = [], Predictor.predict_waveform_batch

    def spy(self, waveforms, lengths):
        seen.append((type(waveforms), waveforms.dtype, type(lengths),
                     lengths.dtype))
        return orig(self, waveforms, lengths)
    monkeypatch.setattr(Predictor, "predict_waveform_batch", spy)
    return seen


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_and_host_inputs(trace, calls):
    cell = small_cell()
    res = _run(trace)
    assert res["correct"] is True and res["attempted"] >= 3
    want = ({m["name"] for m in cell.per_layer()} if trace
            else {m["name"] for m in cell.end_to_end()})
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == {"infer_utt_per_s", "setup_s"}
    # the base driver's warm-up is on the device copies; from then on,
    # every call on the host arrays
    host = (np.ndarray, np.dtype(np.float32), np.ndarray,
            np.dtype(np.int32))
    pool = cell.traffic["pool_batches"] * cell.traffic["warmup_calls"]
    assert calls[pool:] and all(c == host for c in calls[pool:])


def test_an_altered_answer_is_not_correct(monkeypatch):
    from speech_intent_recognizer_tpu_torch.infer.predict import Predictor

    orig = Predictor.predict_waveform_batch

    def broken(self, waveforms, lengths):
        p = orig(self, waveforms, lengths).copy()
        p[0] = p[0, ::-1]
        return p
    monkeypatch.setattr(Predictor, "predict_waveform_batch", broken)
    assert _run()["correct"] is False


def test_control_is_not_correct():
    limit = small_cell().traffic["limits"]["logp_gap"]
    ctl = readings.reading(small_cell(), 3, True, "cpu")["checks"]
    assert ctl["logp_gap"] > limit
