"""A run whose timed path is broken underneath comes out not correct: the
look for a card is skipped, the rest of the run is driven on the CPU at a
small size, and the fault is planted in the program's own entry.

* an answer altered where it is produced: two classes' probabilities of
  one row swapped (batch cells), the finalize's rows rolled by a class
  (the streaming cell);
* half of the batch left out: the program answers the first half's rows
  and repeats them for the rest (batch cells); the loss takes the mean
  over the first half's rows (training, ``readings.half_batch``);
* a step that returns its state unchanged (training).
"""

import argparse

import numpy as np
import pytest
import torch

import readings
import run
from tiny_cells import SECONDS, small_cell

BATCH = ["cnn_gru.infer.b2048", "w2v2_base.infer.b64"]


def _run(name: str) -> dict:
    args = argparse.Namespace(workload=name, seed=2 ** 31 + 11,
                              seconds=SECONDS.get(name, 0.5), trace=0)
    return run.run(args, "cpu", small_cell(name))


def _patch_predict(monkeypatch, alter):
    from speech_intent_recognizer_tpu_torch.infer.predict import Predictor

    orig = Predictor.predict_waveform_batch

    def broken(self, waveforms, lengths):
        return alter(self, orig, waveforms, lengths)
    monkeypatch.setattr(Predictor, "predict_waveform_batch", broken)


@pytest.mark.parametrize("name", BATCH)
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    def alter(self, orig, wf, ln):
        p = orig(self, wf, ln).copy()
        hi, lo = np.argmax(p[0]), np.argmin(p[0])
        p[0, [hi, lo]] = p[0, [lo, hi]]
        return p
    _patch_predict(monkeypatch, alter)
    res = _run(name)
    assert res["correct"] is False
    assert res["checks"]["logp_gap"]["value"] > \
        res["checks"]["logp_gap"]["limit"]


@pytest.mark.parametrize("name", BATCH)
def test_half_the_batch_left_out_is_not_correct(name, monkeypatch):
    def alter(self, orig, wf, ln):
        half = max(1, wf.shape[0] // 2)
        p = orig(self, wf[:half], ln[:half])
        return p[np.arange(wf.shape[0]) % half]
    _patch_predict(monkeypatch, alter)
    assert _run(name)["correct"] is False


def test_an_altered_stream_result_is_not_correct(monkeypatch):
    from speech_intent_recognizer_tpu_torch.infer import streaming

    orig = streaming.fused_finalize

    def broken(*args, **kwargs):
        return torch.roll(orig(*args, **kwargs), 1, dims=1)
    monkeypatch.setattr(streaming, "fused_finalize", broken)
    res = _run("cnn_gru.stream.live")
    assert res["correct"] is False
    assert res["checks"]["results_missing"]["value"] == 0


def test_a_training_step_on_half_the_batch_is_not_correct():
    with readings.half_batch():
        assert _run("cnn_gru.train.b1024")["correct"] is False


def test_a_training_step_that_changes_nothing_is_not_correct(monkeypatch):
    from speech_intent_recognizer_tpu_torch.train.state import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self: None)
    res = _run("cnn_gru.train.b1024")
    assert res["correct"] is False
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)
