"""The port's own spans and records (``utils/profiling.py``), on the CPU.

Tracing is on exactly while a ``torch.profiler`` runs: with none, a span
is one shared null context (``record_function`` is never entered) and no
record is kept.  Under a profiler the predictor's, the server's and the
trainer's spans are events of the profiler's trace, nested as the code
nests them, and the server keeps one ``utterance`` record per result line
and one ``tick`` record per timed-out wait of a drain loop."""

import asyncio
import json
import os
import re

import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu_torch.config import Config
from speech_intent_recognizer_tpu_torch.infer.predict import Predictor
from speech_intent_recognizer_tpu_torch.infer.server import (
    IntentServer, encode_chunk)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
from speech_intent_recognizer_tpu_torch.train.loop import (
    Trainer, pad_permutation)
from speech_intent_recognizer_tpu_torch.utils import profiling

PACKAGE = os.path.dirname(os.path.abspath(profiling.__file__)).rsplit(
    os.sep, 1)[0]
# the spans the benchmark's harness opens itself, matched by exact name
HARNESS_SPANS = {
    "perfbench.slice", "batch_infer.call", "StreamingRecognizer.feed",
    "BatchFinalizer.flush", "Optimizer.step", "Optimizer.step#Adam.step",
    "ServingBody", "CNNAudioGRU", "TorchGRU", "TorchGRU.backward",
    "Wav2VecServingBody", "FeatureEncoder", "Encoder"}
NARROW = dict(conv_channels=(8, 16, 16), gru_hidden=32)


@pytest.fixture(autouse=True)
def no_records():
    profiling.clear_records()
    yield
    profiling.clear_records()


@pytest.fixture(scope="module")
def predictor():
    model = CNNAudioGRU(4, fold_bn=True, **NARROW)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return Predictor(model, {f"intent_{i}": i for i in range(4)},
                     device="cpu")


def _spans(logdir) -> list:
    """(name, start, end, thread) of every span of the one trace that
    ``profiling.trace`` wrote into ``logdir``."""
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e.get("dur", 0), e.get("tid"))
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(inner, outer) -> bool:
    return (inner[3] == outer[3] and outer[1] <= inner[1]
            and inner[2] <= outer[2])


def _batch(rng, b=2, width=16384):
    x = np.zeros((b, width), np.float32)
    x[:, :12000] = 0.2 * rng.standard_normal((b, 12000))
    return x, np.full(b, 12000, np.int32)


def _utterance(rng, chunk=1024):
    """1 s of a tone in noise, then silence past the 0.4 s limit."""
    x = np.concatenate([
        (0.2 * np.sin(2 * np.pi * 300 * np.arange(16000) / 16000)
         + 0.02 * rng.standard_normal(16000)).astype(np.float32),
        np.zeros(16000, np.float32)])
    return [x[i : i + chunk] for i in range(0, len(x) - chunk, chunk)]


def _serve(predictor, sock, sessions=("a", "b")) -> list:
    """Two sessions' utterances, their chunks interleaved, through an
    ``IntentServer`` over ``sock``; returns the result lines."""
    server = IntentServer(predictor, silence_limit=0.4, drain_interval=0.01)
    chunks = [_utterance(np.random.default_rng(i)) for i in
              range(len(sessions))]

    async def run():
        srv = await server.start(socket_path=sock)
        reader, writer = await asyncio.open_unix_connection(sock)
        try:
            for step in zip(*chunks):
                for sid, c in zip(sessions, step):
                    writer.write((json.dumps(
                        {"op": "chunk", "session": sid,
                         "pcm": encode_chunk(c)}) + "\n").encode())
                await writer.drain()
            return [json.loads(await asyncio.wait_for(reader.readline(), 30))
                    for _ in sessions]
        finally:
            writer.close()
            srv.close()
            await srv.wait_closed()

    return asyncio.run(run())


def _train_step(logdir=None):
    model = CNNAudioGRU(5, **NARROW)
    model.reset_parameters(torch.Generator().manual_seed(1))
    trainer = Trainer(model, Config.from_dict({"batch_size": 4,
                                               "use_augmentation": True}),
                      num_classes=5)
    g = torch.Generator().manual_seed(2)
    feats = torch.randn(8, 64, 64, generator=g)
    labels = torch.randint(0, 5, (8,), generator=g)
    perm, weights = pad_permutation(g, 8, 4, "cpu")
    if logdir is None:
        return trainer.train_epoch(feats, labels, perm[:1], weights[:1], g)
    with profiling.trace(logdir):
        return trainer.train_epoch(feats, labels, perm[:1], weights[:1], g)


def test_without_a_profiler_no_span_is_entered_and_no_record_kept(
        predictor, tmp_path, monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    assert not profiling.tracing()
    assert profiling.span("sir.predict") is profiling.NULL
    assert profiling.stamp() is None
    predictor.predict_waveform_batch(*_batch(np.random.default_rng(0)))
    got = _serve(predictor, str(tmp_path / "s.sock"))
    assert [m["event"] for m in got] == ["result", "result"]
    _train_step()
    profiling.record("utterance", 0, "a", 1, 1, 2, 3)
    assert profiling.records("utterance") == []
    assert profiling.records("tick") == []


def test_predict_spans_nest_inside_the_call(predictor, tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        predictor.predict_waveform_batch(*_batch(np.random.default_rng(1)))
    spans = _spans(tmp_path / "t")
    (call,) = [s for s in spans if s[0] == "sir.predict"]
    for name in ("sir.predict.upload", "sir.frontend", "sir.conv",
                 "sir.gru", "sir.predict.fetch"):
        (inner,) = [s for s in spans if s[0] == name]
        assert _inside(inner, call), name
    order = [s[0] for s in sorted(spans, key=lambda s: s[1])
             if s[0] != "sir.predict"]
    assert order == ["sir.predict.upload", "sir.frontend", "sir.conv",
                     "sir.gru", "sir.predict.fetch"]


def test_server_records_and_spans_under_a_profiler(predictor, tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        got = _serve(predictor, str(tmp_path / "s.sock"))
    assert sorted(m["session"] for m in got) == ["a", "b"]
    utts = profiling.records("utterance")
    ids = [u[:3] for u in utts]
    assert sorted(i[1] for i in ids) == ["a", "b"]
    assert len(set(ids)) == len(ids) == 2
    for _conn, _sid, ordinal, t_submit, t_dispatch, t_sent in utts:
        assert ordinal == 1
        assert t_submit <= t_dispatch <= t_sent
    ticks = profiling.records("tick")
    assert ticks
    for _conn, due, woke in ticks:
        assert woke >= due - 1_000_000
    names = {s[0] for s in _spans(tmp_path / "t")}
    assert {"sir.server.message", "sir.server.tick", "sir.server.send",
            "sir.stream.feed", "sir.batcher.flush", "sir.finalize.upload",
            "sir.finalize.fetch"} <= names


def test_a_train_step_shows_its_phases(tmp_path):
    _train_step(str(tmp_path / "t"))
    spans = _spans(tmp_path / "t")
    phases = [s for s in sorted(spans, key=lambda s: s[1])
              if s[0].startswith("sir.train.")]
    assert [s[0] for s in phases] == [
        "sir.train.inputs", "sir.train.forward", "sir.train.backward",
        "sir.train.optimizer", "sir.train.metrics"]
    forward, backward = phases[1], phases[2]
    (gru,) = [s for s in spans if s[0] == "sir.gru"]
    assert _inside(gru, forward)
    grads = [s for s in spans if s[0] == "sir.gru.backward"]
    assert len(grads) == 2  # one a layer
    for g in grads:
        assert backward[1] <= g[1] and g[2] <= backward[2]


def test_program_span_names_are_not_the_harness_s():
    names = set()
    for root, _dirs, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    names |= set(re.findall(r'span\("([^"]+)"\)', fh.read()))
    assert {"sir.predict", "sir.server.tick", "sir.train.optimizer",
            "sir.w2v.encoder", "sir.w2v.transformer", "sir.w2v.relpos",
            "sir.w2v.attention"} <= names
    assert all(n.startswith("sir.") for n in names), names
    assert not names & HARNESS_SPANS


def test_records_from_outside_a_profiler_window_are_absent(predictor,
                                                           tmp_path):
    _serve(predictor, str(tmp_path / "before.sock"))
    assert profiling.records("utterance") == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert profiling.tracing()
        profiling.record("tick", 0, 1, 2)
        inside = profiling.records("tick")
    assert not profiling.tracing()
    profiling.record("tick", 0, 3, 4)
    _serve(predictor, str(tmp_path / "after.sock"))
    assert profiling.records("tick") == inside == [(0, 1, 2)]
    assert profiling.records("utterance") == []
    profiling.clear_records()
    assert profiling.records("tick") == []
