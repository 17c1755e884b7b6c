"""The port's streaming intent server: the four cases of
tests/test_server.py over a Unix socket (end-to-end result, agreement with
the direct recognizer within 1e-5, two isolated sessions, flush / partial /
error messages), on a narrow model on the CPU; and a ``partial`` sent only
once its ``PendingResult`` is ready."""

import asyncio
import json

import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu_torch.infer.predict import Predictor
from speech_intent_recognizer_tpu_torch.infer.server import (
    IntentServer, encode_chunk)
from speech_intent_recognizer_tpu_torch.infer.streaming import (
    PendingResult, StreamingRecognizer)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU


def _speech_like(rng, n, amp=0.2):
    return (amp * np.sin(2 * np.pi * 300 * np.arange(n) / 16000)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def predictor():
    model = CNNAudioGRU(4, conv_channels=(8, 16, 16), gru_hidden=32,
                        fold_bn=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return Predictor(model, {f"intent_{i}": i for i in range(4)},
                     device="cpu")


async def _jsonl_client(path):
    reader, writer = await asyncio.open_unix_connection(path)

    async def send(obj):
        writer.write((json.dumps(obj) + "\n").encode())
        await writer.drain()

    async def recv(timeout=30.0):
        line = await asyncio.wait_for(reader.readline(), timeout)
        assert line, "server closed the connection"
        return json.loads(line)

    return send, recv, writer


def _stream_utterance(rng, chunk=1024):
    """1 s of speech + enough silence to trip the 0.4 s silence limit."""
    x = np.concatenate([_speech_like(rng, 16000),
                        np.zeros(16000, np.float32)])
    return [x[i : i + chunk] for i in range(0, len(x) - chunk, chunk)]


async def _session(server, sock, script):
    """Start the server, run ``script(send, recv)`` as a client, stop."""
    srv = await server.start(socket_path=sock)
    send, recv, writer = await _jsonl_client(sock)
    try:
        return await script(send, recv)
    finally:
        writer.close()
        srv.close()
        await srv.wait_closed()


def test_end_to_end_result(predictor, tmp_path):
    server = IntentServer(predictor, silence_limit=0.4)
    chunks = _stream_utterance(np.random.default_rng(1))

    async def script(send, recv):
        for c in chunks:
            await send({"op": "chunk", "session": "a",
                        "pcm": encode_chunk(c)})
        return await recv()

    msg = asyncio.run(_session(server, str(tmp_path / "sir.sock"), script))
    assert msg["event"] == "result" and msg["session"] == "a"
    assert msg["predicted_label"] in predictor.label_map
    assert 0.0 < msg["confidence"] <= 1.0
    probs = [p["probability"] for p in msg["top_predictions"]]
    assert probs == sorted(probs, reverse=True)


def test_matches_direct_recognizer(predictor, tmp_path):
    chunks = _stream_utterance(np.random.default_rng(2))
    direct = StreamingRecognizer(predictor, silence_limit=0.4)
    direct_result = None
    for c in chunks:
        r = direct.feed(c)
        if r is not None:
            direct_result = r
    assert direct_result is not None
    server = IntentServer(predictor, silence_limit=0.4)

    async def script(send, recv):
        for c in chunks:
            await send({"op": "chunk", "session": "x",
                        "pcm": encode_chunk(c)})
        return await recv()

    msg = asyncio.run(_session(server, str(tmp_path / "sir2.sock"), script))
    assert msg["predicted_label"] == direct_result["predicted_label"]
    assert abs(msg["confidence"] - direct_result["confidence"]) < 1e-5


def test_two_sessions_isolated(predictor, tmp_path):
    """Interleaved chunks of two sessions give two results, one each."""
    server = IntentServer(predictor, silence_limit=0.4)
    ca = _stream_utterance(np.random.default_rng(3))
    cb = _stream_utterance(np.random.default_rng(99))

    async def script(send, recv):
        for a, b in zip(ca, cb):
            await send({"op": "chunk", "session": "a",
                        "pcm": encode_chunk(a)})
            await send({"op": "chunk", "session": "b",
                        "pcm": encode_chunk(b)})
        return [await recv(), await recv()]

    got = asyncio.run(_session(server, str(tmp_path / "sir3.sock"), script))
    assert {m["session"] for m in got} == {"a", "b"}
    assert all(m["event"] == "result" for m in got)


def test_flush_partial_and_errors(predictor, tmp_path):
    server = IntentServer(predictor, silence_limit=10.0)  # never automatic
    speech = _speech_like(np.random.default_rng(4), 8192)

    async def script(send, recv):
        await send({"op": "nope", "session": "z"})
        err = await recv()
        await send({"op": "chunk", "session": "z", "pcm": "YWJj"})  # 3 bytes
        bad_pcm = await recv()
        for i in range(0, 8192, 1024):
            await send({"op": "chunk", "session": "z",
                        "pcm": encode_chunk(speech[i : i + 1024])})
        await send({"op": "partial", "session": "z"})
        partial = await recv()
        await send({"op": "flush", "session": "z"})
        result = await recv()
        await send({"op": "partial", "session": "z"})
        idle = await recv()
        return err, bad_pcm, partial, result, idle

    err, bad_pcm, partial, result, idle = asyncio.run(
        _session(server, str(tmp_path / "sir4.sock"), script))
    assert err["event"] == "error" and "unknown op" in err["message"]
    assert bad_pcm["event"] == "error" and "bad pcm" in bad_pcm["message"]
    assert partial["event"] == "partial"
    assert partial["predicted_label"] in predictor.label_map
    assert result["event"] == "result"
    assert result["predicted_label"] in predictor.label_map
    assert idle == {"event": "partial", "session": "z", "recording": False}


class _SlowPartial(PendingResult):
    """A partial hypothesis whose device work lands on the third poll; the
    server must not read it before."""

    polls = 0

    def ready(self):
        self.polls += 1
        return self.polls >= 3 and super().ready()

    def _materialize(self):
        assert self.polls >= 3, "partial read before its copy landed"
        super()._materialize()


def test_partial_waits_for_ready(predictor, tmp_path, monkeypatch):
    """The ``partial`` op goes through the drain loop: the server polls
    ``ready()`` and sends the hypothesis only once it says so, without a
    blocking read on the event loop; the event carries the direct
    recognizer's hypothesis."""
    speech = _speech_like(np.random.default_rng(5), 8192)
    direct = StreamingRecognizer(predictor, silence_limit=10.0)
    for i in range(0, 8192, 1024):
        direct.feed(speech[i : i + 1024])
    want = direct.partial_result()
    slow, original = [], StreamingRecognizer.partial_result

    def partial_result(self):
        out = original(self)
        assert isinstance(out, PendingResult)
        slow.append(_SlowPartial(out._fetch.host, out._inv))
        return slow[-1]

    monkeypatch.setattr(StreamingRecognizer, "partial_result",
                        partial_result)
    server = IntentServer(predictor, silence_limit=10.0,
                          drain_interval=0.01)

    async def script(send, recv):
        for i in range(0, 8192, 1024):
            await send({"op": "chunk", "session": "p",
                        "pcm": encode_chunk(speech[i : i + 1024])})
        await send({"op": "partial", "session": "p"})
        return await recv()

    msg = asyncio.run(_session(server, str(tmp_path / "sir5.sock"), script))
    assert slow and slow[0].polls >= 3
    assert msg["event"] == "partial" and msg["session"] == "p"
    assert msg["predicted_label"] == want["predicted_label"]
    assert abs(msg["confidence"] - want["confidence"]) < 1e-5
