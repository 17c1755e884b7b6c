"""Multi-session streaming intent server.

Counterpart of ``speech_intent_recognizer_tpu/infer/server.py``.  The
reference's live path is a single-session mic loop
(``scripts/testing.py:63-170``); this is its production form: an asyncio
server multiplexing many concurrent audio sessions over one device, each a
:class:`StreamingRecognizer` sharing the predictor's model and one
:class:`BatchFinalizer` (every end-of-utterance of a drain tick runs as one
device pass).  Results are asynchronous (``async_results=True``): the
finalize and a ``partial`` hypothesis are dispatched without blocking the
event loop, and the drain loop sends each once its
:meth:`PendingResult.ready` event says the probabilities have reached the
host, so no read of a CUDA tensor ever blocks the loop.

Traced (while a ``torch.profiler`` runs; ``utils/profiling.py``), a client
line is the span ``sir.server.message``, a drain pass that flushes or
sends is ``sir.server.tick`` and the writing of its results
``sir.server.send``; each utterance leaves the record ``utterance``
(connection, session, ordinal; t_submit, t_dispatch, t_sent) and each
timed-out wait of a drain loop the record ``tick`` (connection; due,
woke), in ``time.perf_counter_ns()``.

Wire protocol: newline-delimited JSON over a Unix or TCP socket.

  client -> {"op": "chunk",  "session": "s1", "pcm": "<base64 float32>"}
  client -> {"op": "partial","session": "s1"}   (mid-utterance hypothesis)
  client -> {"op": "flush",  "session": "s1"}   (force end-of-utterance)
  client -> {"op": "close",  "session": "s1"}
  server -> {"event": "result",  "session": "s1", "predicted_label": ...,
             "confidence": ..., "top_predictions": [...]}
  server -> {"event": "partial", ...} / {"event": "error", "message": ...}
"""

from __future__ import annotations

import asyncio
import base64
import itertools
import json
import logging
import time
from typing import Dict, Optional

import numpy as np

from speech_intent_recognizer_tpu_torch.infer.streaming import (
    BatchFinalizer, PendingResult, StreamingRecognizer)
from speech_intent_recognizer_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)


class IntentServer:
    """Session-multiplexing streaming server around one Predictor."""

    def __init__(self, predictor, chunk_size: int = 1024,
                 threshold: float = 0.01, silence_limit: float = 1.0,
                 drain_interval: float = 0.05, batch_finalize: bool = True):
        self.predictor = predictor
        self.chunk_size = chunk_size
        self.threshold = threshold
        self.silence_limit = silence_limit
        self.drain_interval = drain_interval
        # one shared batcher: the end-of-utterance work of all sessions in
        # a drain tick runs as one device pass
        self.batcher = BatchFinalizer(predictor) if batch_finalize else None
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections = itertools.count()

    def _new_recognizer(self) -> StreamingRecognizer:
        return StreamingRecognizer(
            self.predictor, chunk_size=self.chunk_size,
            threshold=self.threshold, silence_limit=self.silence_limit,
            async_results=True, batch_finalizer=self.batcher)

    # ------------------------------------------------------- one connection

    def _tick_span(self, pending: list):
        """The span ``sir.server.tick`` of a drain pass that has something
        to flush or send; an empty pass (most of them, one a connection a
        tick) gets none."""
        if profiling.tracing() and (
                (self.batcher is not None and self.batcher.queued())
                or any(item[2].ready() for item in pending)):
            return profiling.span("sir.server.tick")
        return profiling.NULL

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        conn = next(self._connections)
        sessions: Dict[str, StreamingRecognizer] = {}
        utterances: Dict[str, int] = {}  # results submitted, a session
        # (event, session_id, PendingResult, record head): the head of an
        # utterance's record is (connection, session, ordinal, t_submit)
        pending: list = []
        send_lock = asyncio.Lock()
        closed = asyncio.Event()
        interval_ns = int(self.drain_interval * 1e9)

        async def send(obj: dict) -> None:
            async with send_lock:
                writer.write((json.dumps(obj) + "\n").encode())
                await writer.drain()

        def submitted(sid: str, result) -> None:
            n = utterances[sid] = utterances.get(sid, 0) + 1
            pending.append(("result", sid, result,
                            (conn, sid, n, profiling.stamp())))

        def on_message(line: bytes) -> Optional[dict]:
            """Act on one client line; returns the reply to send now, if
            any (results go out through the drain loop)."""
            try:
                msg = json.loads(line)
                op = msg["op"]
                sid = str(msg.get("session", "default"))
            except (ValueError, KeyError, TypeError) as e:
                return {"event": "error", "message": f"bad message: {e}"}
            if op == "chunk":
                rec = sessions.get(sid)
                if rec is None:
                    rec = sessions[sid] = self._new_recognizer()
                try:
                    pcm = np.frombuffer(base64.b64decode(msg["pcm"]),
                                        np.float32)
                except (KeyError, ValueError, TypeError) as e:
                    return {"event": "error", "session": sid,
                            "message": f"bad pcm: {e}"}
                result = rec.feed(pcm)
                if result is not None:
                    submitted(sid, result)
            elif op == "partial":
                rec = sessions.get(sid)
                out = rec.partial_result() if rec is not None else None
                if out is None:
                    return {"event": "partial", "session": sid,
                            "recording": False}
                pending.append(("partial", sid, out, None))
            elif op == "flush":
                rec = sessions.get(sid)
                result = rec.flush() if rec is not None else None
                if result is not None:
                    submitted(sid, result)
            elif op == "close":
                sessions.pop(sid, None)
            else:
                return {"event": "error", "session": sid,
                        "message": f"unknown op {op!r}"}
            return None

        def deliver() -> bool:
            """Write every ready result's line; returns whether any was
            written.  An utterance's record is kept after its line."""
            ready = [item for item in pending if item[2].ready()]
            if not ready:
                return False
            with profiling.span("sir.server.send"):
                for item in ready:
                    pending.remove(item)
                PendingResult.get_all([item[2] for item in ready])
                for event, sid, r, head in ready:
                    writer.write((json.dumps({"event": event, "session": sid,
                                              **r.resolve()}) + "\n"
                                  ).encode())
                    if head is not None:
                        profiling.record("utterance", *head, r.dispatched_ns,
                                         profiling.stamp())
            return True

        async def drain_loop() -> None:
            """Push finished results without blocking reads."""
            while not closed.is_set():
                with self._tick_span(pending):
                    if self.batcher is not None:
                        self.batcher.flush()
                    wrote = deliver()
                if wrote:
                    async with send_lock:
                        await writer.drain()
                due = profiling.stamp()
                try:
                    await asyncio.wait_for(closed.wait(),
                                           timeout=self.drain_interval)
                except asyncio.TimeoutError:
                    if due is not None:
                        profiling.record("tick", conn, due + interval_ns,
                                         time.perf_counter_ns())

        drainer = asyncio.ensure_future(drain_loop())
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                with profiling.span("sir.server.message"):
                    reply = on_message(line)
                if reply is not None:
                    await send(reply)
        finally:
            closed.set()
            await drainer
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # -------------------------------------------------------------- runner

    async def start(self, socket_path: Optional[str] = None,
                    host: Optional[str] = None,
                    port: Optional[int] = None) -> asyncio.AbstractServer:
        if socket_path:
            self._server = await asyncio.start_unix_server(
                self._handle, path=socket_path)
            logger.info("intent server on unix socket %s", socket_path)
        else:
            self._server = await asyncio.start_server(
                self._handle, host or "127.0.0.1", port or 7071)
            logger.info("intent server on %s:%d", host or "127.0.0.1",
                        port or 7071)
        return self._server

    async def serve_forever(self, **kwargs) -> None:
        server = await self.start(**kwargs)
        async with server:
            await server.serve_forever()


def encode_chunk(pcm: np.ndarray) -> str:
    """Client-side helper: float32 PCM -> base64 payload."""
    return base64.b64encode(
        np.ascontiguousarray(pcm, np.float32).tobytes()).decode()
