"""The live-streaming client: ``sessions`` connections to the intent server
over a Unix socket, each sending its chunks on the clock (open loop).

    python3 stream_client.py --socket PATH --seed N --sessions S \
        --seconds T --params JSON

Run by the ``stream_server`` driver as a process of its own, so that the
load it offers does not wait on the server's event loop.  Chunk ``k`` of
session ``s`` is due at ``start + phase[s] + (k + 1) * chunk_s``, when its
audio has been captured; it is sent then, or at once if the sender is
late.  Sending stops at ``start + seconds``; the client then waits for
the result of every utterance whose closing chunk was sent, up to
``wait`` seconds, and closes.

Standard output: first a line ``{"start": t}`` once every connection is
open (``time.monotonic``, the same clock as the server's
``time.perf_counter`` on Linux), then one line with each session's results
and their arrival times, and how late the sends ran.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import heapq
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from core import stream_plan  # noqa: E402


def _message(pcm: np.ndarray) -> bytes:
    b64 = base64.b64encode(np.ascontiguousarray(pcm, np.float32).tobytes())
    return b'{"op": "chunk", "session": "s", "pcm": "' + b64 + b'"}\n'


async def _read(reader, out: list, expected: int, done: asyncio.Event,
                counter: list) -> None:
    while True:
        line = await reader.readline()
        if not line:
            return
        t = time.monotonic()
        msg = json.loads(line)
        out.append([t, msg])
        if msg.get("event") in ("result", "error"):
            counter[0] += 1
            if counter[0] >= expected:
                done.set()


async def run(args) -> dict:
    p = json.loads(args.params)
    c = stream_plan.chunk_counts(p)
    steps = int(np.ceil(args.seconds / c["chunk_s"]))
    speech, noise = stream_plan.pools(args.seed, p)
    msg_speech = [[_message(ch) for ch in seg] for seg in speech]
    msg_noise = [_message(ch) for ch in noise]
    plans = [stream_plan.session(args.seed, p, s, steps)
             for s in range(args.sessions)]
    conns = [await asyncio.open_unix_connection(args.socket, limit=1 << 22)
             for _ in plans]
    results = [[] for _ in plans]
    expected = sum(len(pl["closes"]) for pl in plans)
    done, counter = asyncio.Event(), [0]
    if expected == 0:
        done.set()
    readers = [asyncio.ensure_future(_read(r, results[s], expected, done,
                                           counter))
               for s, (r, _w) in enumerate(conns)]
    start = time.monotonic() + 0.2
    print(json.dumps({"start": start}), flush=True)
    heap = [(start + pl["phase"] + c["chunk_s"], s, 0)
            for s, pl in enumerate(plans)]
    heapq.heapify(heap)
    late = []
    while heap:
        due, s, k = heapq.heappop(heap)
        now = time.monotonic()
        if due > now:
            await asyncio.sleep(due - now)
        seg, i = plans[s]["chunks"][k]
        writer = conns[s][1]
        writer.write(msg_noise[i] if seg < 0 else msg_speech[seg][i])
        late.append(time.monotonic() - due)
        if writer.transport.get_write_buffer_size() > 1 << 20:
            await writer.drain()
        if k + 1 < steps:
            heapq.heappush(heap, (due + c["chunk_s"], s, k + 1))
    end = time.monotonic()
    try:
        await asyncio.wait_for(done.wait(), timeout=args.wait)
    except asyncio.TimeoutError:
        pass
    for _r, w in conns:
        w.close()
    for r in readers:
        r.cancel()
    await asyncio.gather(*readers, return_exceptions=True)
    lq = np.asarray(late) if late else np.zeros(1)
    return {"start": start, "end": end,
            "late_s": {"p50": float(np.percentile(lq, 50)),
                       "p95": float(np.percentile(lq, 95)),
                       "max": float(lq.max())},
            "results": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--socket", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sessions", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--wait", type=float, default=60.0)
    ap.add_argument("--params", required=True)
    args = ap.parse_args(argv)
    print(json.dumps(asyncio.run(run(args))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
