"""Live recognition: ``IntentServer`` with its defaults, driven open loop by
a client process over a Unix socket.

Set-up draws the weights, builds the predictor (its fp32 folded model is
what streaming serves), builds the native streaming library where the
checkout lacks it (the featurizer's ``auto`` mode takes it), and runs the
batched finalize once at every batch size it can take (1 to the
finalizer's ``max_batch``), through the server's own finalizer and its
pinned copies to the host.  The window starts when the client
(``stream_client.py``) begins sending: ``sessions`` sessions, one
connection each, each sending a 64 ms chunk every 64 ms
(``core.stream_plan``).  An utterance's end-of-speech latency runs from
the due time of the chunk that completes ``silence_limit`` of silence
after its speech to the arrival of its result line at the client; the
95th percentile is over every utterance whose closing chunk was due in the
window, and one whose result never arrives counts as failed, at the
client's whole wait.

With a profiler, the client sends for ``slice_seconds`` more, and that
slice runs under it, with ``StreamingRecognizer.feed`` and
``BatchFinalizer.flush`` wrapped in spans of their own and the time from a
feed that returns a pending result to the flush that dispatches it
recorded.

After the client has closed, the reference works every utterance out
again from the chunks the plan says each session sent (an energy detector
with the same threshold, pre-roll and silence limit, the samples capped
at ``max_samples``) and computes its probabilities; each result line's
three probabilities are compared with the reference's for its labels.
"""

from __future__ import annotations

import asyncio
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import deque

import numpy as np
import torch

from core import compare, program, stream_plan, traffic as gen, weights
from core.bench import ROOT

CLIENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "stream_client.py")


def _ensure_native() -> None:
    """Build the program's native streaming library where the checkout
    lacks it (``native/build.sh``, into ``native/build/``)."""
    from speech_intent_recognizer_tpu_torch.data import native

    if not native.available():
        subprocess.run(["sh", os.path.join(ROOT, "native", "build.sh")],
                       check=True, stdout=subprocess.DEVNULL)


class _Wrappers:
    """``StreamingRecognizer.feed`` and ``BatchFinalizer.flush`` in spans
    of their own, and the wait of each pending result from the feed that
    returned it to the flush that dispatches it."""

    def __init__(self):
        from speech_intent_recognizer_tpu_torch.infer import streaming

        self.cls = streaming
        self.queue_s = []
        self._stamps = {}
        self._orig = None

    def install(self) -> None:
        rec, fin = self.cls.StreamingRecognizer, self.cls.BatchFinalizer
        feed, flush = rec.feed, fin.flush
        self._orig = (feed, flush)
        stamps, queue = self._stamps, self.queue_s

        def traced_feed(r, chunk):
            with torch.profiler.record_function("StreamingRecognizer.feed"):
                out = feed(r, chunk)
            if out is not None:
                stamps[id(out)] = time.perf_counter()
            return out

        def traced_flush(b):
            now = time.perf_counter()
            for entry in b._queue:
                t0 = stamps.pop(id(entry[0]), None)
                if t0 is not None:
                    queue.append(now - t0)
            with torch.profiler.record_function("BatchFinalizer.flush"):
                return flush(b)

        rec.feed, fin.flush = traced_feed, traced_flush

    def remove(self) -> None:
        if self._orig is not None:
            rec, fin = self.cls.StreamingRecognizer, self.cls.BatchFinalizer
            rec.feed, fin.flush = self._orig
            self._orig = None


class Driver:
    def __init__(self, cfg: dict, traffic: dict, reference, seed: int,
                 device="cuda"):
        from speech_intent_recognizer_tpu_torch.infer.server import (
            IntentServer)
        from speech_intent_recognizer_tpu_torch.infer.streaming import (
            PendingResult)

        self.cfg, self.traffic, self.reference = cfg, traffic, reference
        self.seed = seed
        self.device = torch.device(device)
        self.precision = cfg["precision"]["stream"]
        self.width = int(traffic["width"])
        self.state = weights.make_state(
            reference.weight_spec(cfg),
            gen.device_generator(seed, self.device, 0), self.device)
        self.predictor = program.BUILD[cfg["model"]](cfg, self.state,
                                                     self.device)
        _ensure_native()
        self.server = IntentServer(self.predictor)
        p = traffic
        if (self.server.chunk_size, self.server.threshold,
                self.server.silence_limit, self.server.drain_interval) != (
                p["chunk"], p["threshold"], p["silence_limit_s"],
                p["drain_interval_s"]):
            raise ValueError("the traffic's chunk, threshold, silence limit "
                             "or drain interval is not the server's default")
        fp, batcher = self.predictor.frontend_params, self.server.batcher
        r = gen.rng(seed, 3)
        for n in range(1, batcher.max_batch + 1):
            pending = [batcher.submit(
                (r.standard_normal((fp.target_length, fp.n_mels)) - 30)
                .astype(np.float32), 100,
                r.standard_normal((batcher.tail_max, fp.n_fft))
                .astype(np.float32), 1, self.predictor.inv_label_map)
                for _ in range(n)]
            batcher.flush()
            PendingResult.get_all(pending)
        self.results = None
        self.queue_s = []

    # ------------------------------------------------------------ window

    def window(self, seconds: float, profiler=None) -> dict:
        where = tempfile.mkdtemp(prefix="perfbench_stream_")
        try:
            return asyncio.run(self._serve(seconds, profiler,
                                           os.path.join(where, "sock")))
        finally:
            shutil.rmtree(where, ignore_errors=True)

    async def _serve(self, seconds: float, profiler, sock: str) -> dict:
        p = self.traffic
        server = await self.server.start(socket_path=sock)
        total = seconds + (p["slice_seconds"] if profiler else 0.0)
        proc = await asyncio.create_subprocess_exec(
            sys.executable, CLIENT, "--socket", sock, "--seed",
            str(self.seed), "--sessions", str(p["sessions"]), "--seconds",
            str(total), "--wait", str(p["wait_s"]), "--params",
            json.dumps(p), stdout=asyncio.subprocess.PIPE)
        try:
            start = json.loads(await proc.stdout.readline())["start"]
            out = {"start": start}
            if profiler is not None:
                wrappers = _Wrappers()
                loop = asyncio.get_running_loop()
                at = max(start + seconds - time.monotonic(), 0.0)

                def end():
                    out["trace"] = profiler.stop()
                    wrappers.remove()

                def begin():
                    wrappers.install()
                    profiler.start()
                    loop.call_later(p["slice_seconds"], end)

                loop.call_later(at, begin)
            record = json.loads(await proc.stdout.read())
            await proc.wait()
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
            server.close()
            await server.wait_closed()
        if profiler is not None:
            if "trace" not in out:
                out["trace"] = profiler.stop()
            self.queue_s = wrappers.queue_s
            wrappers.remove()
        return self._score(record, seconds, total, out)

    def _score(self, record: dict, seconds: float, total: float,
               out: dict) -> dict:
        p = self.traffic
        c = stream_plan.chunk_counts(p)
        steps = int(math.ceil(total / c["chunk_s"]))
        start, close_at = record["start"], record["start"] + seconds
        lat, failed, matched = [], 0, []
        for s in range(p["sessions"]):
            plan = stream_plan.session(self.seed, p, s, steps)
            got = [m for _t, m in record["results"][s]
                   if m.get("event") in ("result", "error")]
            arrived = [t for t, m in record["results"][s]
                       if m.get("event") in ("result", "error")]
            for i, k in enumerate(plan["closes"]):
                due = start + plan["phase"] + (k + 1) * c["chunk_s"]
                ok = i < len(got) and got[i].get("event") == "result"
                matched.append((s, i, got[i] if ok else None))
                if due > close_at:
                    continue
                if ok:
                    lat.append(arrived[i] - due)
                else:
                    failed += 1
                    lat.append(p["wait_s"])
        self.results = (steps, matched)
        late = record["late_s"]
        q = [round(float(v) * 1e3, 1)
             for v in np.percentile(lat, [50, 90, 95, 99])] if lat else []
        print(f"stream: sessions {p['sessions']} utterances {len(lat)} "
              f"failed {failed} latency p50/p90/p95/p99 {q} ms; send "
              f"late p50 {late['p50']:.4f} p95 {late['p95']:.4f} max "
              f"{late['max']:.4f} s", file=sys.stderr)
        eos = float(np.percentile(np.asarray(lat), 95)) * 1e3 if lat \
            else float(p["wait_s"]) * 1e3
        out.update(attempted=len(lat), failed=failed, late_s=late,
                   seconds=seconds, queue_s=self.queue_s,
                   metrics={"eos_p95_ms": eos})
        return out

    # ------------------------------------------------------------- check

    def free(self) -> None:
        self.server = self.predictor = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def utterances(self, steps: int) -> list:
        """Each session's utterances as the reference works them out:
        [(session, samples)] in order."""
        p = self.traffic
        c = stream_plan.chunk_counts(p)
        speech, noise = stream_plan.pools(self.seed, p)
        prior_max = max(1, int(0.5 * p["sample_rate"] / p["chunk"]))
        out = []
        for s in range(p["sessions"]):
            plan = stream_plan.session(self.seed, p, s, steps)
            prior, cur, recording, quiet = deque(maxlen=prior_max), [], \
                False, 0
            found = []
            for cid in plan["chunks"]:
                x = stream_plan.samples(cid, speech, noise)
                loud = float(np.mean(np.abs(x))) > p["threshold"]
                if not recording:
                    prior.append(x)
                    if loud:
                        recording, quiet, cur = True, 0, list(prior)
                        prior.clear()
                    continue
                cur.append(x)
                quiet = 0 if loud else quiet + 1
                if quiet >= c["silence"]:
                    found.append(np.concatenate(cur)[:p["max_samples"]])
                    recording, cur = False, []
            out.append(found)
        return out

    def _served(self) -> tuple:
        """(the reference's utterance rows as (U, width) samples and (U,)
        lengths on the device, each row's served top three, the count of
        results that never came)."""
        steps, matched = self.results
        utts = self.utterances(steps)
        rows, served, missing = [], [], 0
        for s, i, msg in matched:
            if msg is None or i >= len(utts[s]):
                missing += 1
                continue
            rows.append(utts[s][i])
            served.append(msg["top_predictions"])
        buf = np.zeros((len(rows), self.width), np.float32)
        for j, x in enumerate(rows):
            buf[j, :len(x)] = x
        ln = torch.tensor([len(x) for x in rows], dtype=torch.int64)
        return (torch.from_numpy(buf).to(self.device), ln.to(self.device),
                served, missing)

    def _gap(self, buf, ln, served, precision: str = "fp32") -> float:
        if not served:
            return 0.0
        ref = self.reference.probabilities(self.state, self.cfg, buf, ln,
                                           compare.CASTS[precision])
        gap = 0.0
        for j, top in enumerate(served):
            idx = [int(t["label"].rsplit("_", 1)[1]) for t in top]
            gap = max(gap, compare.logp_gap([t["probability"] for t in top],
                                            ref[j, idx]))
        return gap

    def check(self) -> list:
        """[(name, value, limit)]: the widest log-probability gap of the
        served probabilities to the reference's, and the utterances whose
        result never came."""
        self.free()
        buf, ln, served, missing = self._served()
        return [("logp_gap", self._gap(buf, ln, served),
                 self.traffic["limits"]["logp_gap"]),
                ("results_missing", float(missing),
                 float(self.traffic["limits"]["results_missing"]))]

    def control_check(self, precision: str) -> list:
        """``check``'s numbers with the reference at ``precision`` in the
        program's place: its own top three of every utterance the window
        served, against the float32 reference."""
        self.free()
        buf, ln, served, missing = self._served()
        low = self.reference.probabilities(self.state, self.cfg, buf, ln,
                                           compare.CASTS[precision])
        inv = {v: k for k, v in program.label_map(
            self.cfg["num_classes"]).items()}
        tops = [[{"label": inv[int(i)], "probability": float(row[i])}
                 for i in np.argsort(row)[::-1][:3]] for row in low]
        return [("logp_gap", self._gap(buf, ln, tops),
                 self.traffic["limits"]["logp_gap"]),
                ("results_missing", float(missing),
                 float(self.traffic["limits"]["results_missing"]))]
