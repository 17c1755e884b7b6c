"""Batch inference: a closed loop of ``predict_waveform_batch`` calls.

Set-up draws the weights and a pool of ``pool_batches`` batches of
``batch`` rows ``width`` samples wide on the device (``core.traffic``),
builds the predictor through its public entry (``cnn_gru``: a checkpoint
file through ``Predictor.from_checkpoint``, which folds BatchNorm and
serves K1 -> conv2 / conv3 -> K2; ``wav2vec2``: ``Wav2VecPredictor`` over
the model the state loads into) and calls it ``warmup_calls`` times on
each pool batch.  The window then calls it on the pool's batches in turn
until ``seconds`` have passed; every call ends in the copy of its
probabilities to the host, so the window's wall time covers all the work
it started.  Every output is kept; after the window each is compared with
the plain reference's probabilities for its batch.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from core import compare, program, trace, traffic as gen, weights

SPANS = {
    "cnn_gru": (("", "ServingBody"), ("model", "CNNAudioGRU"),
                ("model.gru", "TorchGRU")),
    "wav2vec2": (("", "Wav2VecServingBody"),
                 ("model.wav2vec.feature_extractor", "FeatureEncoder"),
                 ("model.wav2vec.encoder", "Encoder")),
}


class Driver:
    def __init__(self, cfg: dict, traffic: dict, reference, seed: int,
                 device="cuda"):
        self.cfg, self.traffic, self.reference = cfg, traffic, reference
        self.device = torch.device(device)
        self.precision = cfg["precision"]["infer"]
        self.width = int(traffic["width"])
        self.state = weights.make_state(
            reference.weight_spec(cfg),
            gen.device_generator(seed, self.device, 0), self.device)
        self.pool = gen.batch_pool(seed, traffic["pool_batches"],
                                   traffic["batch"], self.width,
                                   traffic["min_seconds"],
                                   traffic["max_seconds"], self.device,
                                   cfg["sample_rate"])
        self.lengths = [ln.cpu().numpy() for _, ln in self.pool]
        self.predictor = program.BUILD[cfg["model"]](cfg, self.state,
                                                       self.device)
        self.predict = self.predictor.predict_waveform_batch
        self.outputs = []  # (pool index, probabilities)
        for _ in range(traffic["warmup_calls"]):
            for wf, ln in self.pool:
                self.predict(wf, ln)

    # ------------------------------------------------------------ window

    def window(self, seconds: float, profiler=None,
               min_calls: int = 1) -> dict:
        """Call the predictor in turn on the pool's batches until
        ``seconds`` have passed (and at least ``min_calls`` calls).  With
        a ``profiler`` (``core.trace.Profiler``), a slice of
        ``slice_calls`` more calls then runs under it, each call in the
        span ``batch_infer.call`` and the served model's submodules in
        spans of their own (``SPANS``)."""
        calls, t0 = 0, time.perf_counter()
        while True:
            i = calls % len(self.pool)
            self.outputs.append((i, self.predict(*self.pool[i])))
            calls += 1
            if calls >= min_calls and time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        rows = calls * self.traffic["batch"]
        failed = sum(int((~np.isfinite(p).all(axis=1)).sum())
                     for _, p in self.outputs)
        out = {"start": t0, "attempted": rows, "failed": failed,
               "seconds": wall,
               "calls": [self.lengths[c % len(self.pool)]
                         for c in range(calls)],
               "metrics": {"infer_utt_per_s": rows / wall}}
        if profiler is not None:
            body = self.predictor._fused_body()
            spans = [(body.get_submodule(path), name)
                     for path, name in SPANS[self.cfg["model"]]]
            sliced = []
            with trace.SpanHooks(spans):
                profiler.start()
                for c in range(self.traffic["slice_calls"]):
                    i = c % len(self.pool)
                    with torch.profiler.record_function("batch_infer.call"):
                        self.outputs.append((i, self.predict(*self.pool[i])))
                    sliced.append(self.lengths[i])
                out["trace"] = profiler.stop()
            out["slice"] = {"calls": sliced}
        return out

    def layer_work(self, work, lengths) -> dict:
        """``work``'s layers for one call on rows of ``lengths``."""
        return work.layers(self.cfg, self.precision, lengths, self.width)

    def call_flops(self, work, lengths) -> dict:
        return work.model_flops(self.cfg, self.precision, lengths,
                                self.width)

    # ------------------------------------------------------------- check

    def free(self) -> None:
        """Drop the program's state: the predictor and its caches."""
        self.predictor = self.predict = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        """[(name, value, limit)]: the widest log-probability gap of every
        output of the window to the reference's for its batch."""
        self.free()
        refs = [self.reference.probabilities(self.state, self.cfg, wf, ln,
                                             compare.CASTS["fp32"])
                for wf, ln in self.pool]
        gap = max((compare.logp_gap(p, refs[i]) for i, p in self.outputs),
                  default=float("inf"))
        return [("logp_gap", gap, self.traffic["limits"]["logp_gap"])]
