"""Batch inference from host memory: ``batch_infer``'s closed loop, each
call handed NumPy arrays.

Set-up is ``batch_infer``'s (the weights and the pool drawn on the device
from the seed, the predictor, its warm-up); then each pool batch is copied
once to host NumPy float32 in pageable memory and its lengths to host
int32, and the warm-up calls run again on those.  In the window each call
passes one batch's host arrays to ``predict_waveform_batch``, which copies
them to the device inside its ``sir.predict.upload`` span, as for a caller
that decodes recorded commands on the host.  The check is
``batch_infer``'s: every output against the reference's probabilities for
the device copy of its batch.
"""

from __future__ import annotations

from core.bench import load_module

batch_infer = load_module("drivers", "batch_infer.py")


class Driver(batch_infer.Driver):
    def __init__(self, cfg: dict, traffic: dict, reference, seed: int,
                 device="cuda"):
        super().__init__(cfg, traffic, reference, seed, device)
        self.host = {id(wf): (wf.cpu().numpy(), ln.cpu().numpy())
                     for wf, ln in self.pool}
        self._call = self.predictor.predict_waveform_batch
        self.predict = self._from_host
        for _ in range(traffic["warmup_calls"]):
            for wf, ln in self.pool:
                self.predict(wf, ln)

    def _from_host(self, wf, ln):
        """The predictor called on the host copies of the pool batch
        ``(wf, ln)``."""
        return self._call(*self.host[id(wf)])

    def free(self) -> None:
        self._call = None
        super().free()
