"""Faults of WavLM's gated relative position bias, planted in the program
(``models/wav2vec_backbone.py``) for as long as each context lasts:

* ``no_bias``: the scores get the padding bias alone;
* ``gate_one``: every gate reads 1, so the bias is ungated;
* ``gate_keys``: each gate applied along the keys instead of the queries;
* ``unsigned_buckets``: the bucket table without its sign half, so that a
  key r frames ahead shares a bucket with one r frames behind.

Each must come out not correct in the cell ``wavlm_large.infer.b64``.  On
the card, as ``readings.py`` takes its readings, with these faults among
its ``--fault`` choices::

    python3 perfbench/tests/wavlm_faults.py --workload wavlm_large.infer.b64 \\
        --fault no_bias --fault-seeds 1 2 3
"""

from __future__ import annotations

import contextlib
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _backbone():
    from speech_intent_recognizer_tpu_torch.models import wav2vec_backbone

    return wav2vec_backbone


def no_bias():
    attention = _backbone().Attention
    return _patched(attention, "gated_bias",
                    lambda self, y, position_bias, attn_bias: attn_bias)


def gate_one():
    import torch

    attention = _backbone().Attention

    def ones(self, y):
        return torch.ones(y.shape[0], self.n_heads, y.shape[1], 1,
                          device=y.device)
    return _patched(attention, "relpos_gate", ones)


def gate_keys():
    attention = _backbone().Attention
    gate = attention.relpos_gate
    return _patched(attention, "relpos_gate",
                    lambda self, y: gate(self, y).transpose(-1, -2))


def unsigned_buckets():
    backbone = _backbone()
    table = backbone.relative_position_buckets
    return _patched(backbone, "relative_position_buckets",
                    lambda t, nb, md: table(t, nb, md) % (nb // 2))


FAULTS = {"no_bias": no_bias, "gate_one": gate_one, "gate_keys": gate_keys,
          "unsigned_buckets": unsigned_buckets}


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    sys.path.insert(0, os.path.dirname(HERE))
    import readings

    readings.FAULTS.update(FAULTS)
    readings.main()
