"""The port's voice activity detection (``infer/vad.py``: ``EnergyVAD``,
``VADSegmenter``) against the JAX package's on seeded random streams:
bursts of tone and noise between stretches of quiet at levels around the
threshold, chunks of 256-1600 samples, thresholds 0.005-0.05, random
silence limits and pre-roll.  Every chunk's speech decision, the
``recording`` state after it, each finished utterance (sample for sample)
and the end-of-stream flush are equal."""

import numpy as np
import pytest

from speech_intent_recognizer_tpu.infer import vad as jax_vad
from speech_intent_recognizer_tpu_torch.infer import vad


def _stream(rng, threshold):
    """Alternating quiet and bursts; levels spread around ``threshold``
    (mean |x| of a Gaussian is 0.8 of its std)."""
    parts = []
    for _ in range(int(rng.integers(2, 7))):
        n = int(rng.integers(500, 24000))
        level = threshold * float(rng.choice([0.05, 0.5, 0.9, 1.1, 2.0, 20.0]))
        if rng.random() < 0.5:
            t = np.arange(n) / 16000
            x = level * np.sqrt(2) * np.sin(
                2 * np.pi * float(rng.uniform(100, 3000)) * t)
        else:
            x = level * 1.25 * rng.standard_normal(n)
        parts.append(x.astype(np.float32))
    return np.concatenate(parts)


@pytest.mark.parametrize("seed", range(50))
def test_segmenter_matches_jax(seed):
    rng = np.random.default_rng(1000 + seed)
    chunk = int(rng.integers(256, 1601))
    kw = dict(chunk_size=chunk, threshold=float(rng.uniform(0.005, 0.05)),
              silence_limit=float(rng.choice([0.1, 0.3, 0.5, 1.0])),
              prior_recording=float(rng.choice([0.0, 0.1, 0.25, 0.5])))
    mine, theirs = vad.VADSegmenter(**kw), jax_vad.VADSegmenter(**kw)
    x = _stream(rng, kw["threshold"])
    got, want = [], []
    for i in range(0, len(x), chunk):
        c = x[i:i + chunk]
        assert vad.EnergyVAD(kw["threshold"]).is_speech(c) == \
            jax_vad.EnergyVAD(kw["threshold"]).is_speech(c)
        a, b = mine.feed(c), theirs.feed(c)
        assert (a is None) == (b is None), i
        if a is not None:
            got.append(a)
            want.append(b)
        assert mine.recording == theirs.recording, i
    got.append(mine.flush())
    want.append(theirs.flush())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
