"""The live-streaming traffic: what each session sends, chunk by chunk.

A session is one connection that sends one chunk of ``chunk`` samples
(64 ms at 16 kHz) every 64 ms of audio time, open loop: room noise, then
utterances of ``speech_like`` separated by room noise.  Speech lengths and
gaps are whole chunks, so speech starts and ends on chunk boundaries and
the chunk at which the voice detector closes an utterance (the
``silence_chunks``-th quiet chunk after its speech) is known here.

Chunks come from pools drawn from the seed: ``speech_segments`` segments
of the longest speech (an utterance takes the first chunks of one) and
``noise_chunks`` chunks of room noise.  The client sends their bytes; the
reference reads their samples.  Session ``s`` starts ``phase[s]`` into the
first chunk period, so that sessions spread over the server's drain tick.

Every seed offers the same work at the same times: the ``sessions``
schedules (phase, speech lengths, gaps) are drawn once, from ``ARRIVALS``,
and the seed deals them to the connections in another order and draws
what they say (which speech segment, which noise chunks, and the pools).
"""

from __future__ import annotations

import math

import numpy as np

from core import traffic as gen

ARRIVALS = 0  # the generator seed of the schedules, the same for every run


def chunk_counts(p: dict) -> dict:
    """The traffic's lengths in whole chunks."""
    cs = p["chunk"] / p["sample_rate"]
    return {
        "chunk_s": cs,
        "speech": (math.ceil(p["speech_s"][0] / cs - 1e-9),
                   math.ceil(p["speech_s"][1] / cs - 1e-9)),
        "gap": (math.ceil(p["gap_s"][0] / cs - 1e-9),
                math.ceil(p["gap_s"][1] / cs - 1e-9)),
        "silence": math.ceil(p["silence_limit_s"] / cs - 1e-9),
    }


def pools(seed: int, p: dict) -> tuple:
    """(speech segments (P, longest, chunk), noise chunks (N, chunk)),
    float32."""
    c = chunk_counts(p)
    r = gen.rng(seed, 2)
    longest = c["speech"][1] * p["chunk"]
    speech = np.stack([gen.speech_like(r, longest, r.uniform(*gen.TONE_HZ))
                       for _ in range(p["speech_segments"])])
    noise = gen.room_noise(r, p["noise_chunks"] * p["chunk"])
    return (speech.reshape(p["speech_segments"], c["speech"][1], p["chunk"]),
            noise.reshape(p["noise_chunks"], p["chunk"]))


def session(seed: int, p: dict, s: int, steps: int) -> dict:
    """Session ``s``'s first ``steps`` chunks: ``chunks`` a list of
    (segment, index) for speech and (-1, noise index) for noise;
    ``closes`` the index of the chunk that closes each utterance;
    ``phase`` its start within the first chunk period, in seconds."""
    c = chunk_counts(p)
    n = p["sessions"]
    slot = int(gen.rng(seed, 999).permutation(n)[s])
    phase = (slot + 0.5) / n * c["chunk_s"]
    gap = 1 + (slot * 7919) % c["gap"][1]
    timing = gen.rng(ARRIVALS, 1000 + slot)
    r = gen.rng(seed, 1000 + s)
    chunks, closes = [], []
    while len(chunks) < steps:
        chunks += [(-1, int(i)) for i in r.integers(0, p["noise_chunks"],
                                                      gap)]
        n = int(timing.integers(c["speech"][0], c["speech"][1] + 1))
        seg = int(r.integers(0, p["speech_segments"]))
        chunks += [(seg, k) for k in range(n)]
        closes.append(len(chunks) - 1 + c["silence"])
        gap = int(timing.integers(c["gap"][0], c["gap"][1] + 1))
    return {"chunks": chunks[:steps], "phase": phase,
            "closes": [k for k in closes if k < steps]}


def samples(chunk_id, speech: np.ndarray, noise: np.ndarray) -> np.ndarray:
    seg, k = chunk_id
    return noise[k] if seg < 0 else speech[seg, k]
