"""The traffic generators give the same inputs for the same seed, other
inputs for another, and take seeds past 32 bits."""

import numpy as np
import torch

from core import stream_plan, traffic
from core.bench import load_json

BIG = 2 ** 31 + 12345


def test_batch_pool_repeats_per_seed():
    a = traffic.batch_pool(BIG, 2, 5, 4096, 0.05, 0.25, "cpu")
    b = traffic.batch_pool(BIG, 2, 5, 4096, 0.05, 0.25, "cpu")
    c = traffic.batch_pool(BIG + 1, 2, 5, 4096, 0.05, 0.25, "cpu")
    for (wa, la), (wb, lb) in zip(a, b):
        assert torch.equal(wa, wb) and torch.equal(la, lb)
    assert not torch.equal(a[0][0], c[0][0])


def test_batch_pool_rows_zero_past_their_length():
    (wf, ln), = traffic.batch_pool(7, 1, 6, 4096, 0.05, 0.25, "cpu")
    assert ln.min() >= 800 and ln.max() <= 4000
    for row, n in zip(wf, ln.tolist()):
        assert row[n:].abs().max() == 0
        assert row[:n].abs().mean() > 0.1  # far above the VAD threshold


def test_speech_like_matches_its_formula():
    r = np.random.default_rng(3)
    x = traffic.speech_like(r, 1000, 440.0)
    noise = np.random.default_rng(3).standard_normal(1000)
    t = np.arange(1000) / 16000.0
    ref = 0.25 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * noise
    np.testing.assert_allclose(x, ref.astype(np.float32), rtol=0, atol=1e-7)


def test_stream_plan_repeats_and_closes_where_the_detector_would():
    p = load_json("traffic", "stream.live.json")
    c = stream_plan.chunk_counts(p)
    assert c["silence"] == 16 and c["speech"] == (13, 63)
    assert c["gap"][0] > c["silence"]
    s1 = stream_plan.session(BIG, p, 3, 400)
    assert s1 == stream_plan.session(BIG, p, 3, 400)
    assert s1 != stream_plan.session(BIG + 1, p, 3, 400)
    speech, noise = stream_plan.pools(BIG, p)
    loud = [float(np.mean(np.abs(stream_plan.samples(cid, speech, noise))))
            > p["threshold"] for cid in s1["chunks"]]
    for k in s1["closes"]:
        quiet = loud[k - c["silence"] + 1:k + 1]
        assert not any(quiet) and loud[k - c["silence"]]


def test_stream_plan_offers_every_seed_the_same_arrivals():
    p = dict(load_json("traffic", "stream.live.json"), sessions=12)

    def arrivals(seed):
        return sorted((pl["phase"], tuple(pl["closes"])) for pl in
                      (stream_plan.session(seed, p, s, 400)
                       for s in range(p["sessions"])))

    assert arrivals(BIG) == arrivals(BIG + 1) == arrivals(5)
    assert [stream_plan.session(BIG, p, s, 400)["phase"] for s in range(12)] \
        != [stream_plan.session(BIG + 1, p, s, 400)["phase"]
            for s in range(12)]
