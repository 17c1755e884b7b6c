"""The port's remaining host modules against the JAX package's:
``ops/resample.resample_torch`` against ``resample_jax`` and
``resample_np`` (rtol 1e-4 / atol 1e-5, ``tests/test_audio_io.py:122-127``);
``data/prefetch.device_prefetch`` (order, buffer sizes 1-3, empty and
short iterators) and ``Wav2VecTrainer``'s epoch through it (losses equal
to the same epoch with synchronous copies); ``trace`` /
``trace_annotation``; and ``utils/diagnostics``."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speech_intent_recognizer_tpu.ops.resample import resample_jax
from speech_intent_recognizer_tpu_torch import utils
from speech_intent_recognizer_tpu_torch.data.audio_io import save_wav
from speech_intent_recognizer_tpu_torch.data.prefetch import device_prefetch
from speech_intent_recognizer_tpu_torch.ops import resample_np, resample_torch
from speech_intent_recognizer_tpu_torch.utils import diagnostics


@pytest.mark.parametrize("orig,new", [(24000, 16000), (44100, 16000),
                                      (8000, 16000), (16000, 16000)])
@pytest.mark.parametrize("batched", [False, True])
def test_resample_torch_matches_jax_and_numpy(orig, new, batched):
    rng = np.random.default_rng(orig)
    x = rng.standard_normal((3, 12001) if batched else 12001).astype(
        np.float32)
    got = resample_torch(torch.from_numpy(x), orig, new)
    assert got.dtype == torch.float32
    got = got.numpy()
    want = np.asarray(resample_jax(jnp.asarray(x), orig, new))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, resample_np(x, orig, new), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("buffer_size", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 2, 7])
def test_device_prefetch_yields_batches_in_order(buffer_size, n):
    batches = [(np.full((2, 3), i, np.float32),
                {"y": torch.tensor([i, -i])}) for i in range(n)]
    got = list(device_prefetch(iter(batches), buffer_size=buffer_size,
                               device="cpu"))
    assert len(got) == n
    for i, (x, d) in enumerate(got):
        assert isinstance(x, torch.Tensor) and x.shape == (2, 3)
        assert torch.equal(x, torch.full((2, 3), float(i)))
        assert torch.equal(d["y"], torch.tensor([i, -i]))
    # without a device: NumPy arrays become tensors, tensors pass through
    t = torch.arange(3)
    assert list(device_prefetch([t], 2))[0] is t


def test_device_prefetch_passes_through_off_the_card():
    """Off the card nothing is copied ahead: one batch pulled a step."""
    pulled = []

    def source():
        for i in range(5):
            pulled.append(i)
            yield torch.tensor(i)

    it = device_prefetch(source(), buffer_size=2, device="cpu")
    assert int(next(it)) == 0 and pulled == [0]
    assert [int(t) for t in it] == [1, 2, 3, 4]


def test_wav2vec_epoch_equal_to_synchronous_copies(tmp_path, monkeypatch):
    """One epoch of the tiny wav2vec recipe through ``device_prefetch`` and
    through the synchronous copies it replaced: the same losses, bit for
    bit, and the same weights."""
    from speech_intent_recognizer_tpu_torch.models import wav2vec as pw
    from speech_intent_recognizer_tpu_torch.train import (
        wav2vec_trainer as wt)

    rng = np.random.default_rng(0)
    paths = []
    for i in range(10):
        m = int(rng.integers(2000, 6000))
        x = (0.3 * np.sin(2 * np.pi * (300 + 200 * (i % 3))
                          * np.arange(m) / 16000)
             + 0.05 * rng.standard_normal(m)).astype(np.float32)
        paths.append(str(tmp_path / f"{i}.wav"))
        save_wav(paths[-1], x, 16000)
    labels = [i % 3 for i in range(10)]

    def epoch():
        model = pw.init_wav2vec(pw.Wav2VecIntent(pw.small_wav2vec_config(
            hidden_size=32, num_layers=1), 3), 0)
        trainer = wt.Wav2VecTrainer(model, wt.create_wav2vec_optimizer(
            model.parameters(), lr=1e-3), 3, max_length=4000)
        out = trainer.fit(paths[:8], labels[:8], paths[8:], labels[8:],
                          epochs=1, batch_size=4, seed=0,
                          log=lambda m: None)
        return out["history"], model.state_dict()

    hist, state = epoch()

    def synchronous(host, buffer_size, device):
        for x, mask, y in host:
            yield (torch.from_numpy(x).to(device),
                   torch.from_numpy(mask).to(device),
                   torch.from_numpy(y).to(device, torch.int64))

    monkeypatch.setattr(wt, "device_prefetch", synchronous)
    want_hist, want_state = epoch()
    for got, want in zip(hist, want_hist):
        assert set(got) == set(want)
        for key in set(got) - {"seconds"}:
            assert got[key] == want[key], key
    for name, t in want_state.items():
        assert torch.equal(state[name], t), name


def test_trace_names_the_annotated_region(tmp_path):
    with utils.trace(str(tmp_path / "trace")):
        with utils.trace_annotation("sir_annotated_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "sir_annotated_region" for e in events)


def test_diagnostics(capsys):
    assert diagnostics.optimizer_walkthrough(steps=20)["ok"]
    a = diagnostics.optimizer_walkthrough(steps=5, seed=7)
    assert a == diagnostics.optimizer_walkthrough(steps=5, seed=7)
    assert diagnostics.device_smoke_test(size=64)
    stats = diagnostics.stress_test(seconds=0.05, size=64)
    assert stats["matmuls"] >= 50 and stats["tflops"] > 0
    utils.print_device_info()
    out = capsys.readouterr().out
    assert "devices" in out and "optimizer walkthrough: OK" in out
    assert set(utils.__all__) == {
        "device_memory_stats", "device_smoke_test",
        "print_device_info", "trace", "trace_annotation"}
