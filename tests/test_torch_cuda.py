"""The hand-written CUDA kernels on the card, against their plain PyTorch
versions on the same inputs.  Marked ``cuda``; each test skips where
``torch.cuda.is_available()`` is false.  Run on an H100 with

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU host
need not have; this file imports no JAX)."""

import json

import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu_torch.ops import frontend_kernels as fk
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    make_frontend_params, padded_samples)
from speech_intent_recognizer_tpu_torch.ops.gru import (
    TILE_ROWS, _gru_layer_plain, gru_bidirectional, gru_layer)

pytestmark = pytest.mark.cuda

WIDTH = padded_samples(80000)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from speech_intent_recognizer_tpu_torch.utils.device import require_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return require_cuda()


def _waves(lengths, seed=0):
    rng = np.random.default_rng(seed)
    buf = np.zeros((len(lengths), WIDTH), np.float32)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000
        buf[i, :n] = 0.3 * np.sin(2 * np.pi * 440 * t) \
            + 0.05 * rng.standard_normal(n)
    return torch.from_numpy(buf), torch.tensor(lengths, dtype=torch.int32)


def test_frontend_conv1_matches_plain(dev):
    """K1 vs its plain version at the bar of the reference's conv1-fusion
    test (0.05 * scale); both round the same fp32 values to bf16, so the
    share of outputs more than one bf16 step apart stays tiny."""
    wf, ln = _waves([8000, 16000, 39999, 40000, 52117, 79999, 80000, 1025,
                     512, 2, 1, 0])
    wf, ln = wf.to(dev), ln.to(dev)
    fe = make_frontend_params(device=dev)
    g = torch.Generator().manual_seed(0)
    w = (torch.randn((32, 1, 3, 3), generator=g) / 3).to(dev)
    b = (0.1 * torch.randn(32, generator=g)).to(dev)
    got = fk.frontend_conv1(wf, ln, fe, w, b).float()
    want = fk._frontend_conv1_plain(wf, ln, fe, w, b).float()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 0.05 * scale
    far = (got - want).abs() > 2.0 ** -7 * want.abs().clamp(min=1.0)
    assert float(far.float().mean()) < 1e-3


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("rows", [None, *TILE_ROWS])
@pytest.mark.parametrize("batch", [5, 64, 256, 1030, 2048])
def test_gru_layer_matches_plain(dev, dtype, tol, batch, rows):
    """fp32 within 1e-5 (the reference's kernel bar); bf16 within 1e-2:
    the same operand roundings, only the fp32 summation order differs.
    Every built tile height (None: the one the card picks), on full and
    ragged last tiles."""
    g = torch.Generator().manual_seed(batch)
    gx = torch.randn((2, 25, batch, 768), generator=g).to(dev, dtype)
    w = (0.05 * torch.randn((2, 256, 768), generator=g)).to(dev, dtype)
    bn = (0.1 * torch.randn((2, 1, 256), generator=g)).to(dev)
    got = gru_layer(gx, w, bn, rows=rows)
    want = _gru_layer_plain(gx, w, bn)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_counters_count_launches_only(dev):
    fk.frontend_conv1.launches = 0
    gru_layer.launches = 0
    wf, ln = _waves([16000, 4000])
    fe = make_frontend_params(device=dev)
    w, b = torch.zeros((32, 1, 3, 3), device=dev), torch.zeros(32, device=dev)
    fk._frontend_conv1_plain(wf.to(dev), ln.to(dev), fe, w, b)
    fk.frontend_conv1(wf.to(dev), ln.to(dev), fe, w, b)
    h = 256
    gx = torch.zeros((25, 3, 3 * h), device=dev)
    ys_f, ys_b = gru_bidirectional(gx, gx, torch.zeros((3 * h, h), device=dev),
                                   torch.zeros((3 * h, h), device=dev),
                                   torch.zeros(3 * h, device=dev),
                                   torch.zeros(3 * h, device=dev))
    assert ys_f.shape == ys_b.shape == (25, 3, h)
    assert fk.frontend_conv1.launches == 1 and gru_layer.launches == 1


def test_gru_layer_refuses_grad(dev):
    gx = torch.zeros((2, 3, 4, 768), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference only"):
        gru_layer(gx, torch.zeros((2, 256, 768), device=dev),
                  torch.zeros((2, 1, 256), device=dev))


def test_predictor_launches_k1_once_k2_twice(dev, tmp_path):
    from speech_intent_recognizer_tpu_torch.infer.predict import Predictor
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU

    model = CNNAudioGRU(num_classes=31)
    model.reset_parameters(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "m.pt")
    (tmp_path / "lm.json").write_text(json.dumps({str(i): i
                                                  for i in range(31)}))
    pred = Predictor.from_checkpoint(str(tmp_path / "m.pt"),
                                     str(tmp_path / "lm.json"), device=dev)
    cpu = Predictor.from_checkpoint(str(tmp_path / "m.pt"),
                                    str(tmp_path / "lm.json"), device="cpu")
    wf, ln = _waves([24000, 80000, 3000], seed=3)
    fk.frontend_conv1.launches = 0
    gru_layer.launches = 0
    probs = pred.predict_waveform_batch(wf, ln)
    assert (fk.frontend_conv1.launches, gru_layer.launches) == (1, 2)
    want = cpu.predict_waveform_batch(wf, ln)
    assert (probs.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(probs, want, atol=2e-2)
