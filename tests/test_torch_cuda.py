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
    log_mel_frontend_plain, make_frontend_params, padded_samples)
from speech_intent_recognizer_tpu_torch.ops.gru import (
    TILE_ROWS, _gru_layer_backward_plain, _gru_layer_plain, gru_bidirectional,
    gru_layer, gru_layer_backward)

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


def _waves(lengths, seed=0, width=WIDTH):
    rng = np.random.default_rng(seed)
    buf = np.zeros((len(lengths), width), np.float32)
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


def test_gru_layer_autograd_runs_both_kernels(dev):
    """Under autograd gru_layer launches K2 forward and K2 backward once
    each, and its gradients match autograd through the plain forward (fp32,
    the bar of tests/test_gru_pallas.py:92-94: per element for dgx,
    relative to the largest value for dW and db_hn, which sum T*B terms)."""
    g = torch.Generator().manual_seed(1)
    gx = torch.randn((2, 25, 64, 768), generator=g).to(dev)
    w = (0.05 * torch.randn((2, 256, 768), generator=g)).to(dev)
    bn = (0.1 * torch.randn((2, 1, 256), generator=g)).to(dev)
    dys = torch.randn((2, 25, 64, 256), generator=g).to(dev)
    leaves = [t.clone().requires_grad_() for t in (gx, w, bn)]
    gru_layer.launches = 0
    gru_layer_backward.launches = 0
    got = torch.autograd.grad(gru_layer(*leaves), leaves, dys)
    assert (gru_layer.launches, gru_layer_backward.launches) == (1, 1)
    ref = [t.clone().requires_grad_() for t in (gx, w, bn)]
    want = torch.autograd.grad(_gru_layer_plain(*ref), ref, dys)
    torch.testing.assert_close(got[0], want[0], rtol=2e-4, atol=2e-5)
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 2e-5 + 2e-4 * float(
            b.abs().max())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("normalize", [True, False])
def test_frontend_matches_plain(dev, normalize, out_dtype):
    """K3 vs its plain version in precompute-wide (80,000-sample) buffers:
    f32 within 2e-3 (tests/test_pallas_frontend.py:62); bf16 within one
    bf16 rounding (2**-8 relative) of the plain f32 value plus 2e-3."""
    wf, ln = _waves([8000, 16000, 39999, 40000, 52117, 79999, 80000, 1025,
                     512, 2, 1, 0], width=80000)
    wf, ln = wf.to(dev), ln.to(dev)
    fe = make_frontend_params(device=dev)
    fk.frontend.launches = 0
    got = fk.frontend(wf, ln, fe, normalize, out_dtype)
    want = log_mel_frontend_plain(wf, ln, fe, normalize)
    torch.cuda.synchronize()
    assert fk.frontend.launches == 1 and got.dtype == out_dtype
    assert torch.isfinite(got.float()).all()
    bound = 2e-3 if out_dtype == torch.float32 else \
        2.0 ** -8 * want.abs() + 2e-3
    assert bool(((got.float() - want).abs() <= bound).all())


def test_frontend_refuses_other_geometry_on_cuda(dev):
    from speech_intent_recognizer_tpu_torch.config import AudioConfig

    wf, ln = _waves([16000], width=80000)
    with pytest.raises(ValueError, match="n_mels=64"):
        fk.frontend(wf.to(dev), ln.to(dev),
                    make_frontend_params(AudioConfig(n_mels=40), dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [None, *TILE_ROWS])
@pytest.mark.parametrize("batch", [5, 64, 1030, 2048])
def test_gru_layer_backward_matches_plain(dev, dtype, batch, rows):
    """K2 backward vs its plain version at every built tile height, full
    and ragged tiles.  fp32: dgx within 2e-5 + 2e-4 * |want| per element,
    dW and db_hn within 2e-5 + 2e-4 * max|want| (they sum T*B terms in
    another order); bf16: dgx and dW within one bf16 step (2**-7 relative)
    plus that bar, db_hn (fp32) at it."""
    g = torch.Generator().manual_seed(batch)
    gx = torch.randn((2, 25, batch, 768), generator=g).to(dev, dtype)
    w = (0.05 * torch.randn((2, 256, 768), generator=g)).to(dev, dtype)
    bn = (0.1 * torch.randn((2, 1, 256), generator=g)).to(dev)
    dys = torch.randn((2, 25, batch, 256), generator=g).to(dev, dtype)
    ys = _gru_layer_plain(gx, w, bn)
    got = gru_layer_backward(gx, w, bn, ys, dys, rows=rows)
    want = _gru_layer_backward_plain(gx, w, bn, ys, dys)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype
        a, b = a.float(), b.float()
        bar = 2e-5 + 2e-4 * float(b.abs().max())
        if dtype == torch.bfloat16 and i < 2:
            assert bool(((a - b).abs() <= 2.0 ** -7 * b.abs() + bar).all())
        elif i == 0:
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
        else:
            assert float((a - b).abs().max()) <= bar


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
