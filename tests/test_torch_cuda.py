"""The hand-written CUDA kernels on the card, against their plain PyTorch
versions on the same inputs.  Marked ``cuda``; each test skips where
``torch.cuda.is_available()`` is false.  Run on an H100 with

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU host
need not have; this file imports no JAX)."""

import functools
import json

import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu_torch.ops import frontend_kernels as fk
from speech_intent_recognizer_tpu_torch.ops.conv23 import (
    _conv23_plain, conv23, conv23_operands)
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    log_mel_frontend, log_mel_frontend_plain, make_frontend_params,
    padded_samples)
from speech_intent_recognizer_tpu_torch.ops import gru as gru_ops
from speech_intent_recognizer_tpu_torch.ops.gru import (
    CLUSTER_ROWS, CLUSTER_SIZE, MMA_ROWS, MMA_ROWS_BACKWARD, TILE_ROWS, Plan,
    _gru_layer_backward_plain, _gru_layer_plain, gru_bidirectional,
    gru_layer, gru_layer_backward, gru_layer_btc, picked_plan)

from speech_intent_recognizer_tpu_torch.ops.pool_epilogue import (
    _bias_relu_pool2_plain, bias_relu_pool2)
from speech_intent_recognizer_tpu_torch.ops import bn_pool
from speech_intent_recognizer_tpu_torch.ops.bn_pool import _col

pytestmark = pytest.mark.cuda

WIDTH = padded_samples(80000)
# K1 and its plain version round the same fp32 values to bf16: outputs more
# than one bf16 step apart come only from summation-order ties
K1_FAR_SHARE = 1e-4
# K2 and K2T against their plain versions, (batch, steps, weights): full and
# ragged tiles of every height, T = 1 and a T past the model's 25; weights
# "seeded" (0.05 N(0, 1)) or "checkpoint" (the recurrent weights and n-gate
# bias of a seeded full-width model's first GRU layer, torch's init)
GRU_CASES = ([(b, 25, "seeded") for b in (1, 3, 64, 256, 257, 1030, 2048)]
             + [(3, 1, "seeded"), (257, 1, "seeded"), (3, 40, "seeded"),
                (257, 40, "seeded")]
             + [(b, 25, "checkpoint") for b in (3, 256, 1030)])
# the batches at which the fp32 K2T is also held to autograd through the
# plain forward (T = 25, seeded weights)
AUTOGRAD_BATCHES = (64, 1030, 2048)


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


def _mixed(width):
    """Rows that mix silence and full-scale signal (peak 1: uniform noise,
    or a 1 kHz tone of 0.9 over noise of 0.1 so that every band stays above
    float32 rounding noise): buffer, lengths, and where each row's signal
    ends (exact zeros after it)."""
    rows = ((40000, 0), (80000, 80000), (80000, 30000), (52117, 52117),
            (1025, 0), (0, 0), (79999, 41000))
    rng = np.random.default_rng(77)
    buf = np.zeros((len(rows), width), np.float32)
    for i, (_, end) in enumerate(rows):
        noise = rng.uniform(-1.0, 1.0, end)
        t = np.arange(end) / 16000
        buf[i, :end] = (0.9 * np.sin(2 * np.pi * 1000 * t) + 0.1 * noise
                        if i % 2 else noise)
    return (torch.from_numpy(buf),
            torch.tensor([r[0] for r in rows], dtype=torch.int32),
            [r[1] for r in rows])


def _assert_floor(feats, lengths, ends, hop, n_fft=1024):
    """Raw-dB features (B, M, T): valid frames that hold only silence are
    exactly -100 dB, frames past the valid count exactly 0."""
    silent = 0
    for i, (n, end) in enumerate(zip(lengths.tolist(), ends)):
        t_valid = min(1 + n // hop, feats.shape[2])
        first = min(-(-(end + n_fft // 2) // hop) if end else 0, t_valid)
        assert bool((feats[i, :, first:t_valid] == -100.0).all())
        assert bool((feats[i, :, t_valid:] == 0).all())
        silent += t_valid - first
    assert silent > 0


def _assert_k1_close(got, want):
    assert torch.isfinite(got).all()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 0.05 * scale
    far = (got - want).abs() > 2.0 ** -7 * want.abs().clamp(min=1.0)
    assert float(far.float().mean()) < K1_FAR_SHARE


@pytest.mark.parametrize("batch", [1, 3, 256, 257, "silence and full scale"])
def test_frontend_conv1_odd_batches_and_silence(dev, batch):
    """K1 at batch sizes that are a multiple of nothing, and on rows that
    mix silence and full-scale signal; the bar of
    test_frontend_conv1_matches_plain."""
    if isinstance(batch, int):
        lengths = np.random.default_rng(batch).integers(1, 80001, batch)
        wf, ln = _waves(lengths.tolist(), seed=batch)
    else:
        wf, ln, _ = _mixed(WIDTH)
    wf, ln = wf.to(dev), ln.to(dev)
    fe = make_frontend_params(device=dev)
    g = torch.Generator().manual_seed(0)
    w = (torch.randn((32, 1, 3, 3), generator=g) / 3).to(dev)
    b = (0.1 * torch.randn(32, generator=g)).to(dev)
    got = fk.frontend_conv1(wf, ln, fe, w, b).float()
    torch.cuda.synchronize()
    want = fk._frontend_conv1_plain(wf, ln, fe, w, b).float()
    assert got.shape == (len(ln), 100, 1024)
    _assert_k1_close(got, want)


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
    assert float(far.float().mean()) < K1_FAR_SHARE


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("rows", [None, *TILE_ROWS])
@pytest.mark.parametrize("batch,steps,weights",
                         GRU_CASES + [(5, 25, "seeded")])
def test_gru_layer_matches_plain(dev, dtype, tol, batch, steps, weights,
                                 rows):
    """fp32 within 1e-5 (the reference's kernel bar); bf16 within 1e-2:
    the same operand roundings, only the fp32 summation order differs.
    The CUDA-core kernel at each tile height and the build the card picks
    (None), on full and ragged last tiles, T = 1 / 25 / 40, seeded and
    checkpoint weights; the same bits on a second launch."""
    gx, w, bn, _ = _gru_operands(dev, batch, steps, dtype=dtype,
                                 weights=weights)
    got = gru_layer(gx, w, bn, rows=rows)
    again = gru_layer(gx, w, bn, rows=rows)
    want = _gru_layer_plain(gx, w, bn)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) <= tol


@functools.lru_cache(maxsize=None)
def _checkpoint_recurrence():
    """(W_hh^T of both directions (2, 256, 768), their n-gate biases (2, 1,
    256)) of a seeded full-width model's first GRU layer, as
    ``gru_bidirectional`` lays them out; CPU float32."""
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU

    model = CNNAudioGRU(num_classes=31)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = model.state_dict()
    names = ("gru.weight_hh_l0", "gru.weight_hh_l0_reverse")
    w = torch.stack([state[n].t() for n in names]).contiguous()
    bn = torch.stack([state[n.replace("weight", "bias")][512:]
                      for n in names])[:, None, :].float()
    return w, bn


def _gru_operands(dev, batch, steps=25, hidden=256, dtype=torch.bfloat16,
                  weights="seeded"):
    g = torch.Generator().manual_seed(batch + steps)
    gx = torch.randn((2, steps, batch, 3 * hidden), generator=g).to(dev, dtype)
    w = (0.05 * torch.randn((2, hidden, 3 * hidden), generator=g)).to(
        dev, dtype)
    bn = (0.1 * torch.randn((2, 1, hidden), generator=g)).to(dev)
    dys = torch.randn((2, steps, batch, hidden), generator=g).to(dev, dtype)
    if weights == "checkpoint":
        w, bn = (t.to(dev) for t in _checkpoint_recurrence())
        w = w.to(dtype)
    return gx, w, bn, dys


@pytest.mark.parametrize("rows", MMA_ROWS)
@pytest.mark.parametrize("batch,steps,weights", GRU_CASES)
def test_gru_layer_tensor_core_kernel_matches_plain(dev, batch, steps,
                                                    weights, rows):
    """The tensor-core K2 (bf16, H = 256) at every tile height, on full and
    ragged tiles and T = 1, 25, 40, seeded and checkpoint weights: within
    1e-2 of the plain version (the same operand roundings; the fp32
    summation order and the gates' fast exponential differ), and the same
    bits on a second launch."""
    gx, w, bn, _ = _gru_operands(dev, batch, steps, weights=weights)
    got = gru_layer(gx, w, bn, rows=Plan("mma", rows))
    again = gru_layer(gx, w, bn, rows=Plan("mma", rows))
    want = _gru_layer_plain(gx, w, bn)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= 1e-2
    assert torch.equal(got, again)


@pytest.mark.parametrize("rows", CLUSTER_ROWS)
@pytest.mark.parametrize("batch,steps,weights", GRU_CASES + [
    (16, 25, "seeded"), (17, 25, "seeded"), (1, 1, "seeded"),
    (16, 1, "seeded"), (17, 1, "seeded"), (256, 1, "seeded")])
def test_gru_layer_cluster_kernel_matches_plain(dev, batch, steps, weights,
                                                rows):
    """The fp32 cluster K2 (H = 256, W_hh^T resident across a cluster of
    eight) at every tile height, on full and ragged tiles, T = 1 / 25 / 40,
    seeded and checkpoint weights: within the fp32 bar of 1e-5 of the plain
    version (fp32 FMAs, only the summation order differs), the same bits on
    a second launch (partial sums added in a fixed order), counted under
    its own key."""
    gx, w, bn, _ = _gru_operands(dev, batch, steps, dtype=torch.float32,
                                 weights=weights)
    gru_layer.kernel_launches["cluster"] = 0
    got = gru_layer(gx, w, bn, rows=Plan("cluster", rows))
    again = gru_layer(gx, w, bn, rows=Plan("cluster", rows))
    want = _gru_layer_plain(gx, w, bn)
    torch.cuda.synchronize()
    assert gru_layer.kernel_launches["cluster"] == 2
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got, again)


def _assert_k2t_within(got, want, dtype):
    """K2T's bars against a reference: fp32 dgx within 2e-5 + 2e-4 * |want|
    per element, dW and db_hn within 2e-5 + 2e-4 * max|want| (they sum
    T*B terms in another order); bf16 dgx and dW within one bf16 step
    (2**-7 relative) plus that bar, db_hn (fp32) at it."""
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


def _k2t_against_references(dev, batch, steps, weights, dtype, rows):
    """K2T at ``rows`` launched twice against its plain version (the same
    bits twice); the fp32 one at AUTOGRAD_BATCHES also against autograd
    through the plain forward."""
    gx, w, bn, dys = _gru_operands(dev, batch, steps, dtype=dtype,
                                   weights=weights)
    ys = _gru_layer_plain(gx, w, bn)
    got = gru_layer_backward(gx, w, bn, ys, dys, rows=rows)
    again = gru_layer_backward(gx, w, bn, ys, dys, rows=rows)
    wants = [_gru_layer_backward_plain(gx, w, bn, ys, dys)]
    if (dtype == torch.float32 and steps == 25 and weights == "seeded"
            and batch in AUTOGRAD_BATCHES):
        leaves = [t.clone().requires_grad_() for t in (gx, w, bn)]
        wants.append(torch.autograd.grad(_gru_layer_plain(*leaves), leaves,
                                         dys))
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    for want in wants:
        _assert_k2t_within(got, want, dtype)


@pytest.mark.parametrize("rows", gru_ops.CLUSTER_ROWS_BACKWARD)
@pytest.mark.parametrize("batch,steps,weights",
                         GRU_CASES + [(17, 25, "seeded")])
def test_gru_layer_backward_cluster_kernel_matches_plain(dev, batch, steps,
                                                         weights, rows):
    """The fp32 cluster K2T (H = 256, W_hh^T resident across a cluster of
    eight) at every tile height, on full and ragged tiles, T = 1 / 25 /
    40, seeded and checkpoint weights: within K2T's fp32 bars of the plain
    version (and of autograd through the plain forward at B = 64, 1030,
    2048), the same bits on a second launch (partial sums added in a fixed
    order), counted under its own key."""
    gru_layer_backward.kernel_launches["cluster"] = 0
    _k2t_against_references(dev, batch, steps, weights, torch.float32,
                            Plan("cluster", rows))
    assert gru_layer_backward.kernel_launches["cluster"] == 2


@pytest.mark.parametrize("rows", MMA_ROWS_BACKWARD)
@pytest.mark.parametrize("batch,steps,weights", GRU_CASES)
def test_gru_layer_backward_tensor_core_kernel_matches_plain(dev, batch,
                                                             steps, weights,
                                                             rows):
    """The tensor-core K2T at every tile height, seeded and checkpoint
    weights: dgx and dW within one bf16 step (2**-7 relative) plus 2e-5 +
    2e-4 * max|want|, db_hn (fp32) at that bar, as
    test_gru_layer_backward_matches_plain holds bf16; the same bits on a
    second launch (no atomics in the recurrence)."""
    _k2t_against_references(dev, batch, steps, weights, torch.bfloat16,
                            Plan("mma", rows))


def test_gru_plan_on_the_card(dev):
    """What a call launches: bf16 at H = 256 the tensor-core kernel, the
    fp32 forward at H = 256 the cluster kernel at B = 1 and 16 (the
    streaming finalize), the fp32 backward at H = 256 the cluster backward
    at the fp32 training batches (16, 64, 256, 1024),
    any other H the CUDA-core kernel (and a forced tensor-core or cluster
    launch of what they do not take raises); the launch counters count
    every kernel, each under its own key."""
    for backward in (False, True):
        heights = MMA_ROWS_BACKWARD if backward else MMA_ROWS
        for batch in (1, 256, 1024, 2048):
            p = picked_plan(batch, 256, torch.bfloat16, dev, backward)
            assert p.kernel == "mma" and p.rows in heights
        assert picked_plan(256, 128, torch.bfloat16, dev,
                           backward).kernel == "simt"
    for batch in (1, 16):
        p = picked_plan(batch, 256, torch.float32, dev)
        assert p.kernel == "cluster" and p.rows in CLUSTER_ROWS
    for batch in (16, 64, 256, 1024):
        assert picked_plan(batch, 256, torch.float32, dev,
                           True).kernel == "cluster"
    gx, w, bn, dys = _gru_operands(dev, 5, 7, hidden=128)
    gru_layer.launches = 0
    gru_layer.kernel_launches.update(simt=0, mma=0, cluster=0)
    got = gru_layer(gx, w, bn)  # bf16 at H = 128: the CUDA-core kernel
    torch.cuda.synchronize()
    assert gru_layer.launches == 1
    want = _gru_layer_plain(gx, w, bn)
    assert float((got.float() - want.float()).abs().max()) <= 1e-2
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        gru_layer(gx, w, bn, rows=Plan("mma", 32))
    with pytest.raises(ValueError, match="cluster kernel takes"):
        gru_layer(gx.float(), w.float(), bn, rows=Plan("cluster", 1))
    gx, w, bn, dys = _gru_operands(dev, 5, 7, dtype=torch.float32)
    gru_layer(gx, w, bn)  # fp32 at H = 256, B = 5: the cluster kernel
    torch.cuda.synchronize()
    assert gru_layer.launches == 2
    assert gru_layer.kernel_launches == {"simt": 1, "mma": 0, "cluster": 1}
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        gru_layer_backward(gx, w, bn, _gru_layer_plain(gx, w, bn), dys,
                           rows=Plan("mma", 32))
    with pytest.raises(ValueError, match="backward takes rows of"):
        gru_layer_backward(gx, w, bn, _gru_layer_plain(gx, w, bn), dys,
                           rows=Plan("cluster", 32))
    with pytest.raises(ValueError, match="cluster kernel takes"):
        gru_layer(gx.bfloat16(), w.bfloat16(), bn, rows=Plan("cluster", 1))
    with pytest.raises(ValueError, match="rows of"):
        gru_layer(gx, w, bn, rows=Plan("cluster", 3))
    with pytest.raises(ValueError, match="rows of"):
        gru_layer(gx.bfloat16(), w.bfloat16(), bn, rows=Plan("mma", 8))


def test_gru_tensor_core_kernel_takes_an_offset_view(dev):
    """Operands that start 2 bytes into their storage (contiguous, not
    16-byte aligned) are copied, not refused and not misread."""
    gx, w, bn, _ = _gru_operands(dev, 33, 5)
    flat = torch.empty(gx.numel() + 1, dtype=gx.dtype, device=dev)
    flat[1:] = gx.reshape(-1)
    view = flat[1:].view(gx.shape)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    got = gru_layer(view, w, bn)
    want = gru_layer(gx, w, bn)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _btc(gx):
    """The contract's gx (2, T, B, 3H) as the input GEMM lays it out, (B,
    T, 6H): direction d at columns [3H d, 3H d + 3H), both in forward
    time."""
    return torch.cat([gx[0], gx[1].flip(0)], -1).transpose(0, 1).contiguous()


@pytest.mark.parametrize("kernel,batch,steps,hidden,dtype", [
    ("mma", 2048, 25, 256, torch.bfloat16),
    ("mma", 257, 40, 256, torch.bfloat16),
    ("mma", 3, 1, 256, torch.bfloat16),
    ("cluster", 1, 25, 256, torch.float32),
    ("cluster", 16, 25, 256, torch.float32),
    ("cluster", 17, 40, 256, torch.float32),
    ("simt", 5, 25, 128, torch.bfloat16),
    ("simt", 33, 7, 128, torch.float32)])
def test_gru_layer_btc_is_the_contract_entry_bit_for_bit(dev, kernel, batch,
                                                          steps, hidden,
                                                          dtype):
    """Given the same gx, the entry on the GEMM's layout (the strides of
    (B, T, 6H) -> (B, T, 2H), direction 1 stepping from T - 1 down) gives
    the contract entry's bits, laid out as ``torch.nn.GRU``'s output, in
    each forward kernel the card picks for the shape (the tensor-core
    kernel at the b2048 cell's B = 2048, T = 25; the fp32 cluster kernel at
    the streaming finalize's B = 1 and 16; the CUDA-core kernel at H =
    128), on full and ragged tiles; counted under its own entry."""
    gx, w, bn, _ = _gru_operands(dev, batch, steps, hidden=hidden,
                                 dtype=dtype)
    gru_layer.launches = gru_layer_btc.launches = 0
    gru_layer_btc.kernel_launches.update(simt=0, mma=0, cluster=0)
    want = gru_layer(gx, w, bn)
    got = gru_layer_btc(_btc(gx), w, bn)
    torch.cuda.synchronize()
    assert (gru_layer.launches, gru_layer_btc.launches) == (1, 1)
    assert gru_layer_btc.kernel_launches[kernel] == 1
    assert got.shape == (batch, steps, 2 * hidden) and got.is_contiguous()
    assert torch.equal(got, torch.cat([want[0], want[1].flip(0)], -1)
                       .transpose(0, 1))


def test_served_b2048_call_runs_the_gru_without_glue(dev, tmp_path):
    """The default predictor at the b2048 cell's batch: K2 twice through
    the entry on the GEMM's layout (the tensor-core kernel) and never
    through the contract entry; inside the ``sir.gru`` span two input
    GEMMs and the two K2 launches, and no flip, stack, concatenation, add
    or cast of the GRU's operands (kept since the predictor was built, and
    read in place on every call)."""
    from torch.profiler import ProfilerActivity, profile

    pred, _ = _predictors(dev, tmp_path)
    gru = pred._fused_body().model.gru
    kept = [t.data_ptr() for layer in gru.inference_operands() for t in layer]
    lengths = np.random.default_rng(2048).integers(1, 80001, 2048)
    wf, ln = _waves(lengths.tolist(), seed=2048)
    wf = wf.to(dev)
    pred.predict_waveform_batch(wf, ln)
    _reset()
    gru_layer_btc.kernel_launches.update(simt=0, mma=0, cluster=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pred.predict_waveform_batch(wf, ln)
        torch.cuda.synchronize()
    assert _counts() == {"K1": 1, "K2": 2, "K3": 0, "K4": 0, "K5": 1, "K6": 0}
    assert gru_layer.launches == 0
    assert gru_layer_btc.kernel_launches == {"simt": 0, "mma": 2,
                                             "cluster": 0}
    assert kept == [t.data_ptr() for layer in gru.inference_operands()
                    for t in layer]
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    (gru,) = [e for e in cpu if e.name == "sir.gru"]
    inside = {e.name for e in cpu if e.name.startswith("aten::")
              and gru.time_range.start <= e.time_range.start
              and e.time_range.end <= gru.time_range.end}
    assert inside & {"aten::linear", "aten::addmm"}, inside
    glue = {"aten::flip", "aten::stack", "aten::cat", "aten::add",
            "aten::copy_", "aten::_to_copy", "aten::contiguous"}
    assert not inside & glue, inside & glue


def test_gru_kernel_resources(dev):
    """The cluster kernels as built: every tile height fits an SM (one
    block of 256 threads), spills nothing, stays inside 227 KB of shared
    memory at exactly the size the plan counts, and at least one cluster
    (of four for the tensor-core K2 and K2T, of eight for the fp32 K2 and
    K2T) fits the card."""
    found = gru_ops.kernel_resources(dev)
    assert set(found) == (
        {f"gru_layer_mma_rows{r}" for r in MMA_ROWS}
        | {f"gru_layer_bwd_mma_rows{r}" for r in MMA_ROWS_BACKWARD}
        | {f"gru_layer_cluster_rows{r}" for r in CLUSTER_ROWS}
        | {f"gru_layer_bwd_cluster_rows{r}"
           for r in gru_ops.CLUSTER_ROWS_BACKWARD})
    for name, r in found.items():
        rows = int(name.rsplit("rows", 1)[1])
        assert r["threads"] == 256 and r["blocks_per_sm"] == 1, name
        assert 0 < r["registers"] <= 255 and r["local_bytes"] == 0, name
        if "cluster" in name:
            assert r["shared_bytes"] == gru_ops.cluster_smem_bytes(
                rows, "bwd" in name)
            assert r["cluster"] == CLUSTER_SIZE
        else:
            assert r["shared_bytes"] == gru_ops.mma_smem_bytes(
                rows, "bwd" in name)
            assert r["cluster"] == gru_ops.MMA_CLUSTER
        assert r["shared_bytes"] <= gru_ops.SMEM_LIMIT, name
        assert r["clusters_per_card"] >= 1, name


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


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 3, 256, 257])
def test_frontend_odd_batches(dev, batch, out_dtype, normalize):
    """K3 at batch sizes that are a multiple of nothing and at the main
    path's 256, in an odd-width buffer (rows then start 4-byte aligned
    only), normalized and raw; the bar of test_frontend_matches_plain."""
    lengths = np.random.default_rng(batch).integers(1, 79999, batch)
    wf, ln = _waves(lengths.tolist(), seed=batch, width=79999)
    wf, ln = wf.to(dev), ln.to(dev)
    fe = make_frontend_params(device=dev)
    got = fk.frontend(wf, ln, fe, normalize, out_dtype)
    torch.cuda.synchronize()
    want = log_mel_frontend_plain(wf, ln, fe, normalize)
    assert got.shape == (batch, 64, 200)
    bound = 2e-3 if out_dtype == torch.float32 else \
        2.0 ** -8 * want.abs() + 2e-3
    assert bool(((got.float() - want).abs() <= bound).all())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("normalize", [True, False])
def test_frontend_silence_and_full_scale(dev, normalize, out_dtype):
    """K3 on rows that mix silence and full-scale signal: within the bar of
    test_frontend_matches_plain, and in raw dB the silent valid frames read
    exactly -100 and the frames past each valid count exactly 0."""
    wf, ln, ends = _mixed(80000)
    wf, ln = wf.to(dev), ln.to(dev)
    fe = make_frontend_params(device=dev)
    got = fk.frontend(wf, ln, fe, normalize, out_dtype)
    torch.cuda.synchronize()
    want = log_mel_frontend_plain(wf, ln, fe, normalize)
    bound = 2e-3 if out_dtype == torch.float32 else \
        2.0 ** -8 * want.abs() + 2e-3
    assert bool(((got.float() - want).abs() <= bound).all())
    if not normalize:
        _assert_floor(got.float().cpu(), ln.cpu(), ends, 512)


def test_frontend_kernel_resources(dev):
    """What K1, K3 and K4 take as built: every kernel fits an SM, K1 and
    K3 twice (two 8-warp blocks beside the 51 KB image), none spills at
    1024 points."""
    from speech_intent_recognizer_tpu_torch.config import AudioConfig

    fes = tuple(make_frontend_params(AudioConfig(n_fft=n, hop_length=n // 4),
                                     dev) for n in (256, 512, 1024, 2048))
    found = fk.kernel_resources(dev, fes)
    assert set(found) == {"frontend_conv1", "frontend_f32", "frontend_bf16",
                          "mel_db_n256_m64", "mel_db_n512_m64",
                          "mel_db_n1024_m64", "mel_db_n2048_m64"}
    for name, r in found.items():
        assert r["threads"] == 256 and r["blocks_per_sm"] >= 1, name
        assert 0 < r["registers"] <= 255 and r["shared_bytes"] <= 227 * 1024
    for name in ("frontend_conv1", "frontend_f32", "frontend_bf16"):
        assert found[name]["blocks_per_sm"] == 2
    for name in ("frontend_conv1", "frontend_f32", "mel_db_n1024_m64"):
        assert found[name]["local_bytes"] == 0, name


def test_frontend_refuses_other_geometry_on_cuda(dev):
    from speech_intent_recognizer_tpu_torch.config import AudioConfig

    wf, ln = _waves([16000], width=80000)
    with pytest.raises(ValueError, match="n_mels=64"):
        fk.frontend(wf.to(dev), ln.to(dev),
                    make_frontend_params(AudioConfig(n_mels=40), dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [None, *TILE_ROWS])
@pytest.mark.parametrize("batch,steps,weights",
                         GRU_CASES + [(5, 25, "seeded")])
def test_gru_layer_backward_matches_plain(dev, dtype, batch, steps, weights,
                                          rows):
    """K2 backward vs its plain version: the CUDA-core kernel at each tile
    height and the build the card picks (None), full and ragged tiles, T =
    1 / 25 / 40, seeded and checkpoint weights, by K2T's bars (fp32 also
    against autograd through the plain forward at B = 64, 1030, 2048); the
    same bits on a second launch."""
    _k2t_against_references(dev, batch, steps, weights, dtype, rows)


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
    gru_layer.launches = gru_layer_btc.launches = 0
    probs = pred.predict_waveform_batch(wf, ln)
    # K2 twice, through the entry on the GEMM's layout (no grad)
    assert (fk.frontend_conv1.launches, gru_layer_btc.launches,
            gru_layer.launches) == (1, 2, 0)
    want = cpu.predict_waveform_batch(wf, ln)
    assert (probs.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(probs, want, atol=2e-2)


def _predictors(dev, tmp_path, **form):
    """The default predictor on the card, or with ``form`` the same
    checkpoint's K1 path in that form of the variant (``conv23=True``,
    ``pool_impl="kernel"``), given through the predictor's K1 seam; and,
    beside it, the one with torch's epilogues after conv2 / conv3."""
    from speech_intent_recognizer_tpu_torch.infer.predict import Predictor
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
        CNNAudioGRU, conv1_external_params, conv23_params)

    model = CNNAudioGRU(num_classes=31)
    model.reset_parameters(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "m.pt")
    (tmp_path / "lm.json").write_text(json.dumps({str(i): i
                                                  for i in range(31)}))
    args = (str(tmp_path / "m.pt"), str(tmp_path / "lm.json"))
    pred, torch_ep = (Predictor.from_checkpoint(*args, device=dev)
                      for _ in range(2))
    folded = torch_ep.model.state_dict()
    torch_ep._serve_k1(*conv1_external_params(folded))
    if form:
        split = conv23_params if form.get("conv23") else conv1_external_params
        pred._serve_k1(*split(folded), **form)
    return pred, torch_ep


def _counts():
    """Each kernel's launches; K2's through either entry."""
    return {"K1": fk.frontend_conv1.launches,
            "K2": gru_layer.launches + gru_layer_btc.launches,
            "K3": fk.frontend.launches, "K4": fk.mel_db.launches,
            "K5": conv23.launches, "K6": bias_relu_pool2.launches}


def _reset():
    for fn in (fk.frontend_conv1, gru_layer, gru_layer_btc, fk.frontend,
               fk.mel_db, conv23, bias_relu_pool2):
        fn.launches = 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 100, 32, 64), (2, 50, 16, 128),
                                   (9, 8, 4, 64), (1, 2, 4, 32),
                                   (5, 6, 64, 2), (256, 100, 32, 64),
                                   (256, 50, 16, 128)])
def test_pool_epilogue_matches_plain(dev, shape, dtype):
    """K6 vs its plain version on (B, T, W, C) shapes (one with C = 2, the
    kernel's scalar instantiation; conv2's and conv3's raw outputs at
    B=256): f32 equal, bf16 within one rounding of
    the output (max|want| * 2**-8; in fact both round the same fp32 sum)."""
    g = torch.Generator().manual_seed(sum(shape))
    y = torch.randn(shape, generator=g).to(dev, dtype).permute(0, 3, 1, 2)
    bias = torch.randn(shape[-1], generator=g).to(dev)
    bias_relu_pool2.launches = 0
    got = bias_relu_pool2(y, bias)
    want = _bias_relu_pool2_plain(y, bias)
    torch.cuda.synchronize()
    assert bias_relu_pool2.launches == 1 and got.dtype == dtype
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        assert float((got.float() - want.float()).abs().max()) <= \
            float(want.float().abs().max()) * 2.0 ** -8


def test_pool_epilogue_refuses_other_strides(dev):
    y = torch.zeros((2, 64, 8, 16), device=dev)  # NCHW memory
    with pytest.raises(ValueError, match="channels-last"):
        bias_relu_pool2(y, torch.zeros(64, device=dev))
    with pytest.raises(ValueError, match="channels-last"):
        bias_relu_pool2(y.contiguous(memory_format=torch.channels_last)
                        [:, :, :, ::2][:, :, :, :4], torch.zeros(64,
                                                                 device=dev))


def test_pool_epilogue_negative_zero_and_nan(dev):
    """ReLU gives +0.0 for -0.0 and negatives; NaN passes through."""
    y = torch.full((1, 32, 2, 4), -1.0, device=dev)
    y[0, :, 0, 0] = -0.0
    y[0, 0, 1, 3] = float("nan")
    out = bias_relu_pool2(y.contiguous(memory_format=torch.channels_last),
                          torch.zeros(32, device=dev))
    torch.cuda.synchronize()
    assert torch.isnan(out[0, 0, 0, 1])
    rest = out.flatten()[~torch.isnan(out.flatten())]
    assert bool((rest == 0).all()) and not bool(torch.signbit(rest).any())


# K7: the train step's three conv outputs (C, H, W)
K7_STAGES = [(32, 64, 200), (64, 32, 100), (128, 16, 50)]


def _k7_operands(dev, b: int, c: int, h: int, w: int, seed: int,
                 scale=(0.5, 1.5)):
    """A bf16 channels-last conv output (N(0.3, 2)), BatchNorm weight
    (uniform in ``scale``) and bias, and a bf16 channels-last gradient of
    the pooled output, on ``dev`` from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    y = (2.0 * torch.randn((b, h, w, c), generator=g, device=dev) + 0.3).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    weight = scale[0] + (scale[1] - scale[0]) * torch.rand(
        c, generator=g, device=dev)
    bias = torch.rand(c, generator=g, device=dev) - 0.5
    dout = torch.randn((b, h // 2, w // 2, c), generator=g, device=dev).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    return y, weight, bias, dout


def _k7_tie_operands(dev):
    """:func:`_k7_operands` at B=64, (C, H, W) = (32, 64, 200), with forced
    ties: windows of one value, a BatchNorm scale that rounds most windows'
    values to one bf16 value, windows all zero after ReLU."""
    y, weight, bias, dout = _k7_operands(dev, 64, 32, 64, 200, seed=7,
                                         scale=(1e-3, 2e-3))
    y[:, :, :8, :8] = 0.75
    y[:, :8, 8:16, 8:16] = -6.0
    bias[:8] = -1.0
    bias[8:] = 1.0
    return y, weight, bias, dout


def _bf16_step(v: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing at each |v|, fp32."""
    _m, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def _k7_out_within(out, own, y, weight, mean, invstd, p_mean, p_invstd
                   ) -> float:
    """|out - own| (pooled outputs on K7's and on the plain's statistics)
    over what may part them: one bf16 step, and twice what the statistics'
    difference carries into z = (y - mean) * invstd * w + b, the most of a
    window: |d mean| * |invstd * w| + |y - mean| * |d invstd * w|."""
    import torch.nn.functional as F

    carried = (_col((mean - p_mean).abs() * (invstd * weight).abs())
               + (y.float() - _col(mean)).abs()
               * _col(((invstd - p_invstd) * weight).abs()))
    carried = 2.0 * F.max_pool2d(carried, 2)
    bar = _bf16_step(torch.maximum(out.float().abs(), own.float().abs())) \
        + carried
    return float(((out.float() - own.float()).abs() / bar).max())


def _k7_dy_within(dy, p_dy, y, weight, mean, invstd, dw, db, p_dw, p_db
                  ) -> float:
    """|dy - p_dy| over what may part them: one bf16 step, and what the
    two backwards' sums (summed in another order) carry into dy, twice:
    k3 * (|d sum_dy| + |y - mean| * invstd * |d dweight|) / n."""
    n = y.numel() // y.shape[1]
    carried = 2.0 * _col((weight * invstd).abs()) * (
        _col((db - p_db).abs()) + (y.float() - _col(mean)).abs()
        * _col(invstd * (dw - p_dw).abs())) / n
    bar = _bf16_step(p_dy) + carried
    return float(((dy.float() - p_dy.float()).abs() / bar).max())


# each reading of _k7_against_plain and its largest value
K7_BARS = {"mean_err": 1e-6, "var_err": 1e-6, "out_bar": 1.0,
           "dy_bar": 1.0, "dw_err": 1e-5, "db_err": 1e-5}


def _k7_against_plain(y, weight, bias, dout, eps: float = 1e-5):
    """K7's forward and backward, launched twice on the card, against
    their plain versions.  Readings: ``same``, every output the same bits
    twice; the statistics' ``mean_err`` (of the channel's deviation) and
    ``var_err`` (relative); ``out_bits``, on K7's statistics the plain
    apply pass's pooled output and argmax values bit for bit, the output
    channels-last; ``out_bar``, on the plain's own statistics, the gap over
    one bf16 step plus what the statistics' difference carries; ``dy_bar``,
    dy against the plain backward on K7's statistics over one bf16 step
    plus what the sums' order carries (``dy_steps``: the bare gap in bf16
    steps); ``dw_err`` and ``db_err``, of their largest.  Every reading
    within its bar (:data:`K7_BARS`)."""
    runs = []
    for _ in range(2):
        fwd = bn_pool._launch_forward(y, weight, bias, eps)
        runs.append(fwd + bn_pool._launch_backward(
            y, fwd[1], dout, weight, bias, fwd[2], fwd[4]))
    torch.cuda.synchronize()
    out, yarg, mean, var, invstd, dy, dw, db = runs[0]
    p_mean, p_var, p_invstd = bn_pool._stats_plain(y, eps)
    k_out, k_yarg = bn_pool._apply_plain(y, weight, bias, mean, invstd)
    own_out, _ = bn_pool._apply_plain(y, weight, bias, p_mean, p_invstd)
    p_dy, p_dw, p_db = bn_pool._backward_plain(y, yarg, dout, weight, bias,
                                               mean, invstd)
    got = {
        "same": all(torch.equal(a, b) for a, b in zip(*runs)),
        "out_bits": (torch.equal(out, k_out) and torch.equal(yarg, k_yarg)
                     and out.is_contiguous(
                         memory_format=torch.channels_last)),
        "mean_err": float(((mean - p_mean).abs() / p_var.sqrt()).max()),
        "var_err": float(((var - p_var).abs() / p_var).max()),
        "out_bar": _k7_out_within(out, own_out, y, weight, mean, invstd,
                                  p_mean, p_invstd),
        "dy_bar": _k7_dy_within(dy, p_dy, y, weight, mean, invstd, dw, db,
                                p_dw, p_db),
        "dy_steps": float(((dy.float() - p_dy.float()).abs() / _bf16_step(
            torch.maximum(dy.float().abs(), p_dy.float().abs()))).max()),
        "dw_err": float((dw - p_dw).abs().max() / p_dw.abs().max()),
        "db_err": float((db - p_db).abs().max() / p_db.abs().max()),
    }
    failed = [k for k in ("same", "out_bits") if not got[k]] + [
        k for k, bar in K7_BARS.items() if not got[k] <= bar]
    assert not failed, (failed, got)


def _k7_wrapper_against_launchers(y, weight, bias, dout, eps: float = 1e-5):
    """``bn_relu_pool2_train`` under autograd, on an NCHW copy of ``y`` and
    a training-mode ``BatchNorm2d`` with ``weight`` and ``bias``, against
    K7's launchers on ``y``.  Readings: ``counted``, the counters up by one
    forward and one backward; ``out_bits``, the pooled output the
    launcher's bits, channels-last; ``grad_bits``, the gradients of y,
    weight and bias the launcher's; ``running_bits``, after one batch the
    running statistics ``update_running_stats`` of the launcher's
    statistics, bit for bit.  Every reading true."""
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import BatchNorm2d

    bn, want_bn = (BatchNorm2d(y.shape[1], eps=eps).to(y.device).train()
                   for _ in range(2))
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    fn = bn_pool.bn_relu_pool2_train
    before = (fn.launches, fn.backward_launches)
    x = y.contiguous().requires_grad_()
    out = fn(x, bn)
    grads = torch.autograd.grad(out, (x, bn.weight, bn.bias), dout)
    moved = (fn.launches - before[0], fn.backward_launches - before[1])
    k_out, yarg, mean, var, invstd = bn_pool._launch_forward(y, weight, bias,
                                                             eps)
    k_grads = bn_pool._launch_backward(y, yarg, dout, weight, bias, mean,
                                       invstd)
    want_bn.update_running_stats(mean, var)
    torch.cuda.synchronize()
    got = {
        "counted": moved == (1, 1),
        "out_bits": torch.equal(out, k_out) and out.is_contiguous(
            memory_format=torch.channels_last),
        "grad_bits": all(torch.equal(a, b) for a, b in zip(grads, k_grads)),
        "running_bits": int(bn.num_batches_tracked) == 1 and all(
            torch.equal(a, b) for a, b in zip(bn.buffers(),
                                               want_bn.buffers())),
    }
    assert all(got.values()), got


@pytest.mark.parametrize("batch", [1024, 1030])
@pytest.mark.parametrize("stage", K7_STAGES)
def test_bn_relu_pool2_train_matches_plain(dev, stage, batch):
    """K7 against its plain version at each stage's shape, at the train
    cell's batch and an odd one."""
    c, h, w = stage
    _k7_against_plain(*_k7_operands(dev, batch, c, h, w, seed=c + batch))


def test_bn_relu_pool2_train_forced_ties(dev):
    """Windows of one value, a BatchNorm scale that rounds most windows'
    values to one bf16 value, windows all zero after ReLU: K7 routes each
    gradient where torch's max_pool2d sends it (the plain backward's
    routing) and pools the plain's bits."""
    _k7_against_plain(*_k7_tie_operands(dev))


@pytest.mark.parametrize("batch", [64, 1024])
@pytest.mark.parametrize("stage", K7_STAGES)
def test_bn_relu_pool2_train_wrapper(dev, stage, batch):
    """The wrapper under autograd on an NCHW input, at a small batch and
    the train cell's: the launchers' output and gradients bit for bit, the
    running statistics updated with K7's statistics, the counters up by one
    forward and one backward."""
    c, h, w = stage
    _k7_wrapper_against_launchers(*_k7_operands(dev, batch, c, h, w,
                                                seed=c + batch))


def test_bn_relu_pool2_train_refuses_other_layouts(dev):
    y, weight, bias, _ = _k7_operands(dev, 2, 32, 8, 10, seed=1)
    with pytest.raises(ValueError, match="channels-last"):
        bn_pool._launch_forward(y.contiguous(), weight, bias, 1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        bn_pool._launch_forward(y[:, :28], weight[:28], bias[:28], 1e-5)


def test_bf16_train_step_launches_k7(dev, monkeypatch):
    """A bf16 train step of the full-width model launches K7 once a stage
    forward and once backward, no ``batch_norm`` or ``max_pool`` kernel,
    and stays within bf16 rounding of the same step through the torch
    chain: loss, logits, the running statistics."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU

    model = CNNAudioGRU(num_classes=31, dropout=0.0,
                        compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(11))
    model = model.to(dev).train()
    ref = copy.deepcopy(model)
    x = torch.randn((64, 64, 200), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    bn_pool.bn_relu_pool2_train.launches = 0
    bn_pool.bn_relu_pool2_train.backward_launches = 0
    gru_layer.launches = gru_layer_btc.launches = 0
    gru_layer_backward.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        logits = model(x)
        logits.float().logsumexp(-1).sum().backward()
        torch.cuda.synchronize()
    assert (bn_pool.bn_relu_pool2_train.launches,
            bn_pool.bn_relu_pool2_train.backward_launches) == (3, 3)
    # the GRU under autograd: the contract entry and K2T, as before
    assert (gru_layer.launches, gru_layer_btc.launches,
            gru_layer_backward.launches) == (2, 0, 2)
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not [n for n in names if "batch_norm" in n or "max_pool" in n]
    monkeypatch.setattr(bn_pool, "engages", lambda bn, x: False)
    want = ref(x)
    want.float().logsumexp(-1).sum().backward()
    assert float((logits - want).float().abs().max()) <= \
        1e-2 * float(want.float().abs().max())
    for (n, a), (_, b) in zip(model.named_buffers(), ref.named_buffers()):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-5,
                                   atol=1e-5, msg=n)


@pytest.mark.parametrize("kw", [
    dict(), dict(n_fft=512, hop_length=256, n_mels=40),
    dict(n_fft=2048, win_length=1200, n_mels=80), dict(n_fft=64, n_mels=8),
], ids=["1024x64", "512x40", "2048x80_win1200", "64x8"])
@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 300])
def test_mel_db_matches_plain(dev, kw, n):
    """K4 vs its plain version (dense fp32 products, TF32 off): rtol / atol
    1e-4 (tests/test_pallas_frontend.py:35)."""
    from speech_intent_recognizer_tpu_torch.config import AudioConfig

    fe = make_frontend_params(AudioConfig(**kw), dev)
    g = torch.Generator().manual_seed(n)
    frames = (0.1 * torch.randn((n, fe.n_fft), generator=g)).to(dev)
    fk.mel_db.launches = 0
    got = fk.mel_db(frames, fe)
    want = fk._mel_db_plain(frames, fe)
    torch.cuda.synchronize()
    assert fk.mel_db.launches == 1 and got.shape == (n, fe.n_mels)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_mels", [40, 64, 80])
@pytest.mark.parametrize("n_fft", [32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_mel_db_every_fft_size(dev, n_fft, n_mels):
    """K4 at every n_fft it serves, with a window shorter than n_fft, at
    N in {0, 1, 255, 256, 257, 300} and on 1031 rows of which every other
    one is silent between full-scale ones: the bar of
    test_mel_db_matches_plain, and the silent rows exactly -100 dB."""
    from speech_intent_recognizer_tpu_torch.config import AudioConfig

    fe = make_frontend_params(AudioConfig(
        n_fft=n_fft, win_length=3 * n_fft // 4, hop_length=n_fft // 4,
        n_mels=n_mels), dev)
    g = torch.Generator().manual_seed(n_fft + n_mels)
    for n in (0, 1, 255, 256, 257, 300):
        frames = (0.1 * torch.randn((n, n_fft), generator=g)).to(dev)
        got = fk.mel_db(frames, fe)
        torch.cuda.synchronize()
        assert got.shape == (n, n_mels)
        torch.testing.assert_close(got, fk._mel_db_plain(frames, fe),
                                   rtol=1e-4, atol=1e-4)
    frames = torch.rand((1031, n_fft), generator=g).mul_(2).sub_(1).to(dev)
    frames[1::2] = 0.0
    got = fk.mel_db(frames, fe)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fk._mel_db_plain(frames, fe),
                               rtol=1e-4, atol=1e-4)
    assert bool((got[1::2] == -100.0).all())


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048])
def test_mel_db_full_batch_and_alignment(dev, n_fft):
    """K4 on a full batch of hop-256 frames (80,128 at 1024 points, as many
    bytes at the other sizes: more frames than the card holds warps for, so
    persistent blocks walk over them and the last round is ragged), and on
    a contiguous buffer that is only 4-byte aligned: the same bar."""
    from speech_intent_recognizer_tpu_torch.config import AudioConfig

    fe = make_frontend_params(AudioConfig(n_fft=n_fft, hop_length=n_fft // 4),
                              dev)
    n = 80128 * 1024 // n_fft
    frames = 0.1 * torch.randn((n, n_fft), device=dev)
    got = fk.mel_db(frames, fe)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fk._mel_db_plain(frames, fe),
                               rtol=1e-4, atol=1e-4)
    part = frames[:3001]
    flat = torch.empty(3001 * n_fft + 1, device=dev)
    flat[1:] = part.reshape(-1)
    shifted = flat[1:].view(3001, n_fft)
    assert shifted.data_ptr() % 8 == 4 and shifted.is_contiguous()
    unaligned = fk.mel_db(shifted, fe)
    torch.cuda.synchronize()
    torch.testing.assert_close(unaligned, fk._mel_db_plain(shifted, fe),
                               rtol=1e-4, atol=1e-4)


def test_mel_db_refuses_other_fft_sizes(dev):
    from speech_intent_recognizer_tpu_torch.config import AudioConfig

    fe = make_frontend_params(AudioConfig(n_fft=400, hop_length=160), dev)
    with pytest.raises(ValueError, match="power of two"):
        fk.mel_db(torch.zeros((4, 400), device=dev), fe)


@pytest.mark.parametrize("normalize", [True, False])
def test_frontend_off_reference_geometry_runs_k4(dev, normalize):
    """hop 256 / 400 frames: one K4 launch per batch, K3 none; against the
    plain front-end within 2e-3 (raw dB 5e-3), lengths 0..80000."""
    from speech_intent_recognizer_tpu_torch.config import AudioConfig

    cfg = AudioConfig(hop_length=256, mel_spec_length=400)
    fe = make_frontend_params(cfg, dev)
    wf, ln = _waves([8000, 39999, 80000, 1025, 512, 2, 1, 0],
                    width=padded_samples(cfg.max_samples, cfg.hop_length))
    wf, ln = wf.to(dev), ln.to(dev)
    _reset()
    got = log_mel_frontend(wf, ln, fe, normalize)
    want = log_mel_frontend_plain(wf, ln, fe, normalize)
    torch.cuda.synchronize()
    assert _counts() == {"K1": 0, "K2": 0, "K3": 0, "K4": 1, "K5": 0, "K6": 0}
    assert got.shape == (8, 64, 400)
    torch.testing.assert_close(got, want, rtol=2e-3,
                               atol=2e-3 if normalize else 5e-3)
    if not normalize:  # silence and full scale: exact floor, exact zeros
        mwf, mln, ends = _mixed(wf.shape[1])
        raw = log_mel_frontend(mwf.to(dev), mln.to(dev), fe, False)
        torch.cuda.synchronize()
        _assert_floor(raw.cpu(), mln, ends, 256)
    _reset()
    log_mel_frontend(wf[:, :padded_samples(80000)].contiguous(), ln,
                     make_frontend_params(device=dev))
    assert _counts()["K3"] == 1 and _counts()["K4"] == 0


# K5 against its plain version: (batch, T1), every batch at every T1
K5_CASES = [(b, t1) for t1 in (4, 8, 100, 200)
            for b in (1, 5, 131, 133, 256, 2048)]


@pytest.mark.parametrize("batch,t1", K5_CASES + [(3, 12), (2, 4)])
def test_conv23_matches_plain(dev, batch, t1):
    """K5 vs its plain version: max|err| < 0.02 * max|want|
    (tests/test_conv23_pallas.py:73-74), on full and partial time chunks,
    at batches around the SM count and the cells' 2048; the same bits on a
    second launch."""
    g = torch.Generator().manual_seed(batch + t1)
    x = (2 * torch.rand((batch, t1, 1024), generator=g)).to(dev,
                                                            torch.bfloat16)
    ops = [o.to(dev) for o in conv23_operands(
        (torch.rand((64, 32, 3, 3), generator=g) * 2 - 1) / 288 ** 0.5,
        0.1 * torch.randn(64, generator=g),
        (torch.rand((128, 64, 3, 3), generator=g) * 2 - 1) / 576 ** 0.5,
        0.1 * torch.randn(128, generator=g))]
    conv23.launches = 0
    got = conv23(x, *ops)
    want = _conv23_plain(x, *ops)
    torch.cuda.synchronize()
    assert conv23.launches == 1 and got.shape == (batch, t1 // 4, 1024)
    assert torch.equal(conv23(x, *ops), got)
    scale = float(want.float().abs().max())
    assert scale > 0.1 and float((want > 0).float().mean()) > 0.2
    assert float((got.float() - want.float()).abs().max()) < 0.02 * scale


@pytest.mark.parametrize("batch,t1", K5_CASES + [(3, 200)])
def test_conv23_every_range_length_gives_the_same_bits(dev, batch, t1):
    """K5 cuts the batch into (utterance, range of output rows) items; every
    range length its plan can pick gives the bits of whole utterances."""
    from speech_intent_recognizer_tpu_torch.ops.conv23 import range_lengths

    g = torch.Generator().manual_seed(t1 + batch)
    x = (2 * torch.rand((batch, t1, 1024), generator=g)).to(dev,
                                                            torch.bfloat16)
    ops = [o.to(dev) for o in conv23_operands(
        (torch.rand((64, 32, 3, 3), generator=g) * 2 - 1) / 288 ** 0.5,
        0.1 * torch.randn(64, generator=g),
        (torch.rand((128, 64, 3, 3), generator=g) * 2 - 1) / 576 ** 0.5,
        0.1 * torch.randn(128, generator=g))]
    whole = conv23(x, *ops, rows=t1 // 4)
    for rows in range_lengths(t1):
        assert torch.equal(conv23(x, *ops, rows=rows), whole), rows


def test_conv23_predictor_launches(dev, tmp_path):
    """The variant's conv23 form: K1 once, K5 once, K2 twice, K6 never;
    within 1e-2 of torch's epilogues on log-probabilities."""
    pred, default = _predictors(dev, tmp_path, conv23=True)
    wf, ln = _waves([24000, 80000, 3000, 41000], seed=3)
    _reset()
    probs = pred.predict_waveform_batch(wf, ln)
    assert _counts() == {"K1": 1, "K2": 2, "K3": 0, "K4": 0, "K5": 1, "K6": 0}
    want = default.predict_waveform_batch(wf, ln)
    assert float(np.abs(np.log(probs) - np.log(want)).max()) <= 1e-2


@pytest.mark.parametrize("batch", [1, 256, 2048])
def test_default_predictor_serves_k5(dev, tmp_path, batch):
    """The default predictor at the reference geometry: K1 once, K5 once,
    K2 twice, K6 never; probabilities within 2e-2 of the fp32 CPU
    predictor (the train-form model behind the plain front-end; every row
    up to 256, 64 sampled rows at 2048); the same bits twice."""
    from speech_intent_recognizer_tpu_torch.infer.predict import Predictor

    pred, _ = _predictors(dev, tmp_path)
    assert pred._fused_body().model.conv23
    lengths = np.random.default_rng(batch).integers(1, 80001, batch)
    wf, ln = _waves(lengths.tolist(), seed=batch)
    wf = wf.to(dev)
    _reset()
    probs = pred.predict_waveform_batch(wf, ln)
    assert _counts() == {"K1": 1, "K2": 2, "K3": 0, "K4": 0, "K5": 1, "K6": 0}
    assert probs.shape == (batch, 31) and np.isfinite(probs).all()
    assert np.array_equal(pred.predict_waveform_batch(wf, ln), probs)
    cpu = Predictor.from_checkpoint(str(tmp_path / "m.pt"),
                                    str(tmp_path / "lm.json"), device="cpu",
                                    fold_bn=False)
    rows = (np.arange(batch) if batch <= 256 else np.sort(
        np.random.default_rng(7).choice(batch, 64, replace=False)))
    want = cpu.predict_waveform_batch(wf.cpu()[rows], ln[rows])
    np.testing.assert_allclose(probs[rows], want, atol=2e-2)


def test_pool_impl_kernel_predictor_launches(dev, tmp_path):
    """The variant's ``pool_impl="kernel"`` form: K1 once, K6 twice, K2
    twice, K5 never."""
    pred, default = _predictors(dev, tmp_path, pool_impl="kernel")
    wf, ln = _waves([24000, 80000, 3000, 41000], seed=3)
    _reset()
    probs = pred.predict_waveform_batch(wf, ln)
    assert _counts() == {"K1": 1, "K2": 2, "K3": 0, "K4": 0, "K5": 0, "K6": 2}
    want = default.predict_waveform_batch(wf, ln)
    assert float(np.abs(np.log(probs) - np.log(want)).max()) <= 1e-2


def test_precompute_off_reference_geometry_runs_k4(dev, tmp_path):
    """The precompute at hop 256 / 40 mels on the card: K4 once per batch,
    features within 2e-3 + the int16 fetch's 1.5e-4 of the CPU's."""
    from speech_intent_recognizer_tpu_torch.config import AudioConfig
    from speech_intent_recognizer_tpu_torch.data.audio_io import save_wav
    from speech_intent_recognizer_tpu_torch.data.cache import (
        precompute_features)
    from speech_intent_recognizer_tpu_torch.data.manifest import Manifest

    cfg = AudioConfig(hop_length=256, n_mels=40, mel_spec_length=400)
    wf, ln = _waves([16000, 30000, 52117, 80000, 9000], seed=5)
    paths = []
    for i, n in enumerate(ln.tolist()):
        paths.append(str(tmp_path / f"{i}.wav"))
        save_wav(paths[-1], wf[i, :n].numpy(), 16000)
    manifest = Manifest(paths, ["a"] * len(paths))
    _reset()
    got = precompute_features(manifest, {"a": 0}, cfg, batch_size=2,
                              progress=False, device=dev)[0]
    assert _counts()["K4"] == 3 and _counts()["K3"] == 0
    want = precompute_features(manifest, {"a": 0}, cfg, batch_size=2,
                               progress=False, device="cpu")[0]
    assert got.shape == want.shape == (5, 40, 400)
    np.testing.assert_allclose(got, want, atol=2e-3 + 3e-4)


# ---------------------------------------------------------------- streaming


def _stream_predictor(device):
    """A narrow BN-folded model, seeded, on ``device``."""
    from speech_intent_recognizer_tpu_torch.infer.predict import Predictor
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU

    model = CNNAudioGRU(4, conv_channels=(8, 16, 16), gru_hidden=32,
                        fold_bn=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return Predictor(model, {f"intent_{i}": i for i in range(4)},
                     device=device)


def _tone(seed, n):
    r = np.random.default_rng(seed)
    return (0.2 * np.sin(2 * np.pi * r.uniform(200, 400) * np.arange(n)
                         / 16000) + 0.02 * r.standard_normal(n)).astype(
        np.float32)


@pytest.mark.parametrize("n", [513, 20000, 85000])
def test_streaming_device_mode_matches_host(dev, n):
    """``device`` mode (K4 per block of up to 16 frames) against the NumPy
    host mode, within the JAX package's host-vs-device bar (2e-3)."""
    from speech_intent_recognizer_tpu_torch.infer.streaming import (
        StreamingFeaturizer)

    x = _tone(n, n)
    out = {}
    for mode in ("host", "device"):
        fz = StreamingFeaturizer(mode=mode, device=dev)
        fk.mel_db.launches = 0
        for i in range(0, n, 1024):
            fz.feed(x[i : i + 1024])
        out[mode] = fz.finalize()
        if mode == "device":
            assert fk.mel_db.launches >= 1
    np.testing.assert_allclose(out["device"], out["host"], rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("count,n_tail", [(0, 4), (37, 2), (198, 4),
                                          (200, 0)])
def test_fused_finalize_card_matches_cpu(dev, count, n_tail):
    """K4 + the fp32 model (K2 twice) on the card against the plain
    versions on the CPU, the same operands: probabilities within 1e-5."""
    from speech_intent_recognizer_tpu_torch.infer.streaming import (
        fused_finalize)

    r = np.random.default_rng(count + n_tail)
    mel = np.zeros((1, 200, 64), np.float32)
    mel[0, :count] = r.uniform(-80.0, 10.0, (count, 64))
    tail = np.zeros((1, 4, 1024), np.float32)
    tail[0, :n_tail] = _tone(count, n_tail * 1024).reshape(n_tail, 1024)
    args = (mel, np.asarray([count]), tail, np.asarray([n_tail]))
    card, cpu = _stream_predictor(dev), _stream_predictor("cpu")
    _reset()
    got = fused_finalize(card.model, card.frontend_params, *args).cpu()
    # K2 twice, through the entry on the GEMM's layout (inference mode)
    assert (fk.mel_db.launches, gru_layer_btc.launches,
            gru_layer.launches) == (1, 2, 0)
    want = fused_finalize(cpu.model, cpu.frontend_params, *args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_batched_finalize_rows_match_single_on_card(dev):
    from speech_intent_recognizer_tpu_torch.infer.streaming import (
        BatchFinalizer, PendingResult, StreamingRecognizer)

    pred = _stream_predictor(dev)
    batcher = BatchFinalizer(pred)
    singles, deferred = [], []
    for i, n in enumerate((16000, 23456, 40001, 80000, 3000)):
        x = _tone(i, n)
        recs = [StreamingRecognizer(pred, silence_limit=10.0, **kw)
                for kw in ({}, {"async_results": True,
                                "batch_finalizer": batcher})]
        for rec in recs:
            for j in range(0, n, 1024):
                rec.feed(x[j : j + 1024])
        singles.append(recs[0].flush())
        deferred.append(recs[1].flush())
    _reset()
    assert batcher.flush() == 5
    assert (fk.mel_db.launches, gru_layer_btc.launches,
            gru_layer.launches) == (1, 2, 0)
    for want, have in zip(singles, PendingResult.get_all(deferred)):
        assert have["predicted_label"] == want["predicted_label"]
        for a, b in zip(want["top_predictions"], have["top_predictions"]):
            assert a["label"] == b["label"]
            assert abs(a["probability"] - b["probability"]) < 1e-5


def test_server_partial_on_card(dev, tmp_path):
    """The server's ``partial`` op with the model on the card: the
    hypothesis reaches the client through the drain loop (a pending copy,
    no blocking read) and equals the CPU recognizer's within 1e-5; then the
    flushed result likewise."""
    import asyncio
    import json

    from speech_intent_recognizer_tpu_torch.infer.server import (
        IntentServer, encode_chunk)
    from speech_intent_recognizer_tpu_torch.infer.streaming import (
        StreamingRecognizer)

    x = _tone(5, 8192)
    cpu = StreamingRecognizer(_stream_predictor("cpu"), silence_limit=10.0)
    for i in range(0, len(x), 1024):
        cpu.feed(x[i : i + 1024])
    want_partial, want_result = cpu.partial_result(), cpu.flush()
    server = IntentServer(_stream_predictor(dev), silence_limit=10.0)
    sock = str(tmp_path / "sir.sock")

    async def script():
        srv = await server.start(socket_path=sock)
        reader, writer = await asyncio.open_unix_connection(sock)
        try:
            for i in range(0, len(x), 1024):
                writer.write((json.dumps({
                    "op": "chunk", "session": "c",
                    "pcm": encode_chunk(x[i : i + 1024])}) + "\n").encode())
            for op in ("partial", "flush"):
                writer.write((json.dumps({"op": op, "session": "c"})
                              + "\n").encode())
            await writer.drain()
            return [json.loads(await asyncio.wait_for(reader.readline(), 60))
                    for _ in range(2)]
        finally:
            writer.close()
            srv.close()
            await srv.wait_closed()

    partial, result = asyncio.run(script())
    for got, want, event in ((partial, want_partial, "partial"),
                             (result, want_result, "result")):
        assert got["event"] == event and got["session"] == "c"
        assert got["predicted_label"] == want["predicted_label"]
        assert abs(got["confidence"] - want["confidence"]) < 1e-5


def _int16_waves(n, width=80000, seed=0):
    """Seeded tone rows of random lengths in [1, width], int16, zero past
    each length (the waveform cache's rows); the first of length 1."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, width + 1, n).astype(np.int32)
    lengths[0] = 1
    waves = np.zeros((n, width), np.int16)
    for i, m in enumerate(lengths):
        t = np.arange(m) / 16000
        x = 0.3 * np.sin(2 * np.pi * (300 + 50 * i) * t) \
            + 0.05 * rng.standard_normal(m)
        waves[i, :m] = np.round(x * 32767)
    return torch.from_numpy(waves), torch.from_numpy(lengths)


def test_waveform_augment_card_matches_cpu(dev):
    """The augmentation's apply step on the card against the CPU on the
    same draws (every gate open, and the default gates): within 1e-5,
    lengths exactly."""
    from speech_intent_recognizer_tpu_torch.ops.augment import (
        apply_augment, draw_augment)

    w16, ln = _int16_waves(64, seed=3)
    x = w16.float() / 32768.0
    draws = draw_augment(64, x.shape[1], torch.Generator().manual_seed(0),
                         "cpu")
    for prob in (1.0, 0.7):
        want_x, want_ln = apply_augment(x, ln, draws, augment_prob=prob)
        got_x, got_ln = apply_augment(
            x.to(dev), ln.to(dev),
            type(draws)(*(d.to(dev) for d in draws)), augment_prob=prob)
        assert torch.equal(got_ln.cpu(), want_ln)
        assert float((got_x.cpu() - want_x).abs().max()) <= 1e-5


def test_k3_at_the_waveform_steps_operands(dev):
    """K3 against its plain version on the operands of a waveform train
    step: B=64 rows of width 80000 after augmentation on the card (lengths
    1 and speed-shortened among them), within the K3 bar (2e-3)."""
    from speech_intent_recognizer_tpu_torch.ops.augment import (
        augment_waveforms)

    w16, ln = _int16_waves(64, seed=4)
    gen = torch.Generator(device=dev).manual_seed(1)
    x, la = augment_waveforms(w16.to(dev).float() / 32768.0, ln.to(dev),
                              gen, augment_prob=1.0)
    assert la.dtype == torch.int32 and bool((la < ln.to(dev)).any())
    assert int(la.min()) == 1
    fe = make_frontend_params(device=dev)
    before = fk.frontend.launches
    got = log_mel_frontend(x, la.clamp(min=1), fe)
    assert fk.frontend.launches == before + 1
    want = log_mel_frontend_plain(x, la.clamp(min=1), fe)
    assert float((got - want).abs().max()) <= 2e-3


def test_waveform_train_step_card_matches_cpu(dev):
    """One fp32 waveform-resident train step (B=16, augmentation off,
    dropout 0, TF32 off) of the full-width model on the card against the
    CPU: loss within 1e-4 relative, every gradient within 1e-3 of its
    tensor's largest value + 1e-5, BatchNorm running statistics 1e-5
    (chip_smoke.py's bars); the card step launches K3 once, K2 and K2T
    twice each."""
    import copy

    import torch.nn.functional as F

    from speech_intent_recognizer_tpu_torch.config import Config
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
    from speech_intent_recognizer_tpu_torch.train.loop import (
        Trainer, cross_entropy)

    w16, ln = _int16_waves(16, seed=5)
    labels = torch.arange(16) % 31
    cpu_model = CNNAudioGRU(num_classes=31, dropout=0.0)
    cpu_model.reset_parameters(torch.Generator().manual_seed(11))
    out = {}
    for d, model in (("cpu", cpu_model),
                     ("card", copy.deepcopy(cpu_model).to(dev))):
        where = "cpu" if d == "cpu" else dev
        trainer = Trainer(model, Config.from_dict({}), from_waveforms=True)
        counts = (fk.frontend.launches, gru_layer.launches,
                  gru_layer_backward.launches)
        model.train()
        x = trainer._inputs(w16.to(where), ln.to(where),
                            torch.arange(16, device=where))
        loss = cross_entropy(model(x), F.one_hot(labels.to(where), 31)
                             .float(), torch.ones(16, device=where))
        loss.backward()
        launched = (fk.frontend.launches - counts[0],
                    gru_layer.launches - counts[1],
                    gru_layer_backward.launches - counts[2])
        out[d] = (float(loss), {n: p.grad.cpu() for n, p in
                                model.named_parameters()},
                  {n: b.cpu() for n, b in model.named_buffers()
                   if "running" in n}, launched)
    (l_cpu, g_cpu, s_cpu, _), (l_dev, g_dev, s_dev, launched) = (
        out["cpu"], out["card"])
    assert launched == (1, 2, 2)
    assert abs(l_dev - l_cpu) <= 1e-4 * abs(l_cpu)
    for n in g_cpu:
        scale = float(g_cpu[n].abs().max())
        assert float((g_dev[n] - g_cpu[n]).abs().max()) <= \
            1e-5 + 1e-3 * scale, n
    for n in s_cpu:
        assert float((s_dev[n] - s_cpu[n]).abs().max()) <= 1e-5, n


# ------------------------------------------------------ ops and artifacts


def _op_calls(dev):
    """Each kernel's wrapper and its ``sir`` op on the same CUDA operands:
    name -> (wrapper call, op call)."""
    fe = make_frontend_params(device=dev)
    wf, ln = _waves([24000, 80000, 3000, 1], seed=5)
    wf, ln = wf.to(dev), ln.to(dev)
    g = torch.Generator().manual_seed(1)

    def t(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dev, dtype)

    c1w, c1b = t(32, 1, 3, 3), t(32)
    frames = t(37, 1024)
    gx, w, bn = t(2, 25, 40, 768, dtype=torch.bfloat16), \
        t(2, 256, 768, dtype=torch.bfloat16) * 0.05, t(2, 1, 256)
    gx6 = t(40, 25, 1536, dtype=torch.bfloat16)
    x = t(5, 100, 1024, dtype=torch.bfloat16)
    ops = conv23_operands(t(64, 32, 3, 3) * 0.1, t(64), t(128, 64, 3, 3) * 0.1,
                          t(128))
    y = t(3, 64, 50, 16).contiguous(memory_format=torch.channels_last)
    bias = t(64)
    sir = torch.ops.sir
    return {
        "frontend_conv1": (lambda: fk.frontend_conv1(wf, ln, fe, c1w, c1b),
                           lambda: sir.frontend_conv1(wf, ln, c1w, c1b, *fe)),
        "frontend": (lambda: fk.frontend(wf, ln, fe, False, torch.bfloat16),
                     lambda: sir.frontend(wf, ln, False, True, *fe)),
        "mel_db": (lambda: fk.mel_db(frames, fe),
                   lambda: sir.mel_db(frames, *fe)),
        "gru_layer": (lambda: gru_layer(gx, w, bn),
                      lambda: sir.gru_layer(gx, w, bn, "", 0)),
        "gru_layer_btc": (lambda: gru_layer_btc(gx6, w, bn),
                          lambda: sir.gru_layer_btc(gx6, w, bn)),
        "conv23": (lambda: conv23(x, *ops), lambda: sir.conv23(x, *ops, 0)),
        "bias_relu_pool2": (lambda: bias_relu_pool2(y, bias),
                            lambda: sir.bias_relu_pool2(y, bias)),
    }


@pytest.mark.parametrize("name", ["frontend_conv1", "frontend", "mel_db",
                                  "gru_layer", "gru_layer_btc", "conv23",
                                  "bias_relu_pool2"])
def test_op_equals_its_wrapper_on_card(dev, name):
    """Each ``sir`` op called directly on CUDA tensors launches its kernel
    once and gives its wrapper's bits."""
    wrapper, op = _op_calls(dev)[name]
    want = wrapper()
    _reset()
    got = op()
    torch.cuda.synchronize()
    assert sum(_counts().values()) == 1
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_production_artifact_equals_live_predictor(dev, tmp_path):
    """A production artifact of the default predictor pinned at B=8,
    loaded from its directory: K1 and K5 once and K2 twice per call, rows
    bit-equal to the live predictor's at B=8 and, routed to that program,
    at B=3."""
    from speech_intent_recognizer_tpu_torch.infer.export import (
        ServingModel, export_predictor)

    pred, _ = _predictors(dev, tmp_path)
    export_predictor(pred, str(tmp_path / "art"), flavor="production",
                     batch_sizes=(8,))
    srv = ServingModel.load(str(tmp_path / "art"), device=dev)
    wf, ln = _waves([24000, 80000, 3000, 1, 512, 40000, 79999, 16000],
                    seed=6)
    _reset()
    got = srv.predict_waveform_batch(wf, ln)
    assert _counts() == {"K1": 1, "K2": 2, "K3": 0, "K4": 0, "K5": 1,
                         "K6": 0}
    assert (gru_layer_btc.launches, gru_layer.launches) == (2, 0)
    assert np.array_equal(got, pred.predict_waveform_batch(wf, ln))
    short_wf = torch.cat([wf[:3], torch.zeros((5, wf.shape[1]))])
    short_ln = torch.cat([ln[:3], torch.ones(5, dtype=torch.int32)])
    assert np.array_equal(srv.predict_waveform_batch(wf[:3], ln[:3]),
                          pred.predict_waveform_batch(short_wf,
                                                      short_ln)[:3])


def test_wav2vec_backbone_card_matches_cpu(dev):
    """The tiny wav2vec configs (base and stable) on the card against the
    CPU, fp32 with TF32 off, a padded batch with a row of feature length
    <= 0: hidden states and logits within 1e-4 of their largest magnitude;
    no kernel of the package launches."""
    from speech_intent_recognizer_tpu_torch.models.wav2vec import (
        Wav2VecIntent, small_wav2vec_base_config, small_wav2vec_config)

    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.1 * rng.standard_normal((3, 4000)))
                         .astype(np.float32))
    mask = torch.arange(4000)[None] < torch.tensor([4000, 2000, 30])[:, None]
    for make in (small_wav2vec_base_config, small_wav2vec_config):
        model = Wav2VecIntent(make(64, 2), 5).reset_parameters(
            torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            want = (model.wav2vec(x, mask), model(x, mask))
            model.to(dev)
            fk.frontend_conv1.launches = gru_layer.launches = 0
            got = (model.wav2vec(x.to(dev), mask.to(dev)),
                   model(x.to(dev), mask.to(dev)))
        for g, w in zip(got, want):
            err = float((g.cpu() - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()), (make.__name__, err)
        assert fk.frontend_conv1.launches == gru_layer.launches == 0
