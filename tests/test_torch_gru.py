"""The port's GRU recurrence (plain K2) against the JAX package: the Pallas
kernel (interpret mode on the CPU) and the ``lax.scan`` recurrence, on the
same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu.models.cnn_gru import (
    _gru_bidirectional_scan)
from speech_intent_recognizer_tpu.ops.gru_pallas import (
    _gru_layer_call, gru_bidirectional_pallas)
from speech_intent_recognizer_tpu_torch.ops.gru import (
    CLUSTER_BWD_STEP_US, CLUSTER_ROWS, CLUSTER_ROWS_BACKWARD, CLUSTER_SIZE,
    CLUSTER_STEP_US, TILE_ROWS, Plan, gru_bidirectional, gru_layer, gru_plan,
    tile_rows)

T, B, H = 25, 4, 256


def _inputs(rng):
    return dict(
        gx_f=rng.standard_normal((T, B, 3 * H)).astype(np.float32),
        gx_b=rng.standard_normal((T, B, 3 * H)).astype(np.float32),
        w_f=(rng.standard_normal((3 * H, H)) * 0.05).astype(np.float32),
        w_b=(rng.standard_normal((3 * H, H)) * 0.05).astype(np.float32),
        b_f=(rng.standard_normal(3 * H) * 0.1).astype(np.float32),
        b_b=(rng.standard_normal(3 * H) * 0.1).astype(np.float32))


@pytest.mark.parametrize("ref", ["pallas", "scan"])
def test_bidirectional_matches_jax_fp32(rng, ref):
    """Bar of tests/test_gru_pallas.py:31-34 (1e-5, fp32)."""
    a = _inputs(rng)
    args = [a[k] for k in ("gx_f", "gx_b", "w_f", "w_b", "b_f", "b_b")]
    fn = gru_bidirectional_pallas if ref == "pallas" else \
        _gru_bidirectional_scan
    want_f, want_b = fn(*[jnp.asarray(x) for x in args], H)
    got_f, got_b = gru_bidirectional(*[torch.from_numpy(x) for x in args])
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                               rtol=1e-5, atol=1e-5)


def test_layer_bf16_matches_pallas_layer(rng):
    """bf16 operands and output, fp32 h and gate math, as the Pallas
    layer kernel.  Only fp32 summation order differs, so outputs agree
    to a bf16 rounding step (|h| < 1: 2**-8)."""
    gx = rng.standard_normal((2, T, B, 3 * H)).astype(np.float32)
    w = (rng.standard_normal((2, H, 3 * H)) * 0.05).astype(np.float32)
    bn = (rng.standard_normal((2, 1, H)) * 0.1).astype(np.float32)
    want = _gru_layer_call(jnp.asarray(gx, jnp.bfloat16),
                           jnp.asarray(w, jnp.bfloat16), jnp.asarray(bn),
                           interpret=True)
    got = gru_layer(torch.from_numpy(gx).bfloat16(),
                    torch.from_numpy(w).bfloat16(), torch.from_numpy(bn))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2.0 ** -8, rtol=0)


def test_plain_layer_is_differentiable_on_cpu(rng):
    a = _inputs(rng)
    gx = torch.from_numpy(np.stack([a["gx_f"], a["gx_b"]])).requires_grad_()
    w = torch.from_numpy(np.stack([a["w_f"].T, a["w_b"].T])).contiguous()
    bn = torch.zeros((2, 1, H))
    gru_layer(gx, w, bn).sum().backward()
    assert gx.grad is not None and torch.isfinite(gx.grad).all()


def _cluster_rows(batch, sms, backward=False):
    """The fp32 cluster kernel's height of least fitted cost, ``sms // 8``
    clusters resident: waves of clusters x (fixed + per-row us a step)."""
    resident = max(sms // CLUSTER_SIZE, 1)
    fixed, per_row = CLUSTER_BWD_STEP_US if backward else CLUSTER_STEP_US
    heights = CLUSTER_ROWS_BACKWARD if backward else CLUSTER_ROWS
    return min(heights, key=lambda r: (
        -(-2 * -(-batch // r) // resident) * (fixed + per_row * r), r))


@pytest.mark.parametrize("batch,sms,rows", [
    (1, 132, 4), (256, 132, 4), (1040, 132, 4), (1041, 132, 16),
    (2048, 132, 16), (2048, 264, 4), (64, 8, 16), (1056, 132, 16),
    (4096, 264, 16), (63, 8, 16), (48, 8, 4)])
def test_tile_rows_fills_every_sm(batch, sms, rows):
    """The CUDA-core kernels: 16-row tiles only where 2 * ceil(B / 16)
    blocks cover every SM.  They are what ``gru_plan`` launches for a
    hidden size the tensor-core and the fp32 cluster kernels do not take,
    forward and backward; fp32 at H = 256 takes the cluster kernel, forward
    and backward, at its height of least fitted cost."""
    assert tile_rows(batch, sms) == rows
    assert rows in TILE_ROWS
    for backward in (False, True):
        plan = gru_plan(batch, 256, torch.float32, sms, backward)
        assert plan == Plan("cluster", _cluster_rows(batch, sms, backward))
        assert gru_plan(batch, 128, torch.float32, sms, backward) == Plan(
            "simt", rows)
        assert gru_plan(batch, 128, torch.bfloat16, sms, backward) == Plan(
            "simt", rows)
        assert gru_plan(batch, 256, torch.bfloat16, sms,
                        backward).kernel == "mma"


# ---- the entry on the input GEMM's layout (gru_layer_btc) ----

def _nn_gru(dtype, features=12, hidden=32, layers=1):
    """A seeded ``torch.nn.GRU`` (bidirectional, batch first) and the
    TorchGRU with its leaves, in ``dtype`` compute."""
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import TorchGRU

    torch.manual_seed(0)
    ref = torch.nn.GRU(features, hidden, layers, batch_first=True,
                       bidirectional=True)
    model = TorchGRU(features, hidden, layers, dropout=0.0,
                     compute_dtype=dtype).eval()
    model.load_state_dict(ref.state_dict())
    return ref, model


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_btc_entry_matches_the_contract_entry_and_nn_gru(dtype, tol):
    """One GEMM over ``btc_operands`` (b_hh[r, z] in its bias), then
    ``gru_layer_btc`` on its (B, T, 6H): bit for bit the contract entry's
    plain version on the same gx laid out as (2, T, B, 3H); within ``tol``
    of ``torch.nn.GRU``'s (B, T, 2H) (fp32: the recurrence's bar; bf16:
    its operand roundings); within one rounding of the output of the
    contract path with b_hh[r, z] added after the GEMM."""
    from speech_intent_recognizer_tpu_torch.ops.gru import (
        btc_operands, btc_view, gru_layer_btc)

    ref, model = _nn_gru(dtype)
    x = torch.randn(5, 6, 12)
    w_ih, bias, w, bn = model.inference_operands()[0]
    assert w_ih.shape == (192, 12) and bias.shape == (192,)
    assert w.dtype == dtype and bn.dtype == torch.float32
    gx = torch.nn.functional.linear(x.to(dtype), w_ih, bias)
    with torch.no_grad():
        got = gru_layer_btc(gx, w, bn)
        g = btc_view(gx)
        ys = gru_layer(torch.stack([g[0], g[1].flip(0)]), w, bn)
        want, _ = ref(x)
        contract = model._recorded_layer(x.to(dtype), 0)
    assert got.shape == (5, 6, 64) and got.dtype == dtype
    assert torch.equal(got, torch.cat([ys[0], ys[1].flip(0)], -1)
                       .transpose(0, 1))
    assert float((got.float() - want).abs().max()) <= tol
    step = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
    assert float((got.float() - contract.float()).abs().max()) <= step
    leaves = [[getattr(model, f"{n}_l0{s}") for s in ("", "_reverse")]
              for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    assert all(torch.equal(a, b) for a, b in zip(
        btc_operands(*leaves, dtype), (w_ih, bias, w, bn)))


@pytest.mark.parametrize("mode,entry", [
    ("no_grad", "btc"), ("inference_mode", "btc"), ("frozen leaves", "btc"),
    ("prepared", "btc"), ("autograd", "contract"),
    ("input requires grad", "contract")])
def test_torch_gru_takes_the_btc_entry_where_autograd_records_nothing(
        monkeypatch, mode, entry):
    """The rule: ``TorchGRU`` runs each layer through ``gru_layer_btc``
    where autograd records nothing (grad mode off, or no leaf and no input
    requiring grad) and through ``gru_bidirectional`` (K2 with its
    backward) elsewhere; counted by wrappers of both entries (on the card
    their launch counters, ``tests/test_torch_cuda.py``).  Both give the
    same output within fp32 rounding; operands kept from an earlier call
    (``inference_operands``, outside the state dict) the same bits as
    built ones."""
    from speech_intent_recognizer_tpu_torch.models import cnn_gru

    _, model = _nn_gru(torch.float32, layers=2)
    x = torch.randn(3, 4, 12)
    with torch.no_grad():
        want = model(x)
    calls = {"btc": 0, "contract": 0}
    for name, key in (("gru_layer_btc", "btc"),
                      ("gru_bidirectional", "contract")):
        def counted(*a, _f=getattr(cnn_gru, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(cnn_gru, name, counted)
    keys = set(model.state_dict())
    if mode == "no_grad":
        with torch.no_grad():
            got = model(x)
    elif mode == "inference_mode":
        with torch.inference_mode():
            got = model(x)
    elif mode == "frozen leaves":
        model.requires_grad_(False)
        got = model(x)
    elif mode == "prepared":
        model.inference_operands()
        assert set(model.state_dict()) == keys
        with torch.no_grad():
            got = model(x)
    elif mode == "autograd":
        got = model(x)
    else:
        model.requires_grad_(False)
        got = model(x.requires_grad_())
    assert calls == {"btc": 2 * (entry == "btc"),
                     "contract": 2 * (entry == "contract")}
    if mode == "prepared":
        assert torch.equal(got, want)
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=1e-6)


def _load_other(model):
    other = {k: v * 1.25 for k, v in model.state_dict().items()}
    model.load_state_dict(other)


def _step(model):
    with torch.no_grad():
        model.weight_hh_l1_reverse.add_(0.125)


def _replace(model):
    model.bias_ih_l0.data = model.bias_ih_l0.detach() + 0.5


def _to_double(model):
    model.to(torch.float64)


@pytest.mark.parametrize("change", [None, _load_other, _step, _replace,
                                    _to_double],
                         ids=["unchanged", "load_state_dict", "in_place",
                              "data", "to_dtype"])
def test_kept_operands_follow_the_leaves(change):
    """``TorchGRU.inference_operands`` keeps the operands of the no-grad
    path from one call to the next, the same tensors, built outside
    inference mode; once a leaf changes (``load_state_dict``, an in-place
    step, ``.data =``, ``.to()``) the next call builds them anew, and the
    output is bit for bit that of a fresh model with the changed leaves."""
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import TorchGRU

    _, model = _nn_gru(torch.float32, layers=2)
    x = torch.randn(3, 4, 12)
    with torch.inference_mode():
        model(x)
    kept = [t for layer in model.inference_operands() for t in layer]
    assert not any(t.is_inference() for t in kept)
    if change is not None:
        change(model)
    with torch.no_grad():
        got = model(x)
    now = [t for layer in model.inference_operands() for t in layer]
    assert all(a is b for a, b in zip(kept, now)) == (change is None)
    fresh = TorchGRU(12, 32, 2, dropout=0.0).eval()
    fresh.load_state_dict({k: v.float() for k, v in
                           model.state_dict().items()})
    with torch.no_grad():
        assert torch.equal(got, fresh(x))


def test_btc_entry_refuses_what_autograd_records():
    from speech_intent_recognizer_tpu_torch.ops.gru import gru_layer_btc

    gx = torch.zeros((2, 3, 192), requires_grad=True)
    w, bn = torch.zeros((2, 32, 96)), torch.zeros((2, 1, 32))
    with pytest.raises(ValueError, match="no backward"):
        gru_layer_btc(gx, w, bn)
    with pytest.raises(ValueError, match=r"\(B, T, 6H\)"):
        gru_layer_btc(torch.zeros((2, 3, 100)), w, bn)
    with torch.no_grad():
        assert gru_layer_btc(gx, w, bn).shape == (2, 3, 64)
