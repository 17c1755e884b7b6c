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
    TILE_ROWS, gru_bidirectional, gru_layer, tile_rows)

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


@pytest.mark.parametrize("batch,sms,rows", [
    (1, 132, 4), (256, 132, 4), (1040, 132, 4), (1041, 132, 16),
    (2048, 132, 16), (2048, 264, 4), (64, 8, 16)])
def test_tile_rows_fills_every_sm(batch, sms, rows):
    """16-row tiles only where 2 * ceil(B / 16) blocks cover every SM."""
    assert tile_rows(batch, sms) == rows
    assert rows in TILE_ROWS
