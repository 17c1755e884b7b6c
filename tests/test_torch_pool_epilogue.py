"""K6, the conv epilogue ``maxpool2x2(relu(y + bias))``: the port's plain
version against the JAX package's Pallas kernel (interpret mode off the TPU)
on the same numpy inputs.  float32 exact, as tests/test_pool_epilogue.py
holds the JAX kernel to numpy; bfloat16 within one rounding of the output,
``max|want| * 2**-8``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu.ops.pool_epilogue_pallas import (
    bias_relu_pool2_pallas)
from speech_intent_recognizer_tpu_torch.ops.pool_epilogue import (
    _bias_relu_pool2_plain, bias_relu_pool2)

@pytest.fixture
def rng():
    """A generator per test: inputs do not depend on the order of tests."""
    return np.random.default_rng(101)


SHAPES = [(3, 100, 32, 64), (2, 50, 16, 128), (9, 8, 4, 64), (1, 2, 4, 32)]


def _port(y: np.ndarray, bias: np.ndarray, dtype) -> np.ndarray:
    """(B, T, W, C) numpy in, through the port's (B, C, T, W)
    channels-last contract, (B, T/2, W/2, C) float32 numpy out."""
    yt = torch.from_numpy(y).to(dtype).permute(0, 3, 1, 2)
    out = bias_relu_pool2(yt, torch.from_numpy(bias))
    assert out.dtype == dtype
    return out.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_equals_jax_kernel(rng, shape):
    y = rng.standard_normal(shape).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(bias_relu_pool2_pallas(jnp.asarray(y),
                                             jnp.asarray(bias)))
    got = _port(y, bias, torch.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_bf16_within_one_rounding_of_jax_kernel(rng, shape):
    y = rng.standard_normal(shape).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(bias_relu_pool2_pallas(
        jnp.asarray(y, jnp.bfloat16), jnp.asarray(bias)), np.float32)
    got = _port(y, bias, torch.bfloat16)
    assert np.abs(got - want).max() <= np.abs(want).max() * 2.0 ** -8


@pytest.mark.parametrize("shape", [(1, 64, 9, 32),    # odd T
                                   (1, 64, 10, 12),   # W not a power of two
                                   (1, 64, 4, 2),     # W < 4
                                   (1, 24, 4, 4)])    # W * C % 128 != 0
def test_geometry_validation(shape):
    """The JAX wrapper's geometry rule (pool_epilogue_pallas.py:175-177), on
    (B, C, T, W) here."""
    with pytest.raises(ValueError, match="geometry"):
        bias_relu_pool2(torch.zeros(shape), torch.zeros(shape[1]))


def test_jax_kernel_rejects_the_same_geometries():
    for shape in ((1, 9, 32, 64), (1, 10, 12, 64)):  # (B, T, W, C)
        with pytest.raises(ValueError):
            bias_relu_pool2_pallas(jnp.zeros(shape), jnp.zeros(shape[-1]))


def test_negative_zero_and_nan():
    """What the docstring promises of the plain version as of the kernel:
    a window of negatives and -0.0 gives zero, NaN passes through."""
    y = torch.full((1, 32, 2, 4), -1.0)
    y[0, :, 0, 0] = -0.0
    y[0, 0, 1, 3] = float("nan")
    out = bias_relu_pool2(y.contiguous(memory_format=torch.channels_last),
                          torch.zeros(32))
    assert out.shape == (1, 32, 1, 2)
    assert torch.isnan(out[0, 0, 0, 1])
    flat = out.flatten()
    assert bool((flat[~torch.isnan(flat)] == 0).all())


def test_inference_only():
    y = torch.zeros((1, 32, 2, 4), requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        bias_relu_pool2(y, torch.zeros(32))
    with torch.no_grad():
        assert bias_relu_pool2(y, torch.zeros(32)).shape == (1, 32, 1, 2)


def test_plain_version_is_what_cpu_tensors_take(rng):
    y = torch.from_numpy(rng.standard_normal((2, 32, 4, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    bias_relu_pool2.launches = 0
    assert torch.equal(bias_relu_pool2(y, b), _bias_relu_pool2_plain(y, b))
    assert bias_relu_pool2.launches == 0
