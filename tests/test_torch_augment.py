"""The port's waveform augmentation against the JAX package's on the same
numpy inputs: the apply step fed the draws that JAX ``augment_waveforms``
makes from its key, the scalar goldens, and the draw step's ranges."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu.ops import augment as ref
from speech_intent_recognizer_tpu_torch.ops import augment as port

# waveforms: the JAX batched path is matmuls at HIGHEST precision, the port
# gathers and two products; 1e-5 of full scale.  Lengths exactly.
WAVE_BAR = 1e-5
WIDTH = 3000
# one compile per batch shape (eager dispatch compiles every op per shape)
ref_augment = jax.jit(ref.augment_waveforms)
ref_shift = jax.jit(ref.batched_time_shift)
ref_fixed = jax.jit(ref._resample_fixed, static_argnums=1)
ref_bank = jax.jit(ref._resample_bank)


def jax_draws(key, b, n, shift_limit=0.1, noise_range=(1e-3, 1e-2),
              speed_range=(0.85, 1.15), pitch_semitones=2.0):
    """The draws of ``ops/augment.py:augment_waveforms`` (:188-229), by the
    same split / uniform / normal calls, as the port's AugmentDraws."""
    ks = jax.random.split(key, 10)
    u = np.stack([np.asarray(jax.random.uniform(ks[i], (b,)))
                  for i in range(4)])

    def uniform(i, lo, hi):
        return torch.from_numpy(np.array(jax.random.uniform(
            ks[i], (b,), minval=lo, maxval=hi)))

    return port.AugmentDraws(
        gates=torch.from_numpy(u),
        outer=torch.from_numpy(np.array(jax.random.uniform(ks[4], (b,)))),
        shift_frac=uniform(5, -shift_limit, shift_limit),
        semitones=uniform(6, -pitch_semitones, pitch_semitones),
        speed=uniform(7, *speed_range), level=uniform(8, *noise_range),
        noise=torch.from_numpy(np.array(jax.random.normal(ks[9], (b, n)))))


def waves_of(rng, lengths, n=WIDTH):
    """Rows zero beyond their lengths (the waveform cache's precondition)."""
    x = np.zeros((len(lengths), n), np.float32)
    for i, m in enumerate(lengths):
        x[i, :m] = 0.5 * rng.standard_normal(m)
    return x, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("seed,lengths", [
    (0, [WIDTH]),
    (1, [1, WIDTH, 2000, 37, 2999]),
    (2, [WIDTH, 1, 1500, 640, 2047, 100, 2999, 2500]),
    (3, [700, 1200, 1, WIDTH, WIDTH, 90, 2222, 1800]),
])
@pytest.mark.parametrize("prob", [0.0, 0.7, 1.0])
def test_apply_matches_jax_on_its_draws(seed, lengths, prob):
    """B = 1, 5, 8, rows of length 1 to full width: the port's apply step
    on the draws of JAX ``augment_waveforms`` (key ``jax.random.key(s)``)
    equals its output, waveforms within WAVE_BAR, lengths exactly."""
    rng = np.random.default_rng(seed)
    x, ln = waves_of(rng, lengths)
    key = jax.random.key(seed)
    want_x, want_ln = ref_augment(jnp.asarray(x), jnp.asarray(ln), key,
                                  augment_prob=prob)
    draws = jax_draws(key, len(lengths), WIDTH)
    got_x, got_ln = port.apply_augment(torch.from_numpy(x),
                                       torch.from_numpy(ln), draws,
                                       augment_prob=prob)
    assert got_ln.dtype == torch.int32
    np.testing.assert_array_equal(got_ln.numpy(), np.asarray(want_ln))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0,
                               atol=WAVE_BAR)
    if prob == 0.0:
        assert torch.equal(got_x, torch.from_numpy(x))


def test_every_sub_op_fires_against_jax():
    """Each sub-op alone equals the JAX batched op on the same rows: the
    shift at both signs, the resample at one rate for all rows and at a
    rate per row (B = 8, the shapes of the chain above)."""
    rng = np.random.default_rng(9)
    x, ln = waves_of(rng, [WIDTH, 1, 1500, 2999, 64, 2100, 800, 2500])
    b = len(ln)
    xt = torch.from_numpy(x)
    shifts = np.array([-300, 0, 149, -1, 7, 210, -2999, 2999], np.int32)
    got = port.batched_time_shift(xt, torch.from_numpy(shifts))
    want = ref_shift(jnp.asarray(x), jnp.asarray(shifts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=WAVE_BAR)
    for k in (55, 63, 64, 65, 73):
        got = port.batched_resample(xt, torch.full((b,), k))
        want = ref_fixed(jnp.asarray(x), k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=WAVE_BAR, err_msg=f"k={k}")
    ks = torch.tensor([55, 73, 64, 60, 70, 58, 66, 71])
    got = port.batched_resample(xt, ks)
    want = ref_bank(jnp.asarray(x), jnp.asarray(ks.numpy() - 55))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=WAVE_BAR)


@pytest.mark.parametrize("shift", [-250, -1, 0, 1, 333])
def test_time_shift_matches_jax_golden(shift):
    rng = np.random.default_rng(abs(shift))
    x = rng.standard_normal(1000).astype(np.float32)
    for length in (1000, 600, 1):
        got = port.time_shift(torch.from_numpy(x), length, shift)
        want = ref.time_shift(jnp.asarray(x), length, shift)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [55, 64, 73])
def test_linear_resample_matches_jax_golden(k):
    """The scalar goldens agree, and on a row zero beyond its length the
    batched gather equals the golden (the JAX package's precondition)."""
    rng = np.random.default_rng(k)
    x = np.zeros(2000, np.float32)
    x[:1500] = rng.standard_normal(1500)
    rate = k / 64
    got = port._linear_resample(torch.from_numpy(x), rate)
    want = ref._linear_resample(jnp.asarray(x), jnp.float32(rate))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    batched = port.batched_resample(torch.from_numpy(x)[None],
                                    torch.tensor([k]))[0]
    np.testing.assert_allclose(batched.numpy(), got.numpy(), rtol=0,
                               atol=1e-6)


def test_draws_cover_their_ranges_and_follow_the_generator():
    """The draw step's ranges are the JAX function's, and the same seed
    gives the same augmentation."""
    d = port.draw_augment(4096, 16, torch.Generator().manual_seed(0), "cpu")
    for t, lo, hi in ((d.gates, 0, 1), (d.outer, 0, 1),
                      (d.shift_frac, -0.1, 0.1), (d.semitones, -2, 2),
                      (d.speed, 0.85, 1.15), (d.level, 1e-3, 1e-2)):
        assert float(t.min()) >= lo and float(t.max()) <= hi
        assert float(t.max() - t.min()) > 0.95 * (hi - lo)
    assert d.noise.shape == (4096, 16)
    x = torch.randn((3, 500))
    ln = torch.tensor([500, 200, 1], dtype=torch.int32)
    a = port.augment_waveforms(x, ln, torch.Generator().manual_seed(5),
                               augment_prob=1.0)
    b = port.augment_waveforms(x, ln, torch.Generator().manual_seed(5),
                               augment_prob=1.0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
