"""The arithmetic and the index maps of the warp-resident real-input FFT
(``speech_intent_recognizer_tpu_torch/csrc/warp_rfft.cuh``), modelled in
NumPy where no card is present.

The model below is the kernel's decomposition step by step: one "warp" of
32 lanes, each holding V = n_fft / 64 complex registers; even / odd packing
of the windowed frame; radix-8 passes 1 and 2 and the radix-R3 pass 3, with
the pass twiddles taken from the same host table the kernel receives
(``FrontendParams.twiddle``) by the same index rule; both exchanges through
one buffer at the kernel's padded addresses (the buffer starts as NaN, so a
read of an address nobody wrote shows); the partner exchange of the untangle
by lane; bins 0 and n_fft / 2.  It is held against ``numpy.fft.rfft`` in
float64 (1e-10) and in float32 at K4's bar on dB-mel (rtol / atol 1e-4).
The kernel itself is held against its plain version on the card
(``tests/test_torch_cuda.py``)."""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from speech_intent_recognizer_tpu_torch import _build
from speech_intent_recognizer_tpu_torch.config import AudioConfig
from speech_intent_recognizer_tpu_torch.ops import frontend_kernels as fk
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    make_frontend_params)

LANES = np.arange(32)


class Plan:
    """``sir_fft::Plan<LOG2N>``."""

    def __init__(self, n_fft):
        self.n = n_fft
        self.m = n_fft // 2
        self.v = self.m // 32
        self.m2 = self.m // 8
        self.r3 = self.m // 64
        self.j = self.m2 // 32
        self.i2 = self.r3 // 4
        self.y_stride = self.m2 + 2
        self.u_stride = self.m2 + 8
        self.xbuf = 8 * self.u_stride


def root_of(twiddle, e, plan):
    """``sir_fft::root_of``: W_N^e from the half table W_N^k, k < N/2."""
    e = np.asarray(e) & (plan.n - 1)
    w = twiddle[e % plan.m]
    return np.where(e < plan.m, w, -w)


def pass_tables(twiddle, plan):
    """``sir_fft::load_tables``: tw1[(k1-1) M2 + n'] = W_M^{n' k1} and
    tw2[(k2-1) R3 + n''] = W_M2^{n'' k2}, both read out of ``twiddle``."""
    i = np.arange(7 * plan.m2)
    tw1 = root_of(twiddle, 2 * (1 + i // plan.m2) * (i % plan.m2), plan)
    i = np.arange(7 * plan.r3)
    tw2 = root_of(twiddle, (plan.n // plan.m2) * (1 + i // plan.r3)
                  * (i % plan.r3), plan)
    return tw1, tw2


def mul_root(v, k, r):
    """``sir_fft::mul_root``: v * e^{-2 pi i k / r} with the kernel's
    literal constants (rounded to the working precision)."""
    h = v.real.dtype.type(0.70710678118654752440)
    c = v.real.dtype.type(0.92387953251128675613)
    s = v.real.dtype.type(0.38268343236508977173)
    x, y = v.real, v.imag

    def cmul(wr, wi):
        return (x * wr - y * wi) + 1j * (x * wi + y * wr)

    case = k * (16 // r)
    out = {0: lambda: v, 1: lambda: cmul(c, -s),
           2: lambda: h * (x + y) + 1j * (h * (y - x)),
           3: lambda: cmul(s, -c), 4: lambda: y + 1j * (-x),
           5: lambda: cmul(-s, -c),
           6: lambda: h * (y - x) + 1j * (-h * (x + y)),
           7: lambda: cmul(-c, -s)}[case]()
    return out.astype(v.dtype)


def dft(a):
    """``sir_fft::dft<R>``: a is a list of R per-lane arrays."""
    r = len(a)
    if r == 2:
        return [a[0] + a[1], a[0] - a[1]]
    e, o = dft(a[0::2]), dft(a[1::2])
    t = [mul_root(o[k], k, r) for k in range(r // 2)]
    return ([e[k] + t[k] for k in range(r // 2)]
            + [e[k] - t[k] for k in range(r // 2)])


def cmul(a, w):
    """``sir_fft::cmul`` in a's precision (no fused operations)."""
    return ((a.real * w.real - a.imag * w.imag)
            + 1j * (a.real * w.imag + a.imag * w.real)).astype(a.dtype)


def warp_rfft_power(frame, window, twiddle, ctype, accesses=None):
    """``sir_fft::warp_rfft_power`` on one raw frame: (n_fft / 2 + 1,)
    power spectrum in the real type of ``ctype``.  ``accesses`` collects
    (what, addresses-of-the-32-lanes) of every exchange access."""
    plan = Plan(len(frame))
    rtype = np.zeros(1, ctype).real.dtype
    window = window.astype(rtype)
    twiddle = (twiddle[:, 0] + 1j * twiddle[:, 1]).astype(ctype)
    tw1, tw2 = pass_tables(twiddle, plan)
    frame = frame.astype(rtype)

    def note(what, addr):
        if accesses is not None:
            accesses.append((what, np.asarray(addr)))

    # registers: v[r][lane] = z[lane + 32 r], windowed (even, odd) pairs
    n = LANES[None, :] + 32 * np.arange(plan.v)[:, None]
    v = ((frame[2 * n] * window[2 * n])
         + 1j * (frame[2 * n + 1] * window[2 * n + 1])).astype(ctype)
    xbuf = np.full(plan.xbuf, np.nan + 1j * np.nan, ctype)
    k1, hi = LANES & 7, LANES >> 3

    for j in range(plan.j):  # pass 1
        a = dft([v[j + plan.j * n1] for n1 in range(8)])
        np_ = LANES + 32 * j
        for q in range(8):
            addr = q * plan.y_stride + np_
            note("pass 1 write", addr)
            xbuf[addr] = a[q] if q == 0 else cmul(
                a[q], tw1[(q - 1) * plan.m2 + np_])

    for i in range(plan.i2):  # pass 2, loads
        npp = hi + 4 * i
        for n2 in range(8):
            addr = k1 * plan.y_stride + n2 * plan.r3 + npp
            note("pass 2 read", addr)
            v[8 * i + n2] = xbuf[addr]
    assert not np.isnan(v).any()
    xbuf[:] = np.nan
    for i in range(plan.i2):  # pass 2, butterflies and stores
        npp = hi + 4 * i
        a = dft([v[8 * i + n2] for n2 in range(8)])
        for q in range(8):
            addr = k1 + 8 * npp + q * plan.u_stride
            note("pass 2 write", addr)
            xbuf[addr] = a[q] if q == 0 else cmul(
                a[q], tw2[(q - 1) * plan.r3 + npp])

    for i in range(2):  # pass 3
        base = k1 + (hi + 4 * i) * plan.u_stride
        a = []
        for npp in range(plan.r3):
            note("pass 3 read", base + 8 * npp)
            a.append(xbuf[base + 8 * npp])
        a = dft(a)
        for kpp in range(plan.r3):
            v[i + 2 * kpp] = a[kpp]
    assert not np.isnan(v).any()

    # untangle: partner Z[M - k] from lane (32 - lane) % 32
    src = (32 - LANES) & 31
    pw = np.zeros(plan.m + 1, rtype)
    half = rtype.type(0.5)
    for r in range(plan.v):
        mine = np.where(LANES == 0, v[(plan.v - r) % plan.v],
                        v[plan.v - 1 - r])
        p = mine[src]
        z, w = v[r], twiddle[LANES + 32 * r]
        ar, ai = half * (z.real + p.real), half * (z.imag - p.imag)
        br, bi = half * (z.real - p.real), half * (z.imag + p.imag)
        xr = ar + (w.real * bi + w.imag * br)
        xi = ai - (w.real * br - w.imag * bi)
        pw[LANES + 32 * r] = xr * xr + xi * xi
    x = v[0][0].real - v[0][0].imag
    pw[plan.m] = x * x
    return pw


def frames_for(n_fft, seed=0):
    rng = np.random.default_rng(seed + n_fft)
    t = np.arange(n_fft)
    return {
        "noise": rng.standard_normal(n_fft),
        "zero": np.zeros(n_fft),
        "dc": np.ones(n_fft),
        "nyquist": np.where(t % 2 == 0, 1.0, -1.0),
        "tone": np.sin(2 * np.pi * 0.0731 * t + 0.3),
        "speech_like": 0.25 * np.sin(2 * np.pi * 220.0 * t / 16000.0)
        + 0.05 * rng.standard_normal(n_fft),
    }


def params_for(n_fft):
    # a window shorter than n_fft at 2048, as the card tests use
    kw = {512: dict(n_fft=512, hop_length=256, n_mels=40), 1024: dict(),
          2048: dict(n_fft=2048, win_length=1200, n_mels=80)}[n_fft]
    return make_frontend_params(AudioConfig(**kw))


SIGNALS = ["noise", "zero", "dc", "nyquist", "tone", "speech_like"]


def test_new_path_sizes():
    assert fk.WARP_FFT_SIZES == (512, 1024, 2048)


@pytest.mark.parametrize("signal", SIGNALS)
@pytest.mark.parametrize("n_fft", fk.WARP_FFT_SIZES)
def test_model_matches_rfft_float64(n_fft, signal):
    """In float64 with float64 tables the decomposition is the rDFT: every
    bin's power within 1e-10 of numpy's, relative to the largest bin."""
    fe = params_for(n_fft)
    frame = frames_for(n_fft)[signal]
    window = fe.window.numpy().astype(np.float64)
    k = np.arange(n_fft // 2)
    twiddle = np.stack([np.cos(2 * np.pi * k / n_fft),
                        -np.sin(2 * np.pi * k / n_fft)], axis=1)
    got = warp_rfft_power(frame, window, twiddle, np.complex128)
    want = np.abs(np.fft.rfft(frame * window)) ** 2
    assert got.shape == want.shape == (n_fft // 2 + 1,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * max(want.max(), 1.0))


@pytest.mark.parametrize("signal", SIGNALS)
@pytest.mark.parametrize("n_fft", fk.WARP_FFT_SIZES)
def test_model_float32_within_k4_bar(n_fft, signal):
    """In float32 with the float32 tables the kernel receives: every bin's
    power within 2e-6 of the float64 rDFT's, relative to the largest bin
    (float32 rounding of the strongest component), and the dB-mel row within
    K4's bar (rtol / atol 1e-4 dB) on every band of the broadband signals;
    on the pure signals (DC, Nyquist, tone) on the bands within 30 dB of
    the strongest, since below that a band of a pure signal holds float32
    rounding noise of the peak in any float32 transform.  A silent frame
    has power exactly 0 in every bin, so its row is the dB floor."""
    fe = params_for(n_fft)
    frame = frames_for(n_fft)[signal].astype(np.float32)
    pw = warp_rfft_power(frame, fe.window.numpy(), fe.twiddle.numpy(),
                         np.complex64)
    assert pw.dtype == np.float32
    fb = fe.mel_fb.numpy()
    got = 10.0 * np.log10(np.maximum(pw @ fb, np.float32(1e-10)))
    want_pw = np.abs(np.fft.rfft(frame.astype(np.float64)
                                 * fe.window.numpy().astype(np.float64))) ** 2
    np.testing.assert_allclose(pw, want_pw, rtol=0,
                               atol=2e-6 * max(want_pw.max(), 1e-30))
    want = 10.0 * np.log10(np.maximum(want_pw @ fb.astype(np.float64), 1e-10))
    held = np.ones(len(want), bool) if signal in ("noise", "speech_like",
                                                   "zero") \
        else want >= want.max() - 30.0
    assert held.any()
    np.testing.assert_allclose(got[held], want[held], rtol=1e-4, atol=1e-4)
    if signal == "zero":  # no rounding noise: the clamp gives the floor
        floor = 10.0 * np.log10(np.float32(1e-10))
        assert (pw == 0).all() and (got == floor).all()


@pytest.mark.parametrize("n_fft", fk.WARP_FFT_SIZES)
def test_host_twiddle_is_the_untangle_factor(n_fft):
    """``FrontendParams.twiddle`` is (cos, -sin) of 2 pi k / n_fft for
    k < n_fft / 2, float64 rounded to float32, and the pass tables read out
    of it are the float32 roundings of W_M^{n' k1} and W_M2^{n'' k2}."""
    fe = params_for(n_fft)
    plan = Plan(n_fft)
    tw = fe.twiddle.numpy()
    k = np.arange(n_fft // 2)
    assert tw.shape == (n_fft // 2, 2) and tw.dtype == np.float32
    np.testing.assert_array_equal(
        tw[:, 0], np.cos(2 * np.pi * k / n_fft).astype(np.float32))
    np.testing.assert_array_equal(
        tw[:, 1], (-np.sin(2 * np.pi * k / n_fft)).astype(np.float32))
    tw1, tw2 = pass_tables(tw[:, 0] + 1j * tw[:, 1], plan)
    k1, np_ = np.divmod(np.arange(7 * plan.m2), plan.m2)
    want1 = np.exp(-2j * np.pi * (k1 + 1) * np_ / plan.m)
    k2, npp = np.divmod(np.arange(7 * plan.r3), plan.r3)
    want2 = np.exp(-2j * np.pi * (k2 + 1) * npp / plan.m2)
    np.testing.assert_allclose(tw1, want1, rtol=0, atol=6e-8)
    np.testing.assert_allclose(tw2, want2, rtol=0, atol=6e-8)


@pytest.mark.parametrize("n_fft", fk.WARP_FFT_SIZES)
def test_exchange_addresses_fit_and_spread_over_the_banks(n_fft):
    """Every exchange access stays inside the warp's buffer, a pass's
    stores never collide, and the 16 lanes of each half-warp (the unit an
    8-byte shared-memory access is served in) hit 16 different bank pairs:
    no access is replayed."""
    fe = params_for(n_fft)
    plan = Plan(n_fft)
    accesses = []
    warp_rfft_power(frames_for(n_fft)["noise"].astype(np.float32),
                    fe.window.numpy(), fe.twiddle.numpy(), np.complex64,
                    accesses)
    assert plan.m + 1 <= 2 * plan.xbuf  # the power row fits over the buffer
    for what in ("pass 1 write", "pass 2 read", "pass 2 write", "pass 3 read"):
        addrs = [a for w, a in accesses if w == what]
        assert len(addrs) == plan.v, what
        flat = np.concatenate(addrs)
        assert flat.min() >= 0 and flat.max() < plan.xbuf, what
        assert len(np.unique(flat)) == plan.m, what  # a bijection on M values
        for a in addrs:
            for half in (a[:16], a[16:]):
                assert len(np.unique(half % 16)) == 16, (what, half)


def test_entry_points_match_their_ctypes_signatures():
    """Every ``extern "C"`` entry point of ``csrc/*.cu`` has its argtypes in
    ``_build._SIGNATURES`` and the other way round, with as many arguments
    and a pointer type exactly where the C parameter is a pointer (ctypes
    would cut a pointer passed as an int)."""
    found = {}
    for path in glob.glob(os.path.join(os.path.dirname(_build.__file__),
                                       "csrc", "*.cu")):
        with open(path) as f:
            src = f.read()
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
            found[name] = ["*" in a for a in args.split(",")]
    assert set(found) == set(_build._SIGNATURES)
    for name, pointers in found.items():
        argtypes = _build._SIGNATURES[name]
        assert [t is _build._P for t in argtypes] == pointers, name


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_variants_bench_edits_match_the_sources(tmp_path):
    """``bench_torch_fft_variants.py`` builds its variants by replacing
    lines of the kernels' sources: every replacement still matches the
    sources exactly once and changes them, and importing the script loads
    no JAX and nothing of the JAX package."""
    code = f"""
import filecmp, os, shutil, sys
import bench_torch_fft_variants as b
changed = 0
for i, name in enumerate(b.VARIANTS):
    src = os.path.join({str(tmp_path)!r}, f'v{{i}}')
    shutil.copytree(b.CSRC, src)
    b.apply_edits(name, src)
    same = filecmp.dircmp(b.CSRC, src)
    assert bool(same.diff_files) == bool(b.VARIANTS[name][1]), name
    changed += bool(same.diff_files)
assert changed >= 10, changed
bad = sorted(m for m in sys.modules if m.split('.')[0] in
             ('jax', 'jaxlib', 'flax', 'optax', 'speech_intent_recognizer_tpu'))
assert not bad, bad
"""
    r = _python(["-c", code], REPO)
    assert r.returncode == 0, r.stdout + r.stderr


def test_variants_bench_fails_without_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the host without one")
    r = _python([os.path.join(REPO, "bench_torch_fft_variants.py")], REPO)
    assert r.returncode != 0 and " ms" not in r.stdout
