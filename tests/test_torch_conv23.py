"""K5, conv2 + conv3 in one kernel: the port's plain version against the JAX
package's Pallas kernel (interpret mode off the TPU) at full width, B=5 —
K5's geometry is fixed, so its small size is the batch — with the weights
carried across by ``convert.jax_bridge``.  Bar ``0.02 * max|want|``
(tests/test_conv23_pallas.py:73-74).  The ``conv23`` form's tail on K5's
sheet against the Flax ``conv_external`` head within atol / rtol 3e-2 and
equal argmax (:100-101)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu.models import cnn_gru as ref
from speech_intent_recognizer_tpu.ops.conv23_pallas import (
    conv23_operands as jax_conv23_operands, conv23_pallas)
from speech_intent_recognizer_tpu_torch.convert.jax_bridge import (
    conv_stages_from_jax, from_jax_variables)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
    CNNAudioGRU, conv23_params, conv_external_params, fold_batchnorm)
from speech_intent_recognizer_tpu_torch.ops.conv23 import (
    W2_SHAPE, W3_SHAPE, _conv23_plain, _unpack, conv23, conv23_operands)


@pytest.fixture
def rng():
    """A generator per test: inputs do not depend on the order of tests."""
    return np.random.default_rng(103)


@pytest.fixture(scope="module")
def folded():
    """BN-folded Flax params with non-trivial statistics, as numpy."""
    raw = ref.init_model(ref.CNNAudioGRU(num_classes=31), jax.random.key(4))
    params = jax.tree.map(np.array, raw["params"])
    stats = jax.tree.map(np.array, raw["batch_stats"])
    r = np.random.default_rng(13)
    for i in (1, 2, 3):
        c = stats[f"bn{i}"]["mean"].shape[0]
        stats[f"bn{i}"] = {
            "mean": (0.1 * r.standard_normal(c)).astype(np.float32),
            "var": r.uniform(0.5, 2.0, c).astype(np.float32)}
    return (params, stats,
            jax.tree.map(np.asarray, ref.fold_batchnorm(params, stats)))


def test_kernel_matches_jax_kernel(folded, rng):
    _, _, f = folded
    _, _, (k2, b2), (k3, b3) = ref.conv_external_params(f)
    x = np.array(jnp.asarray(
        np.abs(rng.standard_normal((5, 100, 1024))).astype(np.float32),
        jnp.bfloat16).astype(jnp.float32))  # bf16-valued, writable
    want = np.asarray(conv23_pallas(
        jnp.asarray(x, jnp.bfloat16), *jax_conv23_operands(k2, b2, k3, b3)),
        np.float32)
    ops = conv23_operands(*conv_stages_from_jax(
        (np.asarray(k2), np.asarray(b2)), (np.asarray(k3), np.asarray(b3))))
    conv23.launches = 0
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = conv23(xt, *ops)
    assert got.shape == (5, 25, 1024) and got.dtype == torch.bfloat16
    assert conv23.launches == 0
    assert torch.equal(got, _conv23_plain(xt, *ops))
    scale = np.abs(want).max()
    assert scale > 0.1
    assert np.abs(got.float().numpy() - want).max() < 0.02 * scale


def test_kernel_matches_the_variant_models_conv_stages(folded, rng):
    """The other orientation: the conv1_external variant's own conv2 / conv3
    (transposed kernels over (time, mel)) give the same sheet."""
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
        conv1_external_params)

    params, stats, _ = folded
    state = fold_batchnorm(from_jax_variables(params, stats))
    var_state, _, _ = conv1_external_params(state)
    variant = CNNAudioGRU(31, compute_dtype=torch.bfloat16, fold_bn=True,
                          conv1_external=True)
    variant.load_state_dict(var_state)
    x = torch.from_numpy(np.abs(rng.standard_normal((2, 100, 1024)))
                         .astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        y = x.view(2, 100, 32, 32).permute(0, 3, 1, 2)
        for i in (2, 3):
            y = variant._conv(i, y)
    want = y.permute(0, 2, 3, 1).reshape(2, 25, 1024).float()
    _, _, (w2, b2), (w3, b3) = conv_external_params(state)
    got = conv23(x, *conv23_operands(w2, b2, w3, b3)).float()
    assert float((got - want).abs().max()) < 0.02 * float(want.abs().max())


def test_operands_layout_and_validation():
    g = torch.Generator().manual_seed(0)
    w2 = torch.randn((64, 32, 3, 3), generator=g)
    w3 = torch.randn((128, 64, 3, 3), generator=g)
    p2, b2, p3, b3 = conv23_operands(w2, torch.zeros(64), w3,
                                     torch.zeros(128))
    assert p2.shape == W2_SHAPE == (9, 2, 8, 2, 8, 8)
    assert p3.shape == W3_SHAPE == (9, 4, 16, 2, 8, 8)
    assert p2.dtype == p3.dtype == torch.bfloat16
    assert b2.dtype == b3.dtype == torch.float32
    # [tap = kt * 3 + km][kk][j][h][r][e] = w[8 j + r, 16 kk + 8 h + e, km,
    # kt] of the (O, I, km, kt) reference layout: tap (kt 1, km 2), input
    # channel 16 + 8 + 3, output channel 8 * 5 + 6
    assert p2[1 * 3 + 2, 1, 5, 1, 6, 3] == w2[46, 27, 2, 1].to(torch.bfloat16)
    # one k-step's B tile is 64 x 16 values, contiguous
    assert p2[0, 0].numel() * 2 == 2048 and p3[0, 0].numel() * 2 == 4096
    assert torch.equal(_unpack(p2), w2.to(torch.bfloat16).float())
    assert torch.equal(_unpack(p3), w3.to(torch.bfloat16).float())
    with pytest.raises(ValueError, match=r"\(32, 64, 128\)"):
        conv23_operands(torch.zeros((64, 16, 3, 3)), torch.zeros(64), w3,
                        torch.zeros(128))


@pytest.mark.parametrize("shape", [(2, 98, 1024), (2, 100, 512)])
def test_rejects_other_geometry(shape):
    """T1 % 4 != 0 or width != 1024 raises, as conv23_pallas.py:235-236."""
    ops = conv23_operands(torch.zeros((64, 32, 3, 3)), torch.zeros(64),
                          torch.zeros((128, 64, 3, 3)), torch.zeros(128))
    with pytest.raises(ValueError, match="4k, 1024"):
        conv23(torch.zeros(shape, dtype=torch.bfloat16), *ops)
    with pytest.raises(ValueError):
        conv23_pallas(jnp.zeros(shape, jnp.bfloat16), *jax_conv23_operands(
            np.zeros((3, 3, 32, 64)), np.zeros(64), np.zeros((3, 3, 64, 128)),
            np.zeros(128)))


def test_conv_external_head_matches_flax(folded, rng, monkeypatch):
    """The ``conv23`` form after K5 (GRU + attention + fc on K5's sheet,
    K5 standing in as the sheet itself), bf16 compute, weights through the
    bridge, against the Flax ``conv_external`` head on that sheet."""
    from speech_intent_recognizer_tpu_torch.ops import conv23 as k5

    params, stats, f = folded
    head_params, _, _, _ = ref.conv_external_params(f)
    head_params = jax.tree.map(np.asarray, head_params)
    x = np.abs(rng.standard_normal((3, 25, 1024))).astype(np.float32)
    want = np.asarray(ref.CNNAudioGRU(
        num_classes=31, compute_dtype=jnp.bfloat16, fold_bn=True,
        conv_external=True).apply(
        {"params": head_params}, jnp.asarray(x, jnp.bfloat16), train=False))
    form = CNNAudioGRU(31, compute_dtype=torch.bfloat16, fold_bn=True,
                       conv1_external=True, conv23=True)
    state, _, _ = conv23_params(fold_batchnorm(from_jax_variables(
        params, stats)))
    head_state = from_jax_variables(head_params)
    assert not any(k.startswith("conv") for k in head_state)
    for k, v in head_state.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    form.load_state_dict(state)
    sheet = torch.from_numpy(x).to(torch.bfloat16)
    k1 = torch.zeros((3, 100, 1024), dtype=torch.bfloat16)
    monkeypatch.setattr(k5, "conv23", lambda *a, **kw: sheet)
    with torch.no_grad():
        got = form.eval()(k1).numpy()
    assert (got.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)
    # the 4-D form of K1's sheet is taken too
    with torch.no_grad():
        again = form(k1.view(3, 100, 32, 32)).numpy()
    np.testing.assert_array_equal(again, got)
