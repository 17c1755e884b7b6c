"""The port's CNNAudioGRU against the Flax model in all three forms, on the
same weights moved by ``convert.jax_bridge.from_jax_variables`` (pinned to
the reference's ``export_torch_state_dict``).  fp32 logits within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu.convert.torch_export import (
    export_torch_state_dict)
from speech_intent_recognizer_tpu.models import cnn_gru as ref
from speech_intent_recognizer_tpu_torch.convert.jax_bridge import (
    from_jax_variables)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
    CNNAudioGRU, conv1_external_params, fold_batchnorm)


@pytest.fixture(scope="module")
def variables():
    """Flax init with non-trivial BatchNorm parameters and statistics."""
    raw = ref.init_model(ref.CNNAudioGRU(num_classes=31), jax.random.key(3))
    params = jax.tree.map(np.asarray, raw["params"])
    stats = jax.tree.map(np.asarray, raw["batch_stats"])
    r = np.random.default_rng(7)
    for i in (1, 2, 3):
        c = params[f"bn{i}"]["scale"].shape[0]
        params[f"bn{i}"] = {
            "scale": r.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": (0.1 * r.standard_normal(c)).astype(np.float32)}
        stats[f"bn{i}"] = {
            "mean": (0.1 * r.standard_normal(c)).astype(np.float32),
            "var": r.uniform(0.5, 2.0, c).astype(np.float32)}
    return params, stats


def test_bridge_matches_export(variables):
    params, stats = variables
    got = from_jax_variables(params, stats)
    want = export_torch_state_dict(params, stats)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


def _logits(model, state, x):
    model.load_state_dict(state)
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


def test_train_form_matches(variables, rng):
    params, stats = variables
    x = rng.standard_normal((3, 64, 200)).astype(np.float32)
    want = ref.CNNAudioGRU(num_classes=31).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    got = _logits(CNNAudioGRU(31), from_jax_variables(params, stats), x)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_folded_form_matches(variables, rng):
    params, stats = variables
    x = rng.standard_normal((3, 64, 200)).astype(np.float32)
    folded = jax.tree.map(np.asarray, ref.fold_batchnorm(params, stats))
    want = ref.CNNAudioGRU(num_classes=31, fold_bn=True).apply(
        {"params": folded}, jnp.asarray(x), train=False)
    state = fold_batchnorm(from_jax_variables(params, stats))
    for k, v in from_jax_variables(folded).items():  # the two folds agree
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    got = _logits(CNNAudioGRU(31, fold_bn=True), state, x)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_conv1_external_form_matches(variables, rng):
    params, stats = variables
    x = np.abs(rng.standard_normal((3, 100, 1024))).astype(np.float32)
    folded = jax.tree.map(np.asarray, ref.fold_batchnorm(params, stats))
    var_params, _, _ = ref.conv1_external_params(folded)
    want = ref.CNNAudioGRU(num_classes=31, fold_bn=True,
                           conv1_external=True).apply(
        {"params": jax.tree.map(np.asarray, var_params)}, jnp.asarray(x),
        train=False)
    var_state, c1w, c1b = conv1_external_params(
        fold_batchnorm(from_jax_variables(params, stats)))
    assert tuple(c1w.shape) == (32, 1, 3, 3) and tuple(c1b.shape) == (32,)
    got = _logits(CNNAudioGRU(31, fold_bn=True, conv1_external=True),
                  var_state, x)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_seeded_init_is_reproducible():
    a, b = CNNAudioGRU(31), CNNAudioGRU(31)
    a.reset_parameters(torch.Generator().manual_seed(0))
    b.reset_parameters(torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in a.parameters()) == 3_261_184
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k


def test_train_mode_dropout_uses_the_generator(rng):
    """In training the inter-layer GRU dropout draws from the caller's
    generator: same seed, same logits; eval mode has no dropout."""
    model = CNNAudioGRU(31)
    model.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.from_numpy(rng.standard_normal((2, 64, 200)).astype(np.float32))
    model.train()
    a = model(x, torch.Generator().manual_seed(5))
    b = model(x, torch.Generator().manual_seed(5))
    c = model(x, torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b)
    assert not torch.allclose(a, c)
    model.eval()
    with torch.no_grad():
        torch.testing.assert_close(model(x), model(x))
