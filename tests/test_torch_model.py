"""The port's CNNAudioGRU against the Flax model in all its forms, on the
same weights moved by ``convert.jax_bridge.from_jax_variables`` (pinned to
the reference's ``export_torch_state_dict``).  fp32 logits within 1e-4; the
``pool_impl="kernel"`` form against ``"torch"`` within 1e-5 on the same
state dict (tests/test_pool_epilogue.py:107-108 holds the JAX pair so)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu.convert.torch_export import (
    export_torch_state_dict)
from speech_intent_recognizer_tpu.models import cnn_gru as ref
from speech_intent_recognizer_tpu_torch.convert.jax_bridge import (
    conv_stages_from_jax, from_jax_variables)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
    CONV23_BUFFERS, CNNAudioGRU, conv1_external_params, conv23_params,
    conv_external_params, fold_batchnorm)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_impl_kernel_matches_torch(variables, dtype):
    """Same state-dict names for both epilogues; fp32 logits within 1e-5.
    In bf16 on the CPU the two forms round at different points (torch's
    CPU convolution adds the bias to its fp32 sum and rounds once; the
    kernel form rounds the raw sum, then the biased one, as the JAX kernel
    and the card's separate bias pass do), so they are held to the bf16 bar
    of this file's other bf16 comparisons, 3e-2.  The kernel form also
    against the Flax ``pool_impl="pallas"`` variant."""
    params, stats = variables
    var_state, _, _ = conv1_external_params(
        fold_batchnorm(from_jax_variables(params, stats)))
    x = np.abs(np.random.default_rng(21).standard_normal(
        (3, 100, 1024))).astype(np.float32)
    kw = dict(num_classes=31, compute_dtype=dtype, fold_bn=True,
              conv1_external=True)
    torch_form = CNNAudioGRU(**kw)
    kernel_form = CNNAudioGRU(pool_impl="kernel", **kw)
    assert list(kernel_form.state_dict()) == list(torch_form.state_dict())
    want = _logits(torch_form, var_state, x)
    got = _logits(kernel_form, var_state, x)
    np.testing.assert_allclose(
        got, want, atol=1e-5 if dtype == torch.float32 else 3e-2, rtol=0)
    folded = jax.tree.map(np.asarray, ref.fold_batchnorm(params, stats))
    var_params, _, _ = ref.conv1_external_params(folded)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    flax = np.asarray(ref.CNNAudioGRU(
        num_classes=31, compute_dtype=jdt, fold_bn=True, conv1_external=True,
        pool_impl="pallas").apply(
        {"params": jax.tree.map(np.asarray, var_params)}, jnp.asarray(x),
        train=False))
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(got, flax, rtol=tol, atol=tol)


def test_conv23_form_matches_torch_form(variables):
    """The bf16 ``conv23`` form (K5's plain version in its conv stage, on
    the operands :func:`conv23_params` packs) against the bf16 torch form
    on the same K1 sheet, at this file's bf16 bar; its state dict is the
    head's and K5's operands, no conv module."""
    params, stats = variables
    folded = fold_batchnorm(from_jax_variables(params, stats))
    x = np.abs(np.random.default_rng(22).standard_normal(
        (3, 100, 1024))).astype(np.float32)
    kw = dict(num_classes=31, compute_dtype=torch.bfloat16, fold_bn=True,
              conv1_external=True)
    k5_state, w1, b1 = conv23_params(folded)
    assert torch.equal(w1, folded["conv1.weight"])
    assert torch.equal(b1, folded["conv1.bias"])
    form = CNNAudioGRU(conv23=True, **kw)
    assert set(form.state_dict()) == set(k5_state)
    assert not any(k.startswith(("conv1.", "conv2.", "conv3."))
                   for k in k5_state)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    got = _logits(form, k5_state, x)
    want = _logits(CNNAudioGRU(**kw), conv1_external_params(folded)[0], x)
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=0)


def test_pool_impl_kernel_is_inference_only():
    model = CNNAudioGRU(31, fold_bn=True, conv1_external=True,
                        pool_impl="kernel")
    model.reset_parameters(torch.Generator().manual_seed(2))
    x = torch.zeros((1, 100, 1024))
    with pytest.raises(RuntimeError, match="inference-only"):
        model(x)
    with torch.no_grad():
        assert model(x).shape == (1, 31)


@pytest.mark.parametrize("kw,match", [
    (dict(fold_bn=True, pool_impl="pallas"), "pool_impl must be"),
    (dict(fold_bn=True, pool_impl="kernel"), "conv1_external"),
    (dict(fold_bn=True, conv23=True), "conv23 serves"),
    (dict(fold_bn=True, conv1_external=True, conv23=True), "conv23 serves"),
    (dict(fold_bn=True, conv1_external=True, compute_dtype=torch.bfloat16,
          conv_channels=(32, 48, 128), conv23=True), "conv23 serves"),
])
def test_form_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        CNNAudioGRU(31, **kw)


def test_conv_external_params_match_jax(variables):
    """The head's state dict and the three conv stages in their original
    orientation, against the JAX split carried through the bridge."""
    params, stats = variables
    folded = jax.tree.map(np.asarray, ref.fold_batchnorm(params, stats))
    head_params, *stages = ref.conv_external_params(folded)
    want_head = from_jax_variables(jax.tree.map(np.asarray, head_params))
    want_stages = conv_stages_from_jax(
        *[(np.asarray(k), np.asarray(b)) for k, b in stages])
    head, *got_stages = conv_external_params(
        fold_batchnorm(from_jax_variables(params, stats)))
    assert set(head) == set(want_head)
    assert set(head) | set(CONV23_BUFFERS) == set(CNNAudioGRU(
        31, compute_dtype=torch.bfloat16, fold_bn=True, conv1_external=True,
        conv23=True).state_dict())
    for k, v in want_head.items():
        np.testing.assert_array_equal(head[k].numpy(), v.numpy(), err_msg=k)
    flat = [t for pair in got_stages for t in pair]
    assert [tuple(t.shape) for t in flat] == [
        (32, 1, 3, 3), (32,), (64, 32, 3, 3), (64,), (128, 64, 3, 3), (128,)]
    for got, want in zip(flat, want_stages):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


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
