"""The port's GRU backward (plain K2 backward) against autograd and against
the JAX package: the adjoint of the Pallas layer (``_gru_layer_diff``, its
kernel in interpret mode on the CPU) and whole-model parameter gradients,
on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu.models import cnn_gru as ref_model
from speech_intent_recognizer_tpu.ops.gru_pallas import (
    _gru_layer_diff, gru_bidirectional_pallas)
from speech_intent_recognizer_tpu_torch.convert.jax_bridge import (
    from_jax_variables)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
from speech_intent_recognizer_tpu_torch.ops.gru import (
    _gru_layer_backward_plain, _gru_layer_plain, gru_bidirectional,
    gru_layer, gru_layer_backward)

# the setup and bars of tests/test_gru_pallas.py:69-94
T, B, H = 12, 5, 64
RTOL, ATOL = 2e-4, 2e-5


def _bidir_args(rng):
    return (rng.standard_normal((T, B, 3 * H)).astype(np.float32),
            rng.standard_normal((T, B, 3 * H)).astype(np.float32),
            (rng.standard_normal((3 * H, H)) * 0.1).astype(np.float32),
            (rng.standard_normal((3 * H, H)) * 0.1).astype(np.float32),
            (rng.standard_normal(3 * H) * 0.1).astype(np.float32),
            (rng.standard_normal(3 * H) * 0.1).astype(np.float32))


def _layer_args(rng):
    gx = rng.standard_normal((2, T, B, 3 * H)).astype(np.float32)
    w = (rng.standard_normal((2, H, 3 * H)) * 0.1).astype(np.float32)
    bn = (rng.standard_normal((2, 1, H)) * 0.1).astype(np.float32)
    dys = rng.standard_normal((2, T, B, H)).astype(np.float32)
    return gx, w, bn, dys


def test_bidirectional_grads_match_jax_pallas(rng):
    """d/d(all six inputs) of a loss with a distinct cotangent per (t, b, h)
    position (a plain sum would mask transposition bugs): the port's
    autograd path (plain backward on the CPU) against ``jax.grad`` of
    ``gru_bidirectional_pallas``."""
    args = _bidir_args(rng)
    wt = rng.standard_normal((T, B, H)).astype(np.float32)

    def jax_loss(*a):
        ys_f, ys_b = gru_bidirectional_pallas(*a, H)
        return jnp.sum(wt * ys_f) + jnp.sum(wt[::-1] * ys_b)

    want = jax.grad(jax_loss, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in args])
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    ys_f, ys_b = gru_bidirectional(*leaves)
    wt_t = torch.from_numpy(wt)
    loss = (wt_t * ys_f).sum() + (wt_t.flip(0) * ys_b).sum()
    got = torch.autograd.grad(loss, leaves)
    for g, w_, name in zip(got, want, ["gx_f", "gx_b", "w_f", "w_b", "b_f",
                                       "b_b"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_plain_adjoint_matches_autograd(rng):
    """The transcribed adjoint loop against autograd through the plain
    forward (fp32: the stored ys equal the carried h)."""
    gx, w, bn, dys = [torch.from_numpy(a) for a in _layer_args(rng)]
    leaves = [t.clone().requires_grad_() for t in (gx, w, bn)]
    want = torch.autograd.grad(_gru_layer_plain(*leaves), leaves, dys)
    got = _gru_layer_backward_plain(gx, w, bn, _gru_layer_plain(gx, w, bn),
                                    dys)
    for g, w_, name in zip(got, want, ["dgx", "dw", "dbn"]):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_layer_backward_bf16_matches_jax(rng):
    """bf16 operands: the Pallas layer's custom VJP (h_prev = the stored
    bf16 ys, fp32 gate and adjoint math, dgx and dW rounded to bf16)
    against the port's backward on the same inputs.  Only fp32 summation
    order differs, so dgx and dW agree to one bf16 rounding step (2**-7
    relative) plus the fp32 bar; db_hn (fp32) at the fp32 bar."""
    gx, w, bn, dys = _layer_args(rng)
    bf = jnp.bfloat16
    ys, vjp = jax.vjp(lambda a, b, c: _gru_layer_diff(a, b, c, True),
                      jnp.asarray(gx, bf), jnp.asarray(w, bf),
                      jnp.asarray(bn))
    want = vjp(jnp.asarray(dys, bf))
    tb = torch.bfloat16
    got = gru_layer_backward(
        torch.from_numpy(gx).to(tb), torch.from_numpy(w).to(tb),
        torch.from_numpy(bn), torch.from_numpy(
            np.array(ys.astype(jnp.float32))).to(tb),
        torch.from_numpy(dys).to(tb))
    assert got[0].dtype == got[1].dtype == tb and got[2].dtype == torch.float32
    for g, w_, name in zip(got[:2], want[:2], ["dgx", "dw"]):
        a = g.float().numpy()
        b = np.asarray(w_.astype(jnp.float32))
        bound = 2.0 ** -7 * np.abs(b) + ATOL + RTOL * np.abs(b).max()
        assert (np.abs(a - b) <= bound).all(), (name, np.abs(a - b).max())
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=RTOL, atol=ATOL, err_msg="dbn")


def test_gru_layer_autograd_uses_the_backward_wrapper(rng, monkeypatch):
    """Under autograd, gru_layer's backward is gru_layer_backward (the K2
    backward wrapper), fed the forward's (gx, w, bn, ys)."""
    from speech_intent_recognizer_tpu_torch.ops import gru as gru_mod

    calls = []
    real = gru_mod.gru_layer_backward

    def spy(gx, w, bn, ys, dys, rows=None):
        calls.append(ys.shape)
        return real(gx, w, bn, ys, dys, rows)

    monkeypatch.setattr(gru_mod, "gru_layer_backward", spy)
    gx, w, bn, dys = [torch.from_numpy(a) for a in _layer_args(rng)]
    gx.requires_grad_()
    gru_layer(gx, w, bn).backward(dys)
    assert calls == [(2, T, B, H)] and gx.grad is not None


def test_full_model_param_grads_match_jax():
    """d(cross-entropy)/d(params) of the whole model (eval-mode BatchNorm)
    against JAX ``CNNAudioGRU(gru_impl="pallas")``, the setup and bar of
    tests/test_gru_pallas.py:96-124.  The input comes from a generator of
    its own, not the session's: conv1.weight's gradient sits within a few
    1e-6 of the absolute bar, so the test must not depend on which tests
    drew from a shared generator before it."""
    import optax

    model = ref_model.CNNAudioGRU(num_classes=7, gru_impl="pallas")
    variables = ref_model.init_model(model, jax.random.key(5))
    x = np.random.default_rng(42).standard_normal((2, 64, 120)).astype(
        np.float32)
    y = np.asarray([1, 4])

    def loss(params):
        logits = model.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             jnp.asarray(x), train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    want = from_jax_variables(
        jax.tree.map(np.asarray, jax.grad(loss)(variables["params"])),
        jax.tree.map(np.asarray, variables["batch_stats"]))
    port = CNNAudioGRU(num_classes=7)
    port.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"])))
    port.eval()
    torch.nn.functional.cross_entropy(
        port(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    params = dict(port.named_parameters())
    assert len(params) == 29
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=5e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_wrapper_on_cpu_is_the_plain_version(rng, dtype):
    gx, w, bn, dys = [torch.from_numpy(a) for a in _layer_args(rng)]
    gx, w, dys = gx.to(dtype), w.to(dtype), dys.to(dtype)
    ys = _gru_layer_plain(gx, w, bn)
    gru_layer_backward.launches = 0
    got = gru_layer_backward(gx, w, bn, ys, dys)
    want = _gru_layer_backward_plain(gx, w, bn, ys, dys)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and torch.equal(g, w_)
    assert gru_layer_backward.launches == 0
