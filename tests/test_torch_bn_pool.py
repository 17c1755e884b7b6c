"""K7's plain version (``ops/bn_pool.py``) against the torch chain it
replaces in ``CNNAudioGRU._conv``'s train form (``BatchNorm2d`` -> ReLU ->
cast -> 2x2 max-pool), forced ties in the pool, and the rule that engages
K7, with the launchers swapped for their plain versions so that the rule
runs here on the CPU.  The kernels themselves are held to the plain
version on the card by ``tests/test_torch_cuda.py``."""

import copy

import pytest
import torch
import torch.nn.functional as F

from speech_intent_recognizer_tpu_torch.models import cnn_gru
from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
    BatchNorm2d, CNNAudioGRU)
from speech_intent_recognizer_tpu_torch.ops import bn_pool

# the three stages' conv outputs at B <= 4, cut in height and width
STAGES = [(4, 32, 16, 20), (3, 64, 8, 10), (2, 128, 4, 6)]


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap in units of the bf16 spacing at the larger of the
    two values."""
    got, want = got.detach().float(), want.detach().float()
    _m, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(got), e - 8)
    return float(((got - want).abs() / ulp).max())


def _bn(c: int, seed: int, scale=(0.5, 1.5), shift=(-0.5, 0.5)):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.uniform_(*scale, generator=g)
        bn.bias.uniform_(*shift, generator=g)
    return bn.train()


def _both(y0: torch.Tensor, bn: BatchNorm2d):
    """The torch chain and the plain version on the same input and
    parameters: outputs, gradients of (y, weight, bias) for one cotangent,
    and the two BatchNorms after the step."""
    dt = y0.dtype
    bn_p = copy.deepcopy(bn)
    y_t = y0.clone().requires_grad_()
    y_p = y0.clone().requires_grad_()
    want = F.max_pool2d(F.relu(bn(y_t)).to(dt), 2)
    got, mean, var = bn_pool._bn_relu_pool2_train_plain(
        y_p, bn_p.weight, bn_p.bias, bn_p.eps)
    bn_p.update_running_stats(mean, var)
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(1))
    g = g.to(dt)
    grads_t = torch.autograd.grad(want, (y_t, bn.weight, bn.bias), g)
    grads_p = torch.autograd.grad(got, (y_p, bn_p.weight, bn_p.bias), g)
    return want, got, grads_t, grads_p, bn, bn_p


def _assert_grads(grads_t, grads_p, dtype):
    dy_t, dy_p = grads_t[0].float(), grads_p[0].float()
    if dtype == torch.bfloat16:
        # one rounding of the fp32 gradient apart, at most
        assert _ulps(dy_p, dy_t) <= 1.0
    else:
        torch.testing.assert_close(dy_p, dy_t, rtol=1e-5,
                                   atol=1e-6 * float(dy_t.abs().max()))
    for a, b in zip(grads_p[1:], grads_t[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", STAGES)
def test_plain_matches_the_torch_chain(shape, dtype):
    """Output within one bf16 rounding (fp32: 1e-6 of its scale), the
    running mean / variance and ``num_batches_tracked`` as the BatchNorm
    module leaves them, the gradients of y within one rounding and those
    of weight and bias within 1e-5."""
    b, c, h, w = shape
    g = torch.Generator().manual_seed(c)
    y0 = (2.0 * torch.randn(shape, generator=g) + 0.3).to(dtype)
    want, got, grads_t, grads_p, bn, bn_p = _both(y0, _bn(c, c + 1))
    assert got.shape == (b, c, h // 2, w // 2) and got.dtype == dtype
    if dtype == torch.bfloat16:
        assert _ulps(got, want) <= 1.0
    else:
        torch.testing.assert_close(got, want, rtol=0.0,
                                   atol=1e-6 * float(want.abs().max()))
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(bn_p, name), getattr(bn, name),
                                   rtol=1e-6, atol=1e-7)
    assert int(bn_p.num_batches_tracked) == int(bn.num_batches_tracked) == 1
    _assert_grads(grads_t, grads_p, dtype)


def test_forced_ties_route_as_max_pool2d():
    """Equal bf16 values in a window: whole windows of one value, windows
    whose distinct values BatchNorm's small scale rounds to one bf16 value
    (most windows here), and windows that are all zero after ReLU; every
    gradient goes where torch's ``max_pool2d`` sends it: in a window of
    one value to its first position, in a window of zeros nowhere."""
    b, c, h, w = 2, 32, 8, 12
    g = torch.Generator().manual_seed(3)
    y0 = torch.randn((b, c, h, w), generator=g)
    y0[:, :, :4, :4] = 0.75          # whole windows of one value
    y0[:, :8, 4:, 4:8] = -3.0        # all zero after ReLU (shift 0 there)
    y0 = y0.to(torch.bfloat16)
    bn = _bn(c, 4, scale=(1e-3, 2e-3), shift=(1.0, 1.0))
    with torch.no_grad():
        bn.bias[:8] = 0.0
    want, got, grads_t, grads_p, _, _ = _both(y0, bn)
    assert _ulps(got, want) <= 1.0
    _assert_grads(grads_t, grads_p, torch.bfloat16)
    windows = grads_p[0].float().unfold(2, 2, 2).unfold(3, 2, 2)
    windows = windows.reshape(b, c, h // 2, w // 2, 4)
    # one value, z > 0: the gradient lands on the first position alone
    one = windows[:, 8:, :2, :2]
    assert bool((one[..., 1:] == one[..., 1:2]).all())
    assert bool((one[..., 0] != one[..., 1]).any())
    # all zero after ReLU: no position takes the pooled gradient
    zero = windows[:, :8, 2:, 2:4]
    assert bool((zero == zero[..., :1]).all())
    # most windows of distinct values tie once rounded
    assert float((got[:, 8:, 2:] == 1.0).float().mean()) > 0.5


def _model(channels=(8, 16, 32), dtype=torch.bfloat16, fold_bn=False):
    m = CNNAudioGRU(4, conv_channels=channels, gru_hidden=32, n_mels=16,
                    dropout=0.0, compute_dtype=dtype, fold_bn=fold_bn)
    m.reset_parameters(torch.Generator().manual_seed(5))
    return m


def _step(model, x):
    """One forward and backward; the K7 counters' moves."""
    bn_pool.bn_relu_pool2_train.launches = 0
    bn_pool.bn_relu_pool2_train.backward_launches = 0
    logits = model(x)
    logits.float().square().sum().backward()
    return logits, (bn_pool.bn_relu_pool2_train.launches,
                    bn_pool.bn_relu_pool2_train.backward_launches)


@pytest.fixture
def card_like(monkeypatch):
    """The rule sees a CUDA tensor and the launchers run the plain
    kernels' arithmetic."""
    monkeypatch.setattr(bn_pool, "_kernel_device", lambda t: True)
    monkeypatch.setattr(bn_pool, "_launch_forward", bn_pool._forward_plain)
    monkeypatch.setattr(bn_pool, "_launch_backward", bn_pool._backward_plain)


def _x(shape=(3, 16, 24)):
    return torch.randn(shape, generator=torch.Generator().manual_seed(6))


def test_rule_engages_k7_in_a_bf16_train_step(card_like):
    """A bf16 train step launches K7 once a stage forward and once
    backward, and matches the same step through the torch chain: logits,
    every gradient, the running statistics."""
    model = _model().train()
    ref = copy.deepcopy(model)
    x = _x()
    logits, counts = _step(model, x)
    assert counts == (3, 3)
    with pytest.MonkeyPatch.context() as mp:  # the torch chain
        mp.setattr(bn_pool, "_kernel_device", lambda t: False)
        torch_logits, torch_counts = _step(ref, x)
    assert torch_counts == (0, 0)
    # a few bf16 roundings apart: of the logits' scale, and of each leaf's
    # or the median leaf's, whichever is larger (the attention score's
    # bias, which the softmax cancels, moves by round-off alone)
    scale = float(torch_logits.float().abs().max())
    assert float((logits - torch_logits).float().abs().max()) <= 1e-2 * scale
    scales = {n: float(q.grad.abs().max()) for n, q in ref.named_parameters()}
    median = sorted(scales.values())[len(scales) // 2]
    for (n, p), (_, q) in zip(model.named_parameters(),
                              ref.named_parameters()):
        assert float((p.grad - q.grad).abs().max()) <= \
            3e-2 * max(scales[n], median), n
    for (n, a), (_, b) in zip(model.named_buffers(), ref.named_buffers()):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-6,
                                   atol=1e-7, msg=n)


@pytest.mark.parametrize("case", ["eval", "fold_bn", "fp32", "sync_group",
                                  "channels"])
def test_rule_keeps_the_torch_chain(card_like, monkeypatch, case):
    """The counters stay 0 for eval mode, BatchNorm folded into the
    convs, fp32 compute, a sync group, and channels no multiple of 8."""
    x = _x()
    if case == "eval":
        model = _model().eval()
    elif case == "fold_bn":
        model = _model(fold_bn=True).train()
    elif case == "fp32":
        model = _model(dtype=torch.float32).train()
    elif case == "channels":
        model = _model(channels=(12, 20, 36)).train()
    else:
        model = _model().train()
        model.set_sync_group("group")

        def local(x, weight, bias, bn, group):  # the group's rows: these
            return F.batch_norm(x, None, None, weight, bias, True, 0.0,
                                bn.eps)

        monkeypatch.setattr(cnn_gru._SyncBatchNorm, "apply", local)
    _logits, counts = _step(model, x)
    assert counts == (0, 0)


@pytest.mark.parametrize("hw", [(15, 24), (16, 23)])
def test_rule_keeps_the_torch_chain_at_odd_height_or_width(card_like, hw):
    """A stage whose conv output has an odd height or width keeps the
    torch chain (its pool floors); an even one engages K7."""
    model = _model().train()
    x = torch.randn((2, 1, *hw), generator=torch.Generator().manual_seed(7))
    bn_pool.bn_relu_pool2_train.launches = 0
    out = model._conv(1, x.to(torch.bfloat16))
    assert bn_pool.bn_relu_pool2_train.launches == 0
    assert out.shape == (2, 8, hw[0] // 2, hw[1] // 2)
    model._conv(2, out[..., :out.shape[2] // 2 * 2, :out.shape[3] // 2 * 2])
    assert bn_pool.bn_relu_pool2_train.launches == 1


def test_cpu_tensors_launch_nothing():
    """Off the card the wrapper runs the plain version and counts
    nothing; the running statistics move as BatchNorm2d moves them."""
    bn, ref = _bn(16, 8), _bn(16, 8)
    y = torch.randn((2, 16, 4, 6)).to(torch.bfloat16)
    bn_pool.bn_relu_pool2_train.launches = 0
    bn_pool.bn_relu_pool2_train.backward_launches = 0
    out = bn_pool.bn_relu_pool2_train(y.requires_grad_(), bn)
    out.float().sum().backward()
    assert (bn_pool.bn_relu_pool2_train.launches,
            bn_pool.bn_relu_pool2_train.backward_launches) == (0, 0)
    ref(y.detach())
    torch.testing.assert_close(bn.running_var, ref.running_var)
    assert int(bn.num_batches_tracked) == 1


def test_one_channel_input_gives_a_channels_last_conv_output():
    """``channels_last`` restrides a contiguous (B, 1, H, W) tensor without
    a copy, and a conv on it writes its output channels-last (as K7 reads
    it; torch's ``.contiguous(memory_format=...)`` keeps NCHW strides)."""
    x = torch.randn((2, 1, 8, 10)).to(torch.bfloat16)
    cl = bn_pool.channels_last(x)
    assert cl.data_ptr() == x.data_ptr() and torch.equal(cl, x)
    w = torch.randn((8, 1, 3, 3)).to(torch.bfloat16)
    y = F.conv2d(cl, w, padding=1)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert not F.conv2d(x, w, padding=1).is_contiguous(
        memory_format=torch.channels_last)
