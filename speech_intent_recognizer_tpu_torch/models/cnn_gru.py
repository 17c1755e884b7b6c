"""CNN -> BiGRU -> attention intent classifier (PyTorch).

Counterpart of ``speech_intent_recognizer_tpu/models/cnn_gru.py``: three
Conv3x3/BN/ReLU/MaxPool2 stages (1->32->64->128), a 2-layer bidirectional
GRU (hidden 256) with PyTorch double-bias cell semantics, additive attention
pooling and a linear head — 3.26 M parameters for 31 classes.  Parameter
names follow the reference ``state_dict`` (``conv{i}.weight``, ``bn{i}.*``,
``gru.weight_ih_l{k}[_reverse]``, ``attention.*``, ``fc.*``), so a reference
``best_model.pt`` loads with ``load_state_dict``.

Four forms, as in the reference package:

* the train form with BatchNorm (``fold_bn=False``);
* ``fold_bn=True``: BatchNorm folded into the convs (:func:`fold_batchnorm`);
* ``conv1_external=True`` (requires ``fold_bn``): conv1 runs inside the
  front-end kernel; the input is its pooled (B, T', M'*C1) output and
  conv2/conv3 run on (T, M) with spatially transposed kernels
  (:func:`conv1_external_params`).  ``pool_impl="kernel"`` there runs each
  stage as ``F.conv2d`` without bias plus the conv epilogue kernel K6
  (``ops/pool_epilogue.py``; inference only) instead of torch's bias-add,
  ReLU and max-pool; the parameters are the same;
* ``conv_external=True`` (requires ``fold_bn``): the whole conv stack runs
  in kernels (K1, then K5 of ``ops/conv23.py``); the input is K5's
  (B, T'', M''*C3) sheet and the model is GRU + attention + ``fc`` only
  (:func:`conv_external_params`).

``compute_dtype`` keeps the reference's cast points: convs, the GRU input
projections and attention scores run in it (bf16 on the fast path);
BatchNorm, the attention softmax, pooling and ``fc`` run in fp32.
Parameters stay fp32 and are cast where they are used.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from speech_intent_recognizer_tpu_torch.ops.gru import gru_bidirectional
from speech_intent_recognizer_tpu_torch.ops.pool_epilogue import (
    bias_relu_pool2)
from speech_intent_recognizer_tpu_torch.ops.global_batch import rand_rows
from speech_intent_recognizer_tpu_torch.ops.model_parallel import (
    gather_on_use, split_attention_pool)

_DIRS = ("", "_reverse")


def _uniform_(t: torch.Tensor, bound: float,
              generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def _dropout(x: torch.Tensor, p: float, generator) -> torch.Tensor:
    """``generator``: a ``torch.Generator``, or an
    ``ops.global_batch.ShardedGenerator`` (the global batch's mask, this
    process's rows)."""
    keep = rand_rows(x.shape, generator, x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's (Flax's) statistics.

    Both modes run in fp32 through torch's fused batch-norm kernels.  Train
    mode normalizes with the biased batch variance, as torch and Flax both
    do, and updates the running variance with that same *biased* variance
    at momentum 0.1 (Flax's 0.9 kept fraction); ``nn.BatchNorm2d`` would
    update it with the unbiased one, a factor n / (n - 1) apart per step.
    Eval mode normalizes with the running statistics.  Parameter and
    buffer names are ``nn.BatchNorm2d``'s (``num_batches_tracked``
    included), so reference ``.pt`` files load.

    With a process group in ``sync_group`` (data-parallel training,
    ``CNNAudioGRU.set_sync_group``) the train-mode statistics are the
    global batch's, as under the JAX package's ``data`` mesh:
    :class:`_SyncBatchNorm`.  Without one nothing differs from the
    one-device path.
    """

    sync_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # On the card, channels-last: torch's native kernels then spread each
        # channel's reduction over the whole card (NCHW gives one block per
        # channel), and the convs and pools after it run channels-last too.
        # On the CPU, NCHW: there the channels-last backward put conv2's
        # weight gradient 0.7 % of its largest value off an fp64 step.
        fmt = torch.channels_last if x.is_cuda else torch.contiguous_format
        x = x.to(torch.float32, memory_format=fmt)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.eps)
        if self.sync_group is not None:
            return _SyncBatchNorm.apply(x, self.weight, self.bias, self,
                                        self.sync_group)
        with torch.no_grad():
            var, mean = torch.var_mean(x, _DIMS, correction=0)
        self.update_running_stats(mean, var)
        # Not F.batch_norm: on the card it takes cuDNN's kernels, whose
        # backward put conv2.weight's gradient 6e-3 to 9e-3 of its largest
        # value off the CPU's in a full-width fp32 train step at B=16
        # (H100); the native kernels hold it to 2e-5.
        return torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                       True, 0.0, self.eps)[0]

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor,
                             var: torch.Tensor) -> None:
        """The Flax update, with the biased batch variance."""
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        self.num_batches_tracked += 1


_DIMS = (0, 2, 3)  # every axis of an NCHW tensor but the channel's


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the rows of every process of ``group``.

    ``torch.nn.SyncBatchNorm`` does not serve: it refuses CPU tensors and
    updates the running variance with the unbiased estimate.  Forward:
    each process's (mean, M2, count) per channel, put in a zero buffer at
    its rank and summed over the group in one all-reduce, combined in rank
    order (Chan's parallel variance, the same arithmetic on every process);
    the biased variance normalizes and updates the running statistics.
    The normalization is ``native_batch_norm`` in eval form on those
    statistics (on the card torch's native kernels, not cuDNN's, as in the
    one-device path).  Backward: sum(dy) and sum(dy * (x - mean)) summed
    over the group in one all-reduce; the weight and bias gradients are
    this process's own sums, since the trainer sums every gradient over
    the group afterwards.  On the card both reductions and the input
    gradient are torch's native SyncBatchNorm kernels; on the CPU, which
    has none, the same arithmetic in tensor ops.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, bn: BatchNorm2d, group):
        world = torch.distributed.get_world_size(group)
        rank = torch.distributed.get_rank(group)
        c = x.shape[1]
        n_local = x.numel() // c
        with torch.no_grad():
            var_l, mean_l = torch.var_mean(x, _DIMS, correction=0)
            stats = x.new_zeros((world, 2 * c + 1))
            # device to device (a Python number written into a CUDA
            # tensor would wait for the card)
            stats[rank] = torch.cat([mean_l, var_l * n_local,
                                     mean_l.new_full((1,), n_local)])
            torch.distributed.all_reduce(stats, group=group)
            counts = stats[:, 2 * c:]
            n = counts.sum()
            mean = (stats[:, :c] * counts).sum(0) / n
            m2 = (stats[:, c:2 * c]
                  + counts * (stats[:, :c] - mean).square()).sum(0)
            var = m2 / n
            bn.update_running_stats(mean, var)
        y = torch.native_batch_norm(x, weight, bias, mean, var, False, 0.0,
                                    bn.eps)[0]
        invstd = torch.rsqrt(var + bn.eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.group, ctx.count = group, n.to(torch.int32).reshape(1)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        dy = dy.contiguous(memory_format=torch.channels_last if x.is_cuda
                           else torch.contiguous_format)
        c = x.shape[1]
        if x.is_cuda:
            sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, weight, True, True, True)
        else:
            sum_dy = dy.sum(_DIMS)
            sum_dy_xmu = (dy * (x - mean[:, None, None])).sum(_DIMS)
            dw, db = sum_dy_xmu * invstd, sum_dy
        sums = torch.cat([sum_dy, sum_dy_xmu])
        torch.distributed.all_reduce(sums, group=ctx.group)
        g_dy, g_dy_xmu = sums[:c], sums[c:]
        if x.is_cuda:
            dx = torch.batch_norm_backward_elemt(
                dy, x, mean, invstd, weight, g_dy, g_dy_xmu,
                ctx.count.to(x.device))
        else:
            n = ctx.count.float()
            proj = (g_dy_xmu / n) * invstd.square()
            dx = ((dy - g_dy[:, None, None] / n
                   - (x - mean[:, None, None]) * proj[:, None, None])
                  * (weight * invstd)[:, None, None])
        return dx, dw, db, None, None


class TorchGRU(nn.Module):
    """Multi-layer bidirectional GRU with PyTorch cell semantics.

    Parameters are named and laid out like ``torch.nn.GRU``
    (``weight_ih_l{k}[_reverse]`` etc., rows in [r; z; n] order).  The
    recurrence runs in :func:`..ops.gru.gru_bidirectional` (the K2 kernel
    on CUDA); the input projections are one GEMM per direction and layer.

    With a model group (``model_group``, ``CNNAudioGRU.set_model_group``)
    a leaf that holds this process's rows of the gate-stacked 3H (one that
    ``parallel.sharding.place_params`` cut) is gathered whole before use:
    the recurrence (K2 and K2T on the card) reads every row of W_hh at
    every step, so each process runs the whole GRU on its rows, and its
    gradient of a part is its slice of the whole gradient.
    """

    model_group = None

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 2, dropout: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        h3 = 3 * hidden_size
        for layer in range(num_layers):
            in_f = input_size if layer == 0 else 2 * hidden_size
            for sfx in _DIRS:
                for name, shape in (("weight_ih", (h3, in_f)),
                                    ("weight_hh", (h3, hidden_size)),
                                    ("bias_ih", (h3,)), ("bias_hh", (h3,))):
                    self.register_parameter(f"{name}_l{layer}{sfx}",
                                            nn.Parameter(torch.empty(shape)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """U(-1/sqrt(H), 1/sqrt(H)) — the torch.nn.GRU default."""
        for p in self.parameters():
            _uniform_(p, 1.0 / math.sqrt(self.hidden_size), generator)

    def _whole(self, p: torch.Tensor) -> torch.Tensor:
        if p.shape[0] == 3 * self.hidden_size:
            return p
        return gather_on_use(p, self.model_group, 0)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # x: (B, T, F) -> (B, T, 2H)
        dt = self.compute_dtype
        for layer in range(self.num_layers):
            xc = x.to(dt)
            gx, w_hh, b_hh = [], [], []
            for sfx in _DIRS:
                p = {n: self._whole(getattr(self, f"{n}_l{layer}{sfx}"))
                     .to(dt)
                     for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
                gx.append(F.linear(xc, p["weight_ih"], p["bias_ih"])
                          .transpose(0, 1))  # (T, B, 3H)
                w_hh.append(p["weight_hh"])
                b_hh.append(p["bias_hh"])
            ys_f, ys_b = gru_bidirectional(gx[0], gx[1], w_hh[0], w_hh[1],
                                           b_hh[0], b_hh[1])
            x = torch.cat([ys_f.transpose(0, 1), ys_b.transpose(0, 1)], dim=-1)
            if (self.training and layer < self.num_layers - 1
                    and self.dropout > 0.0):
                x = _dropout(x, self.dropout, generator)
        return x


class CNNAudioGRU(nn.Module):
    """Intent classifier: ``(B, n_mels, T)`` or ``(B, 1, n_mels, T)`` log-mel
    in (or, with ``conv1_external``, K1's pooled output; with
    ``conv_external``, K5's output) -> ``(B, C)`` logits."""

    def __init__(self, num_classes: int,
                 conv_channels: Sequence[int] = (32, 64, 128),
                 gru_hidden: int = 256, gru_layers: int = 2,
                 dropout: float = 0.5, n_mels: int = 64,
                 compute_dtype: torch.dtype = torch.float32,
                 fold_bn: bool = False, conv1_external: bool = False,
                 conv_external: bool = False, pool_impl: str = "torch"):
        super().__init__()
        if conv1_external and not fold_bn:
            raise ValueError("conv1_external requires fold_bn=True")
        if conv_external and not fold_bn:
            raise ValueError("conv_external requires fold_bn=True")
        if pool_impl not in ("torch", "kernel"):
            raise ValueError(f"pool_impl must be 'torch' or 'kernel', got "
                             f"{pool_impl!r}")
        if pool_impl == "kernel" and not conv1_external:
            raise ValueError("pool_impl='kernel' serves the conv1_external "
                             "form")
        self.num_classes = num_classes
        self.conv_channels = tuple(conv_channels)
        self.compute_dtype = compute_dtype
        self.fold_bn = fold_bn
        self.conv1_external = conv1_external
        self.conv_external = conv_external
        self.pool_impl = pool_impl
        chans = (1,) + self.conv_channels
        first = len(chans) if conv_external else 2 if conv1_external else 1
        self._stages = range(first, len(chans))
        for i in self._stages:
            self.add_module(f"conv{i}", nn.utils.skip_init(
                nn.Conv2d, chans[i - 1], chans[i], 3, padding=1,
                bias=fold_bn))
            if not fold_bn:
                self.add_module(f"bn{i}", BatchNorm2d(chans[i]))
        feat = self.conv_channels[-1] * (n_mels // 2 ** len(self.conv_channels))
        self.gru = TorchGRU(feat, gru_hidden, gru_layers, dropout,
                            compute_dtype)
        self.attention = nn.utils.skip_init(nn.Linear, 2 * gru_hidden, 1)
        self.fc = nn.utils.skip_init(nn.Linear, 2 * gru_hidden, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch's default init, drawn from ``generator``: U(+-1/sqrt(fan_in))
        for conv and linear weights and biases, the nn.GRU default for the
        GRU, unit-scale fresh BatchNorms."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                _uniform_(m.weight, bound, generator)
                if m.bias is not None:
                    _uniform_(m.bias, bound, generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        self.gru.reset_parameters(generator)

    def set_sync_group(self, group) -> None:
        """Reduce every BatchNorm's train-mode statistics over the processes
        of ``group`` (a data-parallel trainer's data group), or, with None,
        over this process's rows alone."""
        for m in self.modules():
            if isinstance(m, BatchNorm2d):
                m.sync_group = group

    def set_model_group(self, group) -> None:
        """The model group over which this process holds parts of the GRU,
        ``attention`` and ``fc`` leaves (``parallel.sharding.
        place_params`` cuts them and calls this), or None."""
        self.model_group = group
        self.gru.model_group = group

    def _conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, f"conv{i}")
        dt = self.compute_dtype
        if self.pool_impl == "kernel":  # raw conv, then K6 in one pass
            return bias_relu_pool2(
                F.conv2d(x, conv.weight.to(dt), None, padding=1), conv.bias)
        bias = None if conv.bias is None else conv.bias.to(dt)
        x = F.conv2d(x, conv.weight.to(dt), bias, padding=1)
        if not self.fold_bn:  # BatchNorm in fp32 under bf16 compute
            x = getattr(self, f"bn{i}")(x)
        return F.max_pool2d(F.relu(x).to(dt), 2)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.conv_external:
            return self._forward_conv_external(x, generator)
        if self.conv1_external:
            return self._forward_conv1_external(x, generator)
        if x.dim() == 3:
            x = x.unsqueeze(1)  # (B, 1, n_mels, T)
        x = x.to(self.compute_dtype)
        for i in self._stages:
            x = self._conv(i, x)
        # (B, C, M', T') -> (B, T', C * M'), channel-major (reference
        # models.py:54-57)
        b, c, m, t = x.shape
        x = x.permute(0, 3, 1, 2).reshape(b, t, c * m)
        return self._head(x, generator)

    def _forward_conv1_external(self, x: torch.Tensor,
                                generator: Optional[torch.Generator]):
        """Tail of the conv stack for K1's output (B, T', M'*C1), lane =
        m * C1 + c, or already (B, T', M', C1).  Viewed as (B, C1, T', M')
        it is a channels-last NCHW tensor (no copy); conv2/conv3 run on
        (T, M) with the spatially transposed kernels."""
        c1 = self.conv_channels[0]
        if x.dim() == 3:
            b, t, mc = x.shape
            x = x.view(b, t, mc // c1, c1)
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        for i in self._stages:
            x = self._conv(i, x)
        b, c, t, m = x.shape
        x = x.permute(0, 2, 1, 3).reshape(b, t, c * m)
        return self._head(x, generator)

    def _forward_conv_external(self, x: torch.Tensor,
                               generator: Optional[torch.Generator]):
        """GRU + attention + head for K5's output (B, T'', M''*C3), lane =
        m * C3 + c, or already (B, T'', M'', C3): the channel-major flatten
        of the other forms, then the head."""
        c3 = self.conv_channels[-1]
        if x.dim() == 3:
            b, t, mc = x.shape
            x = x.view(b, t, mc // c3, c3)
        b, t, m, c = x.shape
        x = x.to(self.compute_dtype).transpose(2, 3).reshape(b, t, c * m)
        return self._head(x, generator)

    def _head(self, x: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        x = self.gru(x, generator)
        dt = self.compute_dtype
        if self.fc.weight.shape[1] != x.shape[-1]:  # row-parallel head
            return split_attention_pool(x, self.attention, self.fc,
                                        self.model_group, dt)
        scores = F.linear(x.to(dt), self.attention.weight.to(dt),
                          self.attention.bias.to(dt))
        weights = torch.softmax(scores.float(), dim=1)  # over time
        pooled = (x.float() * weights).sum(dim=1)
        return F.linear(pooled, self.fc.weight.float(), self.fc.bias.float())


def fold_batchnorm(state: Dict[str, torch.Tensor],
                   eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Fold eval-mode BatchNorm into the preceding conv (inference only).

    ``BN(conv(x)) == conv'(x) + bias'`` with ``weight' = weight * scale /
    sqrt(var + eps)`` per output channel and ``bias' = bias - mean * scale /
    sqrt(var + eps)``.  Takes and returns reference-layout state dicts; the
    result loads into ``CNNAudioGRU(fold_bn=True)``.
    """
    out = {k: v for k, v in state.items() if not k.startswith("bn")}
    for key in state:
        if not (key.startswith("conv") and key.endswith(".weight")):
            continue
        idx = key[len("conv"):-len(".weight")]
        if f"bn{idx}.running_var" not in state:
            continue
        mult = (state[f"bn{idx}.weight"].float()
                / torch.sqrt(state[f"bn{idx}.running_var"].float() + eps))
        out[key] = state[key].float() * mult[:, None, None, None]
        out[f"conv{idx}.bias"] = (state[f"bn{idx}.bias"].float()
                                  - state[f"bn{idx}.running_mean"].float()
                                  * mult)
    return out


def conv1_external_params(folded: Dict[str, torch.Tensor]):
    """Split a BN-folded state dict for the fused-conv1 inference variant.

    Returns ``(variant_state, conv1_weight, conv1_bias)``: the
    ``CNNAudioGRU(conv1_external=True)`` state dict (conv1 removed, conv2 /
    conv3 kernels' spatial axes transposed — a 3x3 SAME conv over (T, M) with
    the transposed kernel equals the conv over (M, T)), and the folded conv1
    stage for the K1 kernel.
    """
    out = {}
    for key, v in folded.items():
        if key.startswith("conv1."):
            continue
        if key.startswith("conv") and key.endswith(".weight"):
            v = v.transpose(2, 3).contiguous()
        out[key] = v
    return out, folded["conv1.weight"], folded["conv1.bias"]


def conv_external_params(folded: Dict[str, torch.Tensor]):
    """Split a BN-folded state dict for the conv-stack-in-kernels variant.

    Returns ``(head_state, (w1, b1), (w2, b2), (w3, b3))``: the
    ``CNNAudioGRU(conv_external=True)`` state dict (GRU, attention and
    ``fc`` only) and the three folded conv stages in their original
    orientation — conv1 for the K1 kernel, conv2 / conv3 for
    ``ops.conv23.conv23_operands``.
    """
    head = {k: v for k, v in folded.items() if not k.startswith("conv")}
    return (head,) + tuple(
        (folded[f"conv{i}.weight"], folded[f"conv{i}.bias"])
        for i in (1, 2, 3))
