"""CNN -> BiGRU -> attention intent classifier (PyTorch).

Counterpart of ``speech_intent_recognizer_tpu/models/cnn_gru.py``: three
Conv3x3/BN/ReLU/MaxPool2 stages (1->32->64->128), a 2-layer bidirectional
GRU (hidden 256) with PyTorch double-bias cell semantics, additive attention
pooling and a linear head — 3.26 M parameters for 31 classes.  Parameter
names follow the reference ``state_dict`` (``conv{i}.weight``, ``bn{i}.*``,
``gru.weight_ih_l{k}[_reverse]``, ``attention.*``, ``fc.*``), so a reference
``best_model.pt`` loads with ``load_state_dict``.

Three forms, as in the reference package:

* the train form with BatchNorm (``fold_bn=False``);
* ``fold_bn=True``: BatchNorm folded into the convs (:func:`fold_batchnorm`);
* ``conv1_external=True`` (requires ``fold_bn``): conv1 runs inside the
  front-end kernel; the input is its pooled (B, T', M'*C1) output and
  conv2/conv3 run on (T, M) with spatially transposed kernels
  (:func:`conv1_external_params`).

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

_DIRS = ("", "_reverse")


def _uniform_(t: torch.Tensor, bound: float,
              generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def _dropout(x: torch.Tensor, p: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


class TorchGRU(nn.Module):
    """Multi-layer bidirectional GRU with PyTorch cell semantics.

    Parameters are named and laid out like ``torch.nn.GRU``
    (``weight_ih_l{k}[_reverse]`` etc., rows in [r; z; n] order).  The
    recurrence runs in :func:`..ops.gru.gru_bidirectional` (the K2 kernel
    on CUDA); the input projections are one GEMM per direction and layer.
    """

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

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # x: (B, T, F) -> (B, T, 2H)
        dt = self.compute_dtype
        for layer in range(self.num_layers):
            xc = x.to(dt)
            gx, w_hh, b_hh = [], [], []
            for sfx in _DIRS:
                p = {n: getattr(self, f"{n}_l{layer}{sfx}").to(dt)
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
    in (or, with ``conv1_external``, K1's pooled output) -> ``(B, C)``
    logits."""

    def __init__(self, num_classes: int,
                 conv_channels: Sequence[int] = (32, 64, 128),
                 gru_hidden: int = 256, gru_layers: int = 2,
                 dropout: float = 0.5, n_mels: int = 64,
                 compute_dtype: torch.dtype = torch.float32,
                 fold_bn: bool = False, conv1_external: bool = False):
        super().__init__()
        if conv1_external and not fold_bn:
            raise ValueError("conv1_external requires fold_bn=True")
        self.num_classes = num_classes
        self.conv_channels = tuple(conv_channels)
        self.compute_dtype = compute_dtype
        self.fold_bn = fold_bn
        self.conv1_external = conv1_external
        chans = (1,) + self.conv_channels
        self._stages = range(2 if conv1_external else 1, len(chans))
        for i in self._stages:
            self.add_module(f"conv{i}", nn.utils.skip_init(
                nn.Conv2d, chans[i - 1], chans[i], 3, padding=1,
                bias=fold_bn))
            if not fold_bn:
                self.add_module(f"bn{i}", nn.BatchNorm2d(chans[i]))
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

    def _conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, f"conv{i}")
        dt = self.compute_dtype
        bias = None if conv.bias is None else conv.bias.to(dt)
        x = F.conv2d(x, conv.weight.to(dt), bias, padding=1)
        if not self.fold_bn:  # BatchNorm in fp32 under bf16 compute
            x = getattr(self, f"bn{i}")(x.float())
        return F.max_pool2d(F.relu(x).to(dt), 2)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
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

    def _head(self, x: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        x = self.gru(x, generator)
        dt = self.compute_dtype
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
