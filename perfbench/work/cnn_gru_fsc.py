"""Operations and bytes of each layer of the CNN-GRU intent model, counted
from the model's shapes, whatever implements the layer.

A multiply-add is two operations.  Each count is split by the precision of
its operands as the configuration states them (``precision`` of the path):
the log-mel front-end is float32, the layers after it run in the path's
compute precision.  Bytes count each input read once and each output
written once at the layer's boundary, in the types that cross it.

The front-end's work depends on each row's length (only the valid frames
``1 + length // hop`` are transformed); every other layer runs over the
fixed ``mel_spec_length`` frames.  The real FFT of ``n_fft`` points is
counted as 2.5 n log2 n operations, the mel projection by the filterbank's
nonzero weights.
"""

from __future__ import annotations

import math

import numpy as np

_BYTES = {"bf16": 2, "fp32": 4}


def _mel_nnz(cfg: dict) -> int:
    """Nonzero weights of the HTK filterbank (no norm), as float32."""
    n_freqs = cfg["n_fft"] // 2 + 1
    sr = cfg["sample_rate"]
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)  # noqa: E731
    pts = np.linspace(mel(0.0), mel(sr / 2.0), cfg["n_mels"] + 2)
    hz = 700.0 * (10.0 ** (pts / 2595.0) - 1.0)
    freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    slopes = hz[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / np.diff(hz)[:-1]
    up = slopes[:, 2:] / np.diff(hz)[1:]
    fb = np.maximum(0.0, np.minimum(down, up)).astype(np.float32)
    return int(np.count_nonzero(fb))


def frontend_flops_per_frame(cfg: dict) -> float:
    n = cfg["n_fft"]
    bins = n // 2 + 1
    return (2.5 * n * math.log2(n)  # real FFT
            + n                      # window
            + 3 * bins               # |X|^2
            + 2 * _mel_nnz(cfg)      # mel sums
            + cfg["n_mels"])         # dB


def _shapes(cfg: dict):
    c1, c2, c3 = cfg["conv_channels"]
    m, t = cfg["n_mels"], cfg["mel_spec_length"]
    return c1, c2, c3, m, t


def _ops(*pairs) -> dict:
    """{precision: operations} from (precision, operations) pairs."""
    out: dict = {}
    for p, n in pairs:
        out[p] = out.get(p, 0.0) + float(n)
    return out


def layers(cfg: dict, precision: str, lengths, width: int) -> dict:
    """{layer: {"flops": {precision: n}, "bytes": n}} summed over rows of
    ``lengths`` (samples) in float32 buffers ``width`` samples wide, for
    the layers ``k1`` (front-end + conv1 and its pool), ``conv`` (conv2
    and conv3 with their epilogues), ``gru`` (input products and
    recurrence of every layer and direction) and ``head`` (attention
    pooling and classifier)."""
    lengths = np.asarray(lengths, np.int64)
    rows = len(lengths)
    frames = float(np.sum(1 + lengths // cfg["hop_length"]))
    c1, c2, c3, m, t = _shapes(cfg)
    h, nl, ncls = cfg["gru_hidden"], cfg["gru_layers"], cfg["num_classes"]
    ab = _BYTES[precision]

    def conv(cin, cout, mm, tt):
        return 2 * 9 * cin * cout * mm * tt

    k1 = {"flops": _ops(("fp32", frames * frontend_flops_per_frame(cfg)),
                        (precision, rows * conv(1, c1, m, t))),
          "bytes": rows * (width * 4 + c1 * (m // 2) * (t // 2) * ab)}
    conv23 = {"flops": _ops((precision, rows * (
        conv(c1, c2, m // 2, t // 2) + conv(c2, c3, m // 4, t // 4)))),
              "bytes": rows * (c1 * (m // 2) * (t // 2)
                               + c3 * (m // 8) * (t // 8)) * ab}
    steps, feat = t // 8, c3 * (m // 8)
    ins = [feat if i == 0 else 2 * h for i in range(nl)]
    gru_in = sum(2 * 2 * steps * n_in * 3 * h for n_in in ins)
    gru_rec = nl * 2 * steps * 2 * h * 3 * h
    weights = sum(2 * 3 * h * (n_in + h) for n_in in ins) * ab
    gru = {"flops": _ops((precision, rows * (gru_in + gru_rec))),
           "bytes": rows * steps * (feat + 2 * h) * ab + weights}
    head = {"flops": _ops((precision, rows * 2 * steps * 2 * h),
                          ("fp32", rows * (2 * 2 * h * ncls
                                           + 4 * steps * 2 * h))),
            "bytes": rows * (steps * 2 * h * ab + ncls * 4)}
    return {"k1": k1, "conv": conv23, "gru": gru, "head": head}


def model_flops(cfg: dict, precision: str, lengths, width: int) -> dict:
    """Every layer's operations, summed by precision."""
    out: dict = {}
    for layer in layers(cfg, precision, lengths, width).values():
        for p, n in layer["flops"].items():
            out[p] = out.get(p, 0.0) + n
    return out



def train_layers(cfg: dict, precision: str, rows: int) -> dict:
    """{layer: {"flops", "bytes"}} of one training step on ``rows`` cached
    feature rows: ``gru``, its forward, the input and weight gradients of
    its input products and its recurrence (three times the forward's
    operations, the backward's products in the forward's precision), and
    ``model``, three times the forward of every layer after the
    front-end (features come from the cache)."""
    lengths = np.zeros(rows, np.int64)
    fwd = layers(cfg, precision, lengths, 0)
    gru = fwd["gru"]
    model: dict = {}
    for name, layer in fwd.items():
        for p, n in layer["flops"].items():
            if name == "k1" and p == "fp32":
                continue  # the log-mel front-end does not run in a step
            model[p] = model.get(p, 0.0) + 3 * n
    return {"gru": {"flops": {p: 3 * n for p, n in gru["flops"].items()},
                    "bytes": 3 * gru["bytes"]},
            "model": {"flops": model, "bytes": 0.0}}
