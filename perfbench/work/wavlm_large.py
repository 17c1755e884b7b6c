"""Operations and bytes of each layer of the WavLM intent model, counted
from the model's shapes, whatever implements the layer.

The wav2vec 2.0 model's count (``work/wav2vec2_base.py``: the same
encoder, projection, layers and head, whose norms it does not count) plus
what WavLM adds to each layer: the gate projection (a dense 64 -> 8 of
every head's slice) and the gated bias's multiply-add onto every score,
with the bucket table ``E`` and the gates' weights read once a call.

``attention`` is the attention core of every layer, from q, k and v to the
heads' output, the gated relative position bias included; it lies inside
``transformer`` and is left out of :func:`model_flops`.
"""

from __future__ import annotations

from core.bench import load_module

wav2vec2 = load_module("work", "wav2vec2_base.py")

_BYTES = {"bf16": 2, "fp32": 4}


def _attention_ops(cfg: dict, t: int) -> int:
    """One row's attention core in one layer: q k^T and the weighted sum
    of v, and the gated bias's multiply-add onto every score."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return 2 * 2 * t * t * h + 2 * heads * t * t


def layers(cfg: dict, precision: str, lengths, width: int) -> dict:
    """{layer: {"flops": {precision: n}, "bytes": n}} of one call on the
    rows of ``lengths`` in buffers ``width`` samples wide, for wav2vec's
    layers ``encoder``, ``projection``, ``transformer`` (with the gate
    projection and the gated bias) and ``head``, and ``attention`` (the
    core alone, a part of ``transformer``)."""
    out = wav2vec2.layers(cfg, precision, lengths, width)
    rows, ab = len(lengths), _BYTES[precision]
    t = wav2vec2.conv_lengths(cfg, width)[-1]
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nl, nb = cfg["num_hidden_layers"], cfg["num_buckets"]
    hd = h // heads
    gate_ops = 2 * t * heads * hd * 8      # the gate projection
    bias_ops = 2 * heads * t * t           # gate x P added to the scores
    transformer = out["transformer"]
    transformer["flops"][precision] += rows * nl * (gate_ops + bias_ops)
    transformer["bytes"] += (nl * hd * 8 + nb * heads) * ab
    # the least an implementation of the core moves in each layer: q, k
    # and v read, the output written, the table E and the (B, heads, T)
    # gates read, the row's length; never a (B, heads, T, T) tensor
    out["attention"] = {
        "flops": {precision: rows * nl * _attention_ops(cfg, t)},
        "bytes": nl * (rows * (4 * t * h * ab + heads * t * 4 + 4)
                       + nb * heads * 4)}
    return out


# the layers that partition the model; ``attention`` lies in
# ``transformer``
DISJOINT = ("encoder", "projection", "transformer", "head")


def model_flops(cfg: dict, precision: str, lengths, width: int) -> dict:
    """The operations of the disjoint layers, summed by precision."""
    out: dict = {}
    every = layers(cfg, precision, lengths, width)
    for name in DISJOINT:
        for p, n in every[name]["flops"].items():
            out[p] = out.get(p, 0.0) + n
    return out
