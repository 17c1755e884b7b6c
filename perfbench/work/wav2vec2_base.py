"""Operations and bytes of each layer of the wav2vec 2.0 intent model,
counted from the model's shapes, whatever implements the layer.

A multiply-add is two operations.  The model runs over the whole padded
buffer: the group norm of the first conv and the head's pooling read every
frame, and masked attention still forms every score, so the work does not
depend on the rows' lengths.  Bytes count each input read once, each
output written once and each weight read once a call.
"""

from __future__ import annotations

_BYTES = {"bf16": 2, "fp32": 4}


def conv_lengths(cfg: dict, samples: int) -> list:
    out, n = [], samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def layers(cfg: dict, precision: str, lengths, width: int) -> dict:
    """{layer: {"flops": {precision: n}, "bytes": n}} of one call on the
    rows of ``lengths`` in buffers ``width`` samples wide, for the layers
    ``encoder`` (the 7 convolutions of the feature encoder, its norm and
    GELUs),
    ``projection`` (layer norm and dense), ``transformer`` (positional
    convolution and the encoder layers) and ``head``."""
    rows = len(lengths)
    ab = _BYTES[precision]
    dims, kernels = cfg["conv_dim"], cfg["conv_kernel"]
    lens = conv_lengths(cfg, width)
    conv_ops, conv_w, c_in = 0, 0, 1
    for c_out, k, n in zip(dims, kernels, lens):
        conv_ops += 2 * k * c_in * c_out * n
        conv_w += k * c_in * c_out
        c_in = c_out
    t, c = lens[-1], dims[-1]
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    nl, groups = cfg["num_hidden_layers"], cfg["num_conv_pos_embedding_groups"]
    kpos = cfg["num_conv_pos_embeddings"]
    pos_ops = 2 * h * (h // groups) * kpos * t
    layer_ops = (4 * 2 * t * h * h       # q, k, v, out projections
                 + 2 * 2 * t * t * h     # scores and the weighted sum
                 + 2 * 2 * t * h * f)    # feed-forward
    layer_w = 4 * h * h + 2 * h * f
    encoder = {"flops": {precision: rows * conv_ops},
               "bytes": rows * (width * 4 + t * c * ab) + conv_w * ab}
    projection = {"flops": {precision: rows * 2 * t * c * h},
                  "bytes": rows * (t * c + t * h) * ab + c * h * ab}
    transformer = {"flops": {precision: rows * (pos_ops + nl * layer_ops)},
                   "bytes": (2 * rows * t * h * ab
                             + (h * (h // groups) * kpos + nl * layer_w)
                             * ab)}
    ncls = cfg["num_classes"]
    head = {"flops": {precision: rows * (2 * t * h + 2 * h * ncls)},
            "bytes": rows * (t * h * ab + ncls * 4)}
    return {"encoder": encoder, "projection": projection,
            "transformer": transformer, "head": head}


def model_flops(cfg: dict, precision: str, lengths, width: int) -> dict:
    """Every layer's operations, summed by precision."""
    out: dict = {}
    for layer in layers(cfg, precision, lengths, width).values():
        for p, n in layer["flops"].items():
            out[p] = out.get(p, 0.0) + n
    return out
