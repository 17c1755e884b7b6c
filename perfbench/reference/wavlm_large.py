"""Plain PyTorch reference of WavLM-Large with the intent head, waveform
to probabilities.

Written from the published description (Chen et al. 2021, "WavLM", arXiv
2110.13900 section 2, and the ``microsoft/wavlm-large`` configuration:
the stable-layer-norm wav2vec 2.0 encoder with a gated relative position
bias), with the reference project's attention-pooling head:

* feature encoder: 7 biasless 1-D convolutions, each followed by a
  LayerNorm over its channels at every frame and a GELU;
* feature projection: LayerNorm, dense to the hidden size;
* padding: a frame is kept while its index is below the row's length
  mapped through every convolution, ``(n - kernel) // stride + 1``; kept
  frames pass, others are zeroed, and the attention adds the float32
  minimum to the scores of dropped keys (transformers masks them with
  -inf: the same probabilities wherever a row keeps a frame);
* positional embedding: grouped convolution (kernel 128, 16 groups,
  padding 64, the last frame dropped), GELU, added (no LayerNorm after it:
  the layers are pre-LN);
* relative position bias, one table ``E`` (num_buckets x heads) for every
  layer: for query i and key j, r = j - i, n = num_buckets / 2, e = n / 2,
  ``bucket = n [r > 0] + (|r| if |r| < e else min(n - 1, e +
  floor(log(|r| / e) / log(max_distance / e) (n - e))))``, the log in
  float32 on the host, as transformers computes it;
  ``P[h, i, j] = E[bucket, h]``;
* each encoder layer, with ``y = LN(x)``: per head h the gate
  ``(a, b) = sigmoid(sum over 4 of W_g y_h + b_g)`` (W_g 8 x 64, read as
  2 x 4), ``gate = a (b c_h - 1) + 2``; scores ``q k^T / sqrt(64) +
  gate[i] P[h, i, j]`` plus the padding bias, softmax, the weighted sum;
  ``x = x + attn(y); x = x + ff(LN(x))`` with a GELU feed-forward;
* a final LayerNorm;
* head: softmax over time of a dense score (padded frames included, as
  the reference project pools), the weighted sum, the linear classifier,
  a softmax.  SUPERB's intent task puts a weighted sum of every layer's
  output under its classifier instead; this system serves the pooling
  head.

Inference only: no dropout, no LayerDrop.  It reads the state dict in the
transformers ``WavLMModel`` layout, the positional convolution's
weight-norm pair already folded into one weight, under ``wav2vec.``, with
``attention.*`` and ``fc.*`` for the head.  Every convolution and product
takes its operands through ``cast`` (``core.compare.CASTS``) and sums in
float32.  It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

P = "wav2vec."
REL = P + "encoder.layers.0.attention.rel_attn_embed.weight"


def weight_spec(cfg: dict) -> list:
    """The state dict this reference reads, as ``core.weights``
    specifications: weights N(0, 1/fan_in), biases and norm shifts small
    uniforms, norm scales near 1; the bucket table ``E`` N(0, 1), so that
    the bias moves the scores as much as q k^T does, and each head's gate
    constant U(0.5, 1.5), off the 1 it is initialised to."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    heads = cfg["num_attention_heads"]
    spec = []

    def dense(name, n_out, n_in, bias=True):
        spec.append((name + ".weight", (n_out, n_in), "normal", 0.0,
                     1 / math.sqrt(n_in)))
        if bias:
            spec.append((name + ".bias", (n_out,), "uniform", -0.02, 0.02))

    def norm(name, n):
        spec.extend([(name + ".weight", (n,), "uniform", 0.9, 1.1),
                     (name + ".bias", (n,), "uniform", -0.05, 0.05)])

    spec.append((P + "masked_spec_embed", (h,), "uniform", 0.0, 1.0))
    c_in = 1
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        spec.append((f"{P}feature_extractor.conv_layers.{i}.conv.weight",
                     (c, c_in, k), "normal", 0.0, 1 / math.sqrt(c_in * k)))
        norm(f"{P}feature_extractor.conv_layers.{i}.layer_norm", c)
        c_in = c
    norm(P + "feature_projection.layer_norm", c_in)
    dense(P + "feature_projection.projection", h, c_in)
    groups, kpos = cfg["num_conv_pos_embedding_groups"], \
        cfg["num_conv_pos_embeddings"]
    spec += [(P + "encoder.pos_conv_embed.conv.weight",
              (h, h // groups, kpos), "normal", 0.0,
              1 / math.sqrt(h // groups * kpos)),
             (P + "encoder.pos_conv_embed.conv.bias", (h,), "uniform",
              -0.02, 0.02)]
    norm(P + "encoder.layer_norm", h)
    spec.append((REL, (cfg["num_buckets"], heads), "normal", 0.0, 1.0))
    for i in range(cfg["num_hidden_layers"]):
        lp = f"{P}encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(lp + "attention." + proj, h, h)
        dense(lp + "attention.gru_rel_pos_linear", 8, h // heads)
        spec.append((lp + "attention.gru_rel_pos_const", (1, heads, 1, 1),
                     "uniform", 0.5, 1.5))
        norm(lp + "layer_norm", h)
        dense(lp + "feed_forward.intermediate_dense", f, h)
        dense(lp + "feed_forward.output_dense", h, f)
        norm(lp + "final_layer_norm", h)
    dense("attention", 1, h)
    dense("fc", cfg["num_classes"], h)
    return spec


def buckets(t: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """(T, T) int64 bucket of key j seen from query i, on the host."""
    n = num_buckets // 2
    e = n // 2
    pos = torch.arange(t)
    r = pos[None, :] - pos[:, None]
    a = r.abs()
    far = torch.floor(torch.log(a.float() / e) / math.log(max_distance / e)
                      * (n - e))
    far = torch.clamp(e + far.clamp(min=0).long(), max=n - 1)
    return (r > 0).long() * n + torch.where(a < e, a, far)


def _dense(x, state, name, cast):
    return cast(x) @ cast(state[name + ".weight"]).T + state[name + ".bias"]


def _norm(x, state, name, eps):
    return F.layer_norm(x, x.shape[-1:], state[name + ".weight"],
                        state[name + ".bias"], eps)


def logits(state: dict, cfg: dict, waveforms: torch.Tensor,
           lengths: torch.Tensor, cast) -> torch.Tensor:
    """(B, L) float32 rows and (B,) lengths -> (B, C) float32 logits."""
    eps = cfg["layer_norm_eps"]
    x = waveforms[:, None, :].float()
    n = lengths.to(torch.int64)
    for i, (k, s) in enumerate(zip(cfg["conv_kernel"], cfg["conv_stride"])):
        name = f"{P}feature_extractor.conv_layers.{i}"
        x = F.conv1d(cast(x), cast(state[name + ".conv.weight"]), stride=s)
        x = F.gelu(_norm(x.transpose(1, 2), state, name + ".layer_norm",
                         eps).transpose(1, 2))
        n = torch.div(n - k, s, rounding_mode="floor") + 1
    x = _norm(x.transpose(1, 2), state, P + "feature_projection.layer_norm",
              eps)
    x = _dense(x, state, P + "feature_projection.projection", cast)
    b, t, h = x.shape
    keep = (torch.arange(t, device=x.device)[None, :] < n[:, None]).float()
    x = x * keep[..., None]
    pad = (1.0 - keep)[:, None, None, :] * torch.finfo(torch.float32).min
    pw = state[P + "encoder.pos_conv_embed.conv.weight"]
    pos = F.conv1d(cast(x.transpose(1, 2)), cast(pw),
                   state[P + "encoder.pos_conv_embed.conv.bias"],
                   padding=pw.shape[-1] // 2,
                   groups=cfg["num_conv_pos_embedding_groups"])
    if pw.shape[-1] % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos).transpose(1, 2)
    heads = cfg["num_attention_heads"]
    hd = h // heads
    table = buckets(t, cfg["num_buckets"], cfg["max_bucket_distance"])
    rel = state[REL][table.to(x.device)].permute(2, 0, 1)  # (heads, T, T)
    for i in range(cfg["num_hidden_layers"]):
        lp = f"{P}encoder.layers.{i}."

        def split(z):
            return z.view(b, t, heads, hd).transpose(1, 2)

        y = _norm(x, state, lp + "layer_norm", eps)
        g = _dense(y.view(b, t, heads, hd), state,
                   lp + "attention.gru_rel_pos_linear", cast)
        g = torch.sigmoid(g.view(b, t, heads, 2, 4).sum(-1))
        const = state[lp + "attention.gru_rel_pos_const"].view(heads)
        gate = g[..., 0] * (g[..., 1] * const - 1.0) + 2.0  # (B, T, heads)
        q = split(_dense(y, state, lp + "attention.q_proj", cast)) * hd ** -0.5
        k = split(_dense(y, state, lp + "attention.k_proj", cast))
        v = split(_dense(y, state, lp + "attention.v_proj", cast))
        scores = (cast(q) @ cast(k).transpose(-1, -2)
                  + gate.transpose(1, 2)[..., None] * rel + pad)
        ctx = (cast(torch.softmax(scores, dim=-1)) @ cast(v)).transpose(
            1, 2).reshape(b, t, h)
        x = x + _dense(ctx, state, lp + "attention.out_proj", cast)
        ff = F.gelu(_dense(_norm(x, state, lp + "final_layer_norm", eps),
                           state, lp + "feed_forward.intermediate_dense",
                           cast))
        x = x + _dense(ff, state, lp + "feed_forward.output_dense", cast)
    x = _norm(x, state, P + "encoder.layer_norm", eps)
    weights = torch.softmax(_dense(x, state, "attention", cast), dim=1)
    return _dense((x * weights).sum(dim=1), state, "fc", cast)


@torch.no_grad()
def probabilities(state: dict, cfg: dict, waveforms: torch.Tensor,
                  lengths: torch.Tensor, cast, block: int = 16
                  ) -> np.ndarray:
    """(B, L) float32 rows and (B,) lengths -> (B, C) float64
    probabilities, computed ``block`` rows at a time."""
    out = []
    for i in range(0, waveforms.shape[0], block):
        z = logits(state, cfg, waveforms[i:i + block], lengths[i:i + block],
                   cast)
        out.append(torch.softmax(z.double(), dim=-1).cpu().numpy())
    return np.concatenate(out)
