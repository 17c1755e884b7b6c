"""Plain PyTorch reference of the wav2vec 2.0 intent model (the base
architecture: group-norm feature encoder, post-LN encoder), waveform to
probabilities.

Written from the published description (Baevski et al. 2020, arXiv
2006.11477, and the ``facebook/wav2vec2-base`` configuration as
``transformers.Wav2Vec2Model`` runs it), with the reference project's head:

* feature encoder: 7 biasless 1-D convolutions, GroupNorm with a group per
  channel over every frame after the first, GELU after each;
* feature projection: LayerNorm, dense to the hidden size;
* padding: a frame is kept while its index is below the row's length
  mapped through every convolution, ``(n - kernel) // stride + 1``; kept
  frames pass, others are zeroed, and the attention adds the float32
  minimum to the scores of dropped keys;
* positional embedding: grouped convolution (kernel 128, 16 groups,
  padding 64, the last frame dropped), GELU, added; then LayerNorm;
* each encoder layer: ``x = LN(x + attn(x)); x = LN(x + ff(x))`` with
  12-head attention scaled by head_dim^-0.5 and a GELU feed-forward;
* head: softmax over time of a dense score, the weighted sum, the linear
  classifier, a softmax.

It reads the state dict in the transformers layout, the positional
convolution's weight-norm pair already folded into one weight, under
``wav2vec.``, with ``attention.*`` and ``fc.*`` for the head.  Every
convolution and product takes its operands through ``cast``
(``core.compare.CASTS``) and sums in float32.  It imports nothing of the
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

P = "wav2vec."


def weight_spec(cfg: dict) -> list:
    """The state dict this reference reads, as ``core.weights``
    specifications: weights N(0, 1/fan_in), biases and norm shifts small
    uniforms, norm scales near 1."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
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
        if i == 0:
            norm(f"{P}feature_extractor.conv_layers.0.layer_norm", c)
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
    for i in range(cfg["num_hidden_layers"]):
        lp = f"{P}encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(lp + "attention." + proj, h, h)
        norm(lp + "layer_norm", h)
        dense(lp + "feed_forward.intermediate_dense", f, h)
        dense(lp + "feed_forward.output_dense", h, f)
        norm(lp + "final_layer_norm", h)
    dense("attention", 1, h)
    dense("fc", cfg["num_classes"], h)
    return spec


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
        w = state[f"{P}feature_extractor.conv_layers.{i}.conv.weight"]
        x = F.conv1d(cast(x), cast(w), stride=s)
        if i == 0:
            gn = f"{P}feature_extractor.conv_layers.0.layer_norm"
            x = F.group_norm(x, x.shape[1], state[gn + ".weight"],
                             state[gn + ".bias"], 1e-5)
        x = F.gelu(x)
        n = torch.div(n - k, s, rounding_mode="floor") + 1
    x = _norm(x.transpose(1, 2), state, P + "feature_projection.layer_norm",
              eps)
    x = _dense(x, state, P + "feature_projection.projection", cast)
    b, t, h = x.shape
    keep = (torch.arange(t, device=x.device)[None, :] < n[:, None]).float()
    x = x * keep[..., None]
    bias = (1.0 - keep)[:, None, None, :] * torch.finfo(torch.float32).min
    pw = state[P + "encoder.pos_conv_embed.conv.weight"]
    pos = F.conv1d(cast(x.transpose(1, 2)), cast(pw),
                   state[P + "encoder.pos_conv_embed.conv.bias"],
                   padding=pw.shape[-1] // 2,
                   groups=cfg["num_conv_pos_embedding_groups"])
    if pw.shape[-1] % 2 == 0:
        pos = pos[:, :, :-1]
    x = _norm(x + F.gelu(pos).transpose(1, 2), state,
              P + "encoder.layer_norm", eps)
    heads = cfg["num_attention_heads"]
    hd = h // heads
    for i in range(cfg["num_hidden_layers"]):
        lp = f"{P}encoder.layers.{i}."

        def split(y):
            return y.view(b, t, heads, hd).transpose(1, 2)

        q = split(_dense(x, state, lp + "attention.q_proj", cast)) * hd ** -0.5
        k = split(_dense(x, state, lp + "attention.k_proj", cast))
        v = split(_dense(x, state, lp + "attention.v_proj", cast))
        scores = cast(q) @ cast(k).transpose(-1, -2) + bias
        ctx = (cast(torch.softmax(scores, dim=-1)) @ cast(v)).transpose(
            1, 2).reshape(b, t, h)
        x = _norm(x + _dense(ctx, state, lp + "attention.out_proj", cast),
                  state, lp + "layer_norm", eps)
        ff = F.gelu(_dense(x, state, lp + "feed_forward.intermediate_dense",
                           cast))
        ff = _dense(ff, state, lp + "feed_forward.output_dense", cast)
        x = _norm(x + ff, state, lp + "final_layer_norm", eps)
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
