"""wav2vec2 and WavLM checkpoints -> the port's ``Wav2VecIntent`` state
dict.

Counterpart of ``speech_intent_recognizer_tpu/convert/wav2vec_import.py``,
written for torch.  The port's modules keep the transformers names
(``models/wav2vec_backbone.py``), so most keys pass through; what changes:

* the positional convolution's weight-norm pair (``weight_g`` /
  ``weight_v`` or ``parametrizations.weight.original0`` / ``original1``) is
  folded into one ``encoder.pos_conv_embed.conv.weight``: ``w = g * v /
  ||v||`` with the norm over (out, in) at each kernel position (torch
  ``weight_norm(..., dim=2)``), in float64;
* a reference ``Wav2VecIntent`` state dict has its backbone under
  ``wav2vec.``, ``wav2vec2.`` or ``wavlm.``; the port's is ``wav2vec.``;
* a ``transformers.WavLMModel`` state dict is a wav2vec2 one with layer
  0's ``attention.rel_attn_embed.weight`` and every layer's
  ``attention.gru_rel_pos_linear.*`` and ``attention.gru_rel_pos_const``,
  which pass through under the same names;
* the JAX package's Flax ``params`` tree (numpy) maps back by the inverse
  of its layout: conv ``kernel`` (K, I/g, O) -> ``weight`` (O, I/g, K),
  dense ``kernel`` -> ``weight`` transposed, norm ``scale`` -> ``weight``,
  ``conv_layers_{i}`` / ``layers_{i}`` -> ``conv_layers.{i}`` /
  ``layers.{i}``, backbone ``wav2vec2`` -> ``wav2vec``.

:func:`load_pretrained_dir` reads a local ``save_pretrained`` directory
(``config.json`` with ``model.safetensors`` or ``pytorch_model.bin``)
without ``transformers`` or ``safetensors``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from speech_intent_recognizer_tpu_torch.models.wav2vec import Wav2Vec2Config

_POS = "encoder.pos_conv_embed.conv"
_NORM_PAIRS = (("weight_g", "weight_v"),
               ("parametrizations.weight.original0",
                "parametrizations.weight.original1"))
_BACKBONE_PREFIXES = ("wav2vec.", "wav2vec2.", "wavlm.")
_REL_EMBED = "encoder.layers.0.attention.rel_attn_embed.weight"


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """torch ``weight_norm(conv, dim=2)``: the norm over (out, in) at each
    kernel position, computed in float64, returned in ``v``'s dtype."""
    v64 = v.double()
    norm = v64.square().sum(dim=(0, 1), keepdim=True).sqrt()
    return (g.double() * v64 / norm).to(v.dtype)


def convert_wav2vec_state_dict(state: Mapping) -> Dict[str, torch.Tensor]:
    """A ``transformers.Wav2Vec2Model`` or ``WavLMModel`` state dict ->
    the port's backbone state dict (no prefix), weight norm folded."""
    out = dict(state)
    for g_key, v_key in _NORM_PAIRS:
        if f"{_POS}.{g_key}" in out:
            out[f"{_POS}.weight"] = fold_weight_norm(
                out.pop(f"{_POS}.{g_key}"), out.pop(f"{_POS}.{v_key}"))
    if "feature_extractor.conv_layers.0.conv.weight" not in out:
        raise KeyError("no feature_extractor.conv_layers.* in state dict")
    return out


def _backbone(state: Mapping) -> Dict:
    for prefix in _BACKBONE_PREFIXES:
        sub = {k[len(prefix):]: v for k, v in state.items()
               if k.startswith(prefix)}
        if sub:
            return sub
    raise KeyError("no wav2vec backbone keys (wav2vec.* / wav2vec2.* / "
                   "wavlm.*) in state dict")


def convert_wav2vec_intent_state_dict(
        state: Mapping) -> Tuple[Dict[str, torch.Tensor], int]:
    """A reference ``Wav2VecIntent`` state dict (``wav2vec.*``,
    ``wav2vec2.*`` or ``wavlm.*`` backbone, ``attention.*`` and ``fc.*``
    head) -> (the port's state dict, num_classes)."""
    out = {f"wav2vec.{k}": v for k, v in
           convert_wav2vec_state_dict(_backbone(state)).items()}
    for head in ("attention", "fc"):
        for name in ("weight", "bias"):
            out[f"{head}.{name}"] = state[f"{head}.{name}"]
    return out, int(out["fc.weight"].shape[0])


def is_wav2vec_state(state: Mapping) -> bool:
    return any(k.startswith(_BACKBONE_PREFIXES) for k in state)


def _layer_count(state: Mapping, pattern: str) -> int:
    found = [int(m.group(1)) for k in state if (m := re.match(pattern, k))]
    return 1 + max(found) if found else 0


def infer_wav2vec_config(state: Mapping) -> Wav2Vec2Config:
    """The config of a backbone state dict (no prefix), from its weight
    shapes, by the JAX function's rules: strides are not in the weights, so
    the canonical ``(5, 2, 2, ...)`` is assumed; heads = hidden // 64; the
    encoder is pre-LN exactly when the feature norm is per layer.  A state
    with layer 0's ``rel_attn_embed`` is WavLM: ``num_buckets`` and the
    head count are that table's shape; ``max_bucket_distance`` is not in
    the weights and stays at the published 800."""
    hidden = int(state["feature_projection.projection.weight"].shape[0])
    wavlm = {}
    if _REL_EMBED in state:
        buckets, heads = state[_REL_EMBED].shape
        wavlm = dict(model_type="wavlm", num_buckets=int(buckets),
                     num_attention_heads=int(heads))
    n_conv = _layer_count(state, r"feature_extractor\.conv_layers\.(\d+)\.")
    conv_ws = [state[f"feature_extractor.conv_layers.{i}.conv.weight"]
               for i in range(n_conv)]
    feat_norm = ("layer"
                 if "feature_extractor.conv_layers.1.layer_norm.weight"
                 in state else "group")
    pos_w = next(state[f"{_POS}.{name}"] for name in
                 ("weight_v", "parametrizations.weight.original1", "weight")
                 if f"{_POS}.{name}" in state)
    return Wav2Vec2Config(
        hidden_size=hidden,
        num_hidden_layers=_layer_count(state, r"encoder\.layers\.(\d+)\."),
        num_attention_heads=max(1, hidden // 64),
        intermediate_size=int(state[
            "encoder.layers.0.feed_forward.intermediate_dense.weight"
        ].shape[0]),
        conv_dim=tuple(int(w.shape[0]) for w in conv_ws),
        conv_kernel=tuple(int(w.shape[2]) for w in conv_ws),
        conv_stride=(5,) + (2,) * (n_conv - 1),
        num_feat_extract_layers=n_conv,
        num_conv_pos_embeddings=int(pos_w.shape[2]),
        num_conv_pos_embedding_groups=hidden // int(pos_w.shape[1]),
        conv_bias="feature_extractor.conv_layers.0.conv.bias" in state,
        feat_extract_norm=feat_norm,
        do_stable_layer_norm=(feat_norm == "layer"),
    ).replace(**wavlm)


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Wav2VecIntent`` Flax ``params`` (nested dicts of
    numpy arrays: ``wav2vec2`` backbone, ``attention``, ``fc``) -> the
    port's state dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, value in node.items():
            name = re.sub(r"^(conv_layers|layers)_(\d+)$", r"\1.\2",
                          "wav2vec" if key == "wav2vec2" and not prefix
                          else key)
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            a = np.array(value, dtype=np.float32)
            if name == "kernel":  # conv (K, I/g, O) or dense (I, O)
                name, a = "weight", np.ascontiguousarray(a.transpose(
                    tuple(reversed(range(a.ndim)))))
            elif name == "scale":
                name = "weight"
            out[prefix + name] = torch.from_numpy(a)

    walk(params, "")
    return out


def load_pretrained_dir(path: str) -> Tuple[Wav2Vec2Config,
                                            Dict[str, torch.Tensor]]:
    """A local ``save_pretrained`` directory of a wav2vec2 or WavLM model
    -> (config, the port's backbone state dict).  A checkpoint of a model
    with a head (``Wav2Vec2ForPreTraining``, ``...ForCTC``,
    ``WavLMFor...``) keeps its backbone under ``wav2vec2.`` or ``wavlm.``;
    the rest of it (quantizer, projections, head) is left out."""
    from speech_intent_recognizer_tpu_torch.convert.safetensors import (
        load_file)

    with open(os.path.join(path, "config.json")) as f:
        config = Wav2Vec2Config.from_dict(json.load(f))
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        state = load_file(st)
    else:
        state = torch.load(os.path.join(path, "pytorch_model.bin"),
                           map_location="cpu", weights_only=True)
    for prefix in ("wav2vec2.", "wavlm."):
        if any(k.startswith(prefix) for k in state):
            state = {k[len(prefix):]: v for k, v in state.items()
                     if k.startswith(prefix)}
    return config, {k: v.float() for k, v in
                    convert_wav2vec_state_dict(state).items()}
