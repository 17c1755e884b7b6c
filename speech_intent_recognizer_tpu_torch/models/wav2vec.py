"""Wav2VecIntent: raw-waveform intent classifier on a wav2vec 2.0 backbone.

Counterpart of ``speech_intent_recognizer_tpu/models/wav2vec.py``: the
backbone (``models/wav2vec_backbone.py``, either architecture variant),
softmax-attention pooling over time and a linear head, the reference's
design (``models/__pycache__/model_wav2vec.cpython-313.pyc``, SURVEY.md
section 2).  The submodules are ``wav2vec`` (backbone), ``attention``
(hidden -> 1) and ``fc`` (hidden -> classes), so ``state_dict()`` is the
reference ``Wav2VecIntent`` layout that ``convert/wav2vec_import.py`` reads
(with the positional convolution's weight folded).

The configuration is this package's own :class:`Wav2Vec2Config`, with the
fields the model reads and the defaults of ``facebook/wav2vec2-base``; it
reads ``transformers.Wav2Vec2Config.to_dict()`` output (``from_dict``
ignores the keys it does not keep), so neither ``transformers`` nor a
network is needed.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch
from torch import nn

from speech_intent_recognizer_tpu_torch.models.wav2vec_backbone import (
    Wav2Vec2Backbone, init_backbone_, set_model_group)
from speech_intent_recognizer_tpu_torch.ops.model_parallel import (
    split_attention_pool)

logger = logging.getLogger(__name__)


@dataclass
class Wav2Vec2Config:
    """The wav2vec2 fields the model reads; defaults: wav2vec2-base."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    num_feat_extract_layers: int = 7
    conv_bias: bool = False
    feat_extract_norm: str = "group"
    do_stable_layer_norm: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    feat_proj_dropout: float = 0.0
    layerdrop: float = 0.1

    def __post_init__(self) -> None:
        for name in ("conv_dim", "conv_kernel", "conv_stride"):
            setattr(self, name, tuple(int(v) for v in getattr(self, name)))

    @classmethod
    def from_dict(cls, raw: dict) -> "Wav2Vec2Config":
        """Build from a dict; keys the model does not read are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in names})

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        for name in ("conv_dim", "conv_kernel", "conv_stride"):
            out[name] = list(out[name])
        return out

    def replace(self, **changes) -> "Wav2Vec2Config":
        return dataclasses.replace(self, **changes)


def small_wav2vec_config(hidden_size: int = 64,
                         num_layers: int = 2) -> Wav2Vec2Config:
    """A tiny stable-LN config for tests and smoke runs (the JAX package's
    ``small_wav2vec_config``)."""
    return Wav2Vec2Config(
        hidden_size=hidden_size,
        num_hidden_layers=num_layers,
        num_attention_heads=max(2, hidden_size // 32),
        intermediate_size=hidden_size * 2,
        conv_dim=(32, 32, 32),
        conv_kernel=(10, 3, 3),
        conv_stride=(5, 2, 2),
        num_feat_extract_layers=3,
        num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4,
        do_stable_layer_norm=True,
        feat_extract_norm="layer",
    )


def small_wav2vec_base_config(hidden_size: int = 64,
                              num_layers: int = 2) -> Wav2Vec2Config:
    """Tiny config with the wav2vec2-base architecture flags (post-LN
    encoder, group feature norm, biasless convs)."""
    return small_wav2vec_config(hidden_size, num_layers).replace(
        do_stable_layer_norm=False, feat_extract_norm="group",
        conv_bias=False)


class Wav2VecIntent(nn.Module):
    """wav2vec2 encoder + attention pooling + intent head.

    ``forward(input_values (B, L), attention_mask (B, L)) -> (B, C)``
    fp32 logits.  The waveforms are rounded to the compute dtype first, as
    the JAX model does; the head runs in fp32.  The pooling softmax over
    time does not mask padded frames (the JAX package's
    ``models/wav2vec.py:116``).  With a model group
    (:meth:`set_model_group`) the encoder runs Megatron-split
    (``models/wav2vec_backbone.py``) and the head row-parallel, as the
    CNN-GRU's."""

    model_group = None

    def __init__(self, config: Wav2Vec2Config, num_classes: int = 31,
                 compute_dtype=torch.float32):
        super().__init__()
        self.config = config
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.wav2vec = Wav2Vec2Backbone(config, compute_dtype)
        self.attention = nn.Linear(config.hidden_size, 1)
        self.fc = nn.Linear(config.hidden_size, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> "Wav2VecIntent":
        """Seeded initialisation from ``generator``
        (:func:`.wav2vec_backbone.init_backbone_`, the head included)."""
        init_backbone_(self, generator)
        return self

    def set_model_group(self, group) -> None:
        """The model group over which this process holds parts of the
        encoder's and the head's split leaves (``parallel.sharding.
        place_params`` cuts them and calls this), or None."""
        self.model_group = group
        set_model_group(self.wav2vec, group)

    def forward(self, input_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                mask_time_indices: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        hidden = self.wav2vec(input_values.to(self.compute_dtype),
                              attention_mask, mask_time_indices,
                              generator).float()
        if self.fc.weight.shape[1] != hidden.shape[-1]:  # row-parallel
            return split_attention_pool(hidden, self.attention, self.fc,
                                        self.model_group)
        weights = torch.softmax(self.attention(hidden), dim=1)
        return self.fc((hidden * weights).sum(dim=1))


def create_wav2vec_intent(num_classes: int,
                          model_name: Optional[str] = None,
                          config: Optional[Wav2Vec2Config] = None,
                          compute_dtype=torch.float32
                          ) -> Tuple[Wav2VecIntent, Optional[dict]]:
    """Build the model from ``config``, or from ``model_name`` when that is
    a local ``save_pretrained`` directory; returns ``(module,
    pretrained_backbone_state_or_None)``.  The module's parameters are not
    initialised yet (:func:`init_wav2vec`).

    As in the JAX package, a ``model_name`` that cannot be loaded falls back
    to :func:`small_wav2vec_config` (hidden 64, 2 layers), with a warning,
    and not to the architecture the name stands for."""
    pretrained = None
    if config is None and model_name:
        from speech_intent_recognizer_tpu_torch.convert.wav2vec_import import (
            load_pretrained_dir)

        try:
            if not os.path.isdir(model_name):
                raise FileNotFoundError(f"{model_name!r} is not a local "
                                        "save_pretrained directory")
            config, backbone = load_pretrained_dir(model_name)
            pretrained = {f"wav2vec.{k}": v for k, v in backbone.items()}
        except (OSError, KeyError, ValueError) as e:
            logger.warning("pretrained %s unavailable (%s); random init from "
                           "small_wav2vec_config() (hidden 64, 2 layers)",
                           model_name, e)
    if config is None:
        config = small_wav2vec_config()
    return Wav2VecIntent(config, num_classes, compute_dtype), pretrained


def init_wav2vec(model: Wav2VecIntent, seed: int,
                 pretrained_state: Optional[dict] = None) -> Wav2VecIntent:
    """Seeded initialisation from ``torch.Generator().manual_seed(seed)``,
    then the pretrained backbone over it (the head stays fresh)."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if pretrained_state:
        missing, unexpected = model.load_state_dict(pretrained_state,
                                                    strict=False)
        stray = [k for k in missing if not k.startswith(("attention.",
                                                         "fc."))]
        if stray or unexpected:
            raise KeyError(f"pretrained backbone does not fit the model: "
                           f"missing {stray[:5]}, unexpected "
                           f"{list(unexpected)[:5]}")
    return model


def feature_extractor_params(model: nn.Module
                             ) -> Iterator[nn.Parameter]:
    """The conv feature encoder's parameters (names containing
    ``feature_extractor``; ``feature_projection`` is not among them): what
    the reference trainer's ``freeze_feature_extractor`` freezes."""
    return (p for name, p in model.named_parameters()
            if "feature_extractor" in name)
