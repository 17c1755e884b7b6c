"""The wav2vec 2.0 backbone, both architecture variants, as torch modules.

Counterpart of ``speech_intent_recognizer_tpu/models/wav2vec_flax.py``
(``Wav2Vec2Backbone`` and its parts) with the same semantics as
``transformers.Wav2Vec2Model`` in eval and train mode:

* **base** (post-LN, ``facebook/wav2vec2-base``): group-norm on conv layer 0
  only; each encoder layer is ``x = LN(x + attn(x)); x = LN2(x + ff(x))``;
  one LN right after the positional convolution;
* **stable** (pre-LN): layer norm after every conv layer; encoder layers
  ``x = x + attn(LN(x)); x = x + ff(LN2(x))``; a final LN after all layers.

``model_type="wavlm"`` (WavLM, Chen et al. 2021, arXiv 2110.13900 section
2; ``transformers.WavLMModel``) is either variant with a gated relative
position bias in every attention layer.  Once a call the encoder gathers
``P[h, i, j] = E[bucket(j - i), h]`` from layer 0's ``rel_attn_embed``
``E`` (:func:`relative_position_buckets`, the table cached per length and
device); each layer gates it per (row, head, query) from its own attention
input ``y``: ``(a, b) = sigmoid(sum over 4 of gru_rel_pos_linear(y_h))``,
``gate = a * (b * gru_rel_pos_const[h] - 1) + 2``, and adds ``gate * P``
to the float32 scores with the padding bias.  LayerDrop may skip layer 0
here (transformers never does, as it builds P there); P is built before
the layers, so nothing is lost.

Parameter names are the transformers ones, so a module's ``state_dict`` is
the ``Wav2Vec2Model`` layout, except that the positional convolution holds
one folded ``weight`` (``convert/wav2vec_import.py`` folds a checkpoint's
weight-norm pair), which is what the JAX package trains too.

Precision follows the Flax modules, not ``torch.autocast``: convolutions
and dense layers run in the compute dtype with fp32 parameters cast to it;
group and layer norms take and return fp32, so a bf16 activation comes back
as fp32 after every norm and a residual sum of the two promotes to fp32;
attention scores are computed in the compute dtype, then cast to fp32 for
the mask and the softmax, whose probabilities go back to the compute dtype.
The norms are torch's own kernels (two-pass variance), where Flax 0.12 uses
E[x^2] - E[x]^2: a difference within 1e-4 of the JAX package's output
(``tests/test_torch_wav2vec.py``).  Conv activations are (B, C, T), the
transformer's (B, T, H).

Tensor parallelism (a model group set by ``set_model_group``; none for a
WavLM backbone, whose bias and gates are not cut; the leaves
cut by ``parallel.sharding.place_params``), Megatron style: ``q_proj``,
``k_proj``, ``v_proj`` and ``intermediate_dense`` hold this process's
output columns, ``out_proj`` and ``output_dense`` its input columns.  The
input of a column-parallel layer passes Megatron's *f*
(``ops/model_parallel.copy_to_model``), a row-parallel layer's partial
products are summed over the group (*g*) before its bias.  Each process
runs the attention of its own heads; where its columns cut a head (a
column count that divides by the model axis but not into whole heads)
q, k and v are gathered whole and every process runs every head, then
keeps its columns of the result behind *f*.  A dropout inside the split
draws the whole layer's mask and keeps this process's heads or columns,
so every process draws what the one-process step draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from speech_intent_recognizer_tpu_torch.ops.global_batch import (
    base_generator, rand_part, rand_rows)
from speech_intent_recognizer_tpu_torch.ops.model_parallel import (
    copy_to_model, gather_on_use, model_part, part_slice, row_parallel)
from speech_intent_recognizer_tpu_torch.utils.profiling import record, span


def feat_extract_output_lengths(config, input_lengths: torch.Tensor
                                ) -> torch.Tensor:
    """Sample-space lengths -> conv-feature-space lengths: ``(L - k) // s +
    1`` per conv layer with floor division, so a row shorter than the
    receptive field gets a length <= 0."""
    lengths = input_lengths
    for kernel, stride in zip(config.conv_kernel, config.conv_stride):
        lengths = torch.div(lengths - kernel, stride,
                            rounding_mode="floor") + 1
    return lengths


def feature_space_attention_mask(config, attention_mask: torch.Tensor,
                                 t_out: int) -> torch.Tensor:
    """Sample-space padding mask (B, L) -> feature-space keep mask (B, T'),
    bool."""
    lengths = feat_extract_output_lengths(
        config, attention_mask.to(torch.int64).sum(-1))
    return (torch.arange(t_out, device=attention_mask.device)[None, :]
            < lengths[:, None])


def relative_position_buckets(t: int, num_buckets: int, max_distance: int
                              ) -> torch.Tensor:
    """(T, T) int64 buckets of key j relative to query i, ``r = j - i``, on
    the host (transformers' ``WavLMAttention._relative_positions_bucket``,
    op for op, so the float32 log rounds as there): half the buckets hold
    ``r > 0``, half ``r <= 0``; in each half ``|r|`` below a quarter of
    ``num_buckets`` is its own bucket, farther ones are log-spaced out to
    ``max_distance`` and the half's last bucket holds the rest."""
    half = num_buckets // 2
    exact = half // 2
    pos = torch.arange(t, dtype=torch.long)
    r = pos[None, :] - pos[:, None]
    buckets = (r > 0).to(torch.long) * half
    r = torch.abs(r)
    far = torch.log(r.float() / exact)
    far = far / math.log(max_distance / exact)
    far = far * (half - exact)
    far = (exact + far).to(torch.long)
    far = torch.min(far, torch.full_like(far, half - 1))
    return buckets + torch.where(r < exact, r, far)


def _dropout(x: torch.Tensor, p: float, training: bool,
             generator, part=None) -> torch.Tensor:
    """``generator``: a ``torch.Generator`` or an
    ``ops.global_batch.ShardedGenerator`` (the global batch's mask, this
    process's rows; dim 0 is the batch).  ``part``: ``(dim, index,
    count)`` when ``x`` is this process's part of the layer's output along
    ``dim`` (the whole mask drawn, the part kept)."""
    if not training or p <= 0.0:
        return x
    if part is None:
        u = rand_rows(x.shape, generator, x.device)
    else:
        u = rand_part(x.shape, generator, x.device, *part)
    keep = u >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def _dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


class ConvLayer(nn.Module):
    """One conv block of the feature encoder, (B, C_in, T) -> (B, C, T')."""

    def __init__(self, config, layer_id: int, dtype=torch.float32):
        super().__init__()
        c_in = 1 if layer_id == 0 else config.conv_dim[layer_id - 1]
        c_out = config.conv_dim[layer_id]
        self.dtype = dtype
        self.conv = nn.Conv1d(c_in, c_out, config.conv_kernel[layer_id],
                              stride=config.conv_stride[layer_id],
                              bias=bool(config.conv_bias))
        self.norm_kind = None
        if config.feat_extract_norm == "group" and layer_id == 0:
            # torch GroupNorm(C, C): per-channel statistics over all frames,
            # padding included, as the JAX package and transformers do
            self.layer_norm = nn.GroupNorm(c_out, c_out, eps=1e-5)
            self.norm_kind = "group"
        elif config.feat_extract_norm == "layer":
            self.layer_norm = nn.LayerNorm(c_out, eps=config.layer_norm_eps)
            self.norm_kind = "layer"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.conv.bias is None else self.conv.bias.to(dt)
        x = F.conv1d(x.to(dt), self.conv.weight.to(dt), bias,
                     stride=self.conv.stride)
        if self.norm_kind == "group":
            n = self.layer_norm
            x = F.group_norm(x.float(), n.num_groups, n.weight, n.bias, n.eps)
        elif self.norm_kind == "layer":
            x = _layer_norm(self.layer_norm, x.transpose(1, 2)).transpose(1, 2)
        return F.gelu(x)


class FeatureEncoder(nn.Module):
    """Raw waveform (B, L) -> conv features (B, conv_dim[-1], T')."""

    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_layers = nn.ModuleList(
            ConvLayer(config, i, dtype)
            for i in range(config.num_feat_extract_layers))

    def forward(self, input_values: torch.Tensor) -> torch.Tensor:
        with span("sir.w2v.encoder"):
            x = input_values[:, None, :].to(self.dtype)
            for layer in self.conv_layers:
                x = layer(x)
            return x


class FeatureProjection(nn.Module):
    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.p = config.feat_proj_dropout
        self.layer_norm = nn.LayerNorm(config.conv_dim[-1],
                                       eps=config.layer_norm_eps)
        self.projection = nn.Linear(config.conv_dim[-1], config.hidden_size)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = _dense(self.projection, _layer_norm(self.layer_norm, x),
                   self.dtype)
        return _dropout(x, self.p, self.training, generator)


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding over (B, T, H); the weight-norm
    pair of a checkpoint is folded into ``conv.weight``."""

    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        h, k = config.hidden_size, config.num_conv_pos_embeddings
        self.conv = nn.Conv1d(h, h, k, padding=k // 2,
                              groups=config.num_conv_pos_embedding_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, c = self.dtype, self.conv
        x, w, b = x.transpose(1, 2).to(dt), c.weight.to(dt), c.bias.to(dt)
        if x.device.type == "cpu" and dt != torch.float32:
            # oneDNN's bf16 grouped convolution on the CPU is wrong in some
            # torch builds (2.13: errors the size of the output); the same
            # bf16 operands, products summed in fp32 and rounded once, are
            # what a bf16 convolution computes
            y = F.conv1d(x.float(), w.float(), b.float(), padding=c.padding,
                         groups=c.groups).to(dt)
        else:
            y = F.conv1d(x, w, b, padding=c.padding, groups=c.groups)
        if c.kernel_size[0] % 2 == 0:  # torch SamePadLayer drops the tail
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class Attention(nn.Module):
    """Multi-head self-attention with the torch wav2vec2 scaling layout;
    in a WavLM layer (``relative``) with the gate of the relative position
    bias, and in layer 0 with the bucket embedding ``rel_attn_embed``."""

    model_group = None

    def __init__(self, config, dtype=torch.float32,
                 bucket_embedding: bool = False):
        super().__init__()
        h = config.hidden_size
        self.dtype = dtype
        self.n_heads = config.num_attention_heads
        self.p = config.attention_dropout
        self.q_proj = nn.Linear(h, h)
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)
        self.relative = config.model_type == "wavlm"
        if self.relative:
            self.gru_rel_pos_const = nn.Parameter(
                torch.ones(1, self.n_heads, 1, 1))
            self.gru_rel_pos_linear = nn.Linear(h // self.n_heads, 8)
            if bucket_embedding:
                self.rel_attn_embed = nn.Embedding(config.num_buckets,
                                                   self.n_heads)

    def relpos_gate(self, y: torch.Tensor) -> torch.Tensor:
        """(B, T, H) attention input -> (B, heads, T, 1) float32 gate of
        the relative position bias, from each head's slice of ``y``."""
        b, t, _ = y.shape
        g = _dense(self.gru_rel_pos_linear,
                   y.reshape(b, t, self.n_heads, -1), self.dtype).float()
        g = torch.sigmoid(g.view(b, t, self.n_heads, 2, 4).sum(-1))
        gate = g[..., :1] * (g[..., 1:] * self.gru_rel_pos_const.view(
            1, 1, -1, 1) - 1.0) + 2.0
        return gate.transpose(1, 2)

    def gated_bias(self, y: torch.Tensor, position_bias: torch.Tensor,
                   attn_bias: Optional[torch.Tensor]) -> torch.Tensor:
        """The scores' float32 bias of a WavLM layer: the (heads, T, T)
        ``position_bias`` gated per (row, head, query) from ``y``, plus
        the padding bias; (B, heads, T, T)."""
        gate = self.relpos_gate(y)
        if attn_bias is None:
            return gate * position_bias
        return torch.addcmul(attn_bias, gate, position_bias)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None,
                generator=None,
                position_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, h = x.shape
        dt, nh, group = self.dtype, self.n_heads, self.model_group
        hd = h // nh
        if position_bias is not None:
            with span("sir.w2v.relpos"):
                attn_bias = self.gated_bias(x, position_bias, attn_bias)
        cols = self.q_proj.weight.shape[0]  # this process's columns
        split = cols != h
        if split:
            x = copy_to_model(x, group)
        q, k, v = (_dense(proj, x, dt)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        # the heads this process runs: its own, or (its columns cut a head)
        # every head, from q, k and v gathered whole
        cut = split and cols % hd != 0
        if cut:
            q, k, v = (gather_on_use(a, group, -1) for a in (q, k, v))
        heads, part = nh, None
        if split and not cut:
            index, count = model_part(group)
            heads, part = cols // hd, (1, index, count)

        def split_heads(p):  # (B, T, heads * hd) -> (B, heads, T, hd)
            return p.reshape(b, t, heads, hd).transpose(1, 2)

        with span("sir.w2v.attention"):
            q = split_heads(q) * (hd ** -0.5)
            k, v = split_heads(k), split_heads(v)
            scores = torch.matmul(q, k.transpose(-1, -2)).float()
            if attn_bias is not None:
                scores = scores + attn_bias
            probs = torch.softmax(scores, dim=-1).to(dt)
            probs = _dropout(probs, self.p, self.training, generator, part)
            out = torch.matmul(probs, v).transpose(1, 2).reshape(
                b, t, heads * hd)
        if cut:
            out = copy_to_model(out, group)[..., part_slice(h, group)]
        if split:
            return row_parallel(out, self.out_proj.weight,
                                self.out_proj.bias, group)
        return _dense(self.out_proj, out, dt)


class FeedForward(nn.Module):
    model_group = None

    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.p_act = config.activation_dropout
        self.p_out = config.hidden_dropout
        self.intermediate_dense = nn.Linear(config.hidden_size,
                                            config.intermediate_size)
        self.output_dense = nn.Linear(config.intermediate_size,
                                      config.hidden_size)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        dense = self.intermediate_dense
        split = dense.weight.shape[0] != dense.out_features
        part = None
        if split:
            x = copy_to_model(x, self.model_group)
            index, count = model_part(self.model_group)
            part = (-1, index, count)
        x = F.gelu(_dense(self.intermediate_dense, x, self.dtype))
        x = _dropout(x, self.p_act, self.training, generator, part)
        if split:
            x = row_parallel(x, self.output_dense.weight,
                             self.output_dense.bias, self.model_group)
        else:
            x = _dense(self.output_dense, x, self.dtype)
        return _dropout(x, self.p_out, self.training, generator)


class EncoderLayer(nn.Module):
    """Post-LN (base) or pre-LN (stable) transformer layer."""

    def __init__(self, config, dtype=torch.float32,
                 bucket_embedding: bool = False):
        super().__init__()
        self.stable = bool(config.do_stable_layer_norm)
        self.p = config.hidden_dropout
        self.attention = Attention(config, dtype, bucket_embedding)
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       eps=config.layer_norm_eps)
        self.feed_forward = FeedForward(config, dtype)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size,
                                             eps=config.layer_norm_eps)

    def forward(self, x: torch.Tensor, attn_bias=None,
                generator=None, position_bias=None) -> torch.Tensor:
        def attn(y):
            return _dropout(self.attention(y, attn_bias, generator,
                                           position_bias),
                            self.p, self.training, generator)

        if self.stable:
            x = x + attn(_layer_norm(self.layer_norm, x))
            return x + self.feed_forward(
                _layer_norm(self.final_layer_norm, x), generator)
        x = _layer_norm(self.layer_norm, x + attn(x))
        return _layer_norm(self.final_layer_norm,
                           x + self.feed_forward(x, generator))


class Encoder(nn.Module):
    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        self.stable = bool(config.do_stable_layer_norm)
        self.p = config.hidden_dropout
        self.layerdrop = config.layerdrop
        self.pos_conv_embed = PositionalConvEmbedding(config, dtype)
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       eps=config.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(config, dtype, i == 0)
                                    for i in range(config.num_hidden_layers))
        self.relative = config.model_type == "wavlm"
        self.num_buckets = config.num_buckets
        self.max_bucket_distance = config.max_bucket_distance
        self._bucket_tables = {}  # (T, device) -> (T, T) int64 buckets

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None,
                generator=None) -> torch.Tensor:
        with span("sir.w2v.transformer"):
            return self._layers(x, keep, generator)

    def bucket_table(self, t: int, device) -> torch.Tensor:
        """The (T, T) bucket table on ``device``, built on the host once
        per (T, device) and kept (a ``relpos_table`` record of (T,
        device) each time one is built); a table built while a program is
        traced for export is not kept."""
        key = (t, torch.device(device))
        table = self._bucket_tables.get(key)
        if table is None:
            # a normal tensor even inside inference mode: a later training
            # step's embedding backward keeps it
            with torch.inference_mode(False):
                table = relative_position_buckets(
                    t, self.num_buckets, self.max_bucket_distance).to(device)
            if not torch.compiler.is_compiling():
                self._bucket_tables[key] = table
                record("relpos_table", t, str(key[1]))
        return table

    def position_bias(self, t: int, device) -> torch.Tensor:
        """(heads, T, T) float32 ungated relative position bias
        ``E[bucket(i, j), h]`` from layer 0's ``rel_attn_embed``."""
        embed = self.layers[0].attention.rel_attn_embed.weight
        return F.embedding(self.bucket_table(t, device),
                           embed.float()).permute(2, 0, 1).contiguous()

    def _layers(self, x: torch.Tensor, keep: Optional[torch.Tensor],
                generator) -> torch.Tensor:
        attn_bias = None
        if keep is not None:
            keep = keep.float()  # (B, T')
            x = x * keep[..., None].to(x.dtype)  # zero padded positions
            attn_bias = ((1.0 - keep)[:, None, None, :]
                         * torch.finfo(torch.float32).min)
        x = x + self.pos_conv_embed(x)
        if not self.stable:
            x = _layer_norm(self.layer_norm, x)
        x = _dropout(x, self.p, self.training, generator)
        position_bias = None
        if self.relative:
            with span("sir.w2v.relpos"):
                position_bias = self.position_bias(x.shape[1], x.device)
        for layer in self.layers:
            y = layer(x, attn_bias, generator, position_bias)
            if self.training and self.layerdrop > 0.0:
                # LayerDrop as the JAX package runs it: the layer is
                # computed, then skipped w.p. layerdrop (no rescale)
                u = torch.rand((), generator=base_generator(generator),
                               device=x.device)
                y = torch.where(u < 1.0 - self.layerdrop, y, x)
            x = y
        if self.stable:
            x = _layer_norm(self.layer_norm, x)
        return x


def set_model_group(module: nn.Module, group) -> None:
    """Hand every attention and feed-forward block of ``module`` the model
    group over which it holds parts of its leaves, or None.  A WavLM
    backbone takes none: its relative position bias and gates are not cut
    across a tensor-parallel group (ValueError)."""
    if group is not None and any(isinstance(m, Attention) and m.relative
                                 for m in module.modules()):
        raise ValueError("a WavLM backbone (model_type 'wavlm') cannot run "
                         "over a model group: its relative position bias "
                         "and gates are not split across tensor-parallel "
                         "processes; use a data axis only")
    for m in module.modules():
        if isinstance(m, (Attention, FeedForward)):
            m.model_group = group


class Wav2Vec2Backbone(nn.Module):
    """``(input_values (B, L), attention_mask (B, L)) -> hidden (B, T',
    H)``; ``mask_time_indices`` (B, T') bool puts the learned
    ``masked_spec_embed`` at the masked frames."""

    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        self.config = config
        # declared unconditionally, as in the checkpoint layouts
        self.masked_spec_embed = nn.Parameter(
            torch.empty(config.hidden_size))
        self.feature_extractor = FeatureEncoder(config, dtype)
        self.feature_projection = FeatureProjection(config, dtype)
        self.encoder = Encoder(config, dtype)

    def forward(self, input_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                mask_time_indices: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = self.feature_extractor(input_values).transpose(1, 2)
        hidden = self.feature_projection(feats, generator)
        keep = None
        if attention_mask is not None:
            keep = feature_space_attention_mask(self.config, attention_mask,
                                                hidden.shape[1])
        if mask_time_indices is not None:
            hidden = torch.where(mask_time_indices[..., None],
                                 self.masked_spec_embed.to(hidden.dtype),
                                 hidden)
        return self.encoder(hidden, keep, generator)


def init_backbone_(module: nn.Module,
                   generator: Optional[torch.Generator] = None) -> None:
    """Seeded initialisation: weights of conv and dense layers N(0,
    1/fan_in) (Flax's lecun-normal scale), their biases 0, norms unit-scale,
    ``masked_spec_embed`` U(0, 1) (the JAX package's initializer); WavLM's
    ``rel_attn_embed`` N(0, 1) and ``gru_rel_pos_const`` 1 (transformers'
    initializers)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Linear)):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Wav2Vec2Backbone):
                m.masked_spec_embed.uniform_(0.0, 1.0, generator=generator)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=generator)
            elif isinstance(m, Attention) and m.relative:
                m.gru_rel_pos_const.fill_(1.0)
