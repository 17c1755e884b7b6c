"""Offline inference: batch waveforms, single file, array, directory.

Counterpart of ``speech_intent_recognizer_tpu/infer/predict.py``
(``Predictor``).  ``from_checkpoint`` folds BatchNorm and, for the reference
geometry, serves the ``conv1_external`` bf16 variant behind the fused
front-end + conv1 kernel where K1 serves (``ops.frontend_kernels.
conv1_engages``): on a CUDA device ``predict_waveform_batch`` then launches
K1 once and K2 once per GRU layer.  Where conv2 and conv3 meet the K5
kernel's contract (``ops.conv23.engages``: channels (32, 64, 128)) the
variant runs them as one K5 launch in its conv stage (the ``conv23``
form); elsewhere as ``F.conv2d`` with torch's bias-add, ReLU and max-pool.
The unfused model (``fold_bn=False``, or where K1 does not serve) takes
its features from ``log_mel_frontend``, the fused front-end kernel K3 on a
CUDA device at the reference geometry and the dB-mel kernel K4 at any
other.  The choice follows the checkpoint's shapes and the audio geometry:
there is no probe, no caller's switch and no switch to another path at
run time; CPU devices run the kernels' plain versions.

Each configuration is one :class:`ServingBody` (``Predictor._fused_body``),
the module that ``predict_waveform_batch`` runs and that
``infer/export.py`` traces into a serving artifact; its state dict holds
every weight it reads, K1's conv1 and K5's packed operands included.

A serving mesh (``mesh=``, a mesh of devices in this process from
``parallel.create_mesh``) runs the batch data-parallel, as the JAX
predictor's ``shard_map`` over ``data``: the batch padded to a multiple of
the data axis, each data shard through a replica of the serving body on
its device (its own K1, K2 and K5 launches), the pad rows stripped; a
``model`` axis is replicated (shard ``d`` runs on ``devices[d * model]``).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from speech_intent_recognizer_tpu_torch.config import AudioConfig
from speech_intent_recognizer_tpu_torch.data.audio_io import load_audio
from speech_intent_recognizer_tpu_torch.evaluation.metrics import (
    top_k_predictions)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    FrontendModule, FrontendParams, log_mel_conv1_frontend, log_mel_frontend,
    make_frontend_params, padded_samples)
from speech_intent_recognizer_tpu_torch.parallel.sharding import (
    check_in_process, replicas, run_sharded)
from speech_intent_recognizer_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

_AUDIO_EXTS = (".wav", ".mp3", ".flac")


def _state_widths(state: Dict[str, torch.Tensor]) -> dict:
    """The CNNAudioGRU widths of a reference-layout state dict: the conv
    stages' output channels, the GRU's hidden size and layers, and the
    classifier head's output width (the class count)."""
    convs = sorted(int(k[len("conv"):-len(".weight")]) for k in state
                   if k.startswith("conv") and k.endswith(".weight"))
    layers = sum(1 for k in state if k.startswith("gru.weight_hh_l")
                 and not k.endswith("_reverse"))
    return dict(num_classes=int(state["fc.weight"].shape[0]),
                conv_channels=tuple(int(state[f"conv{i}.weight"].shape[0])
                                    for i in convs),
                gru_hidden=int(state["gru.weight_hh_l0"].shape[1]),
                gru_layers=layers)


class ServingBody(torch.nn.Module):
    """The batch path of one serving configuration: (B, L) float32
    waveforms, or their (B, L / hop, hop) rows, and (B,) int32 lengths ->
    (B, C) float32 probabilities.

    * ``conv1`` given: K1 -> ``model``, the ``conv1_external`` variant
      (K5 inside it in the ``conv23`` form);
    * else: ``log_mel_frontend`` (K3, or K4 off the reference geometry)
      -> ``model``.

    ``conv1`` is K1's (weight, bias); it becomes buffers, so the state dict
    is every weight the path reads.  The front-end's constants are
    non-persistent buffers (:class:`.frontend.FrontendModule`).
    """

    _CONV1 = ("conv1_weight", "conv1_bias")

    def __init__(self, params: FrontendParams, model: CNNAudioGRU,
                 conv1: Optional[tuple] = None):
        super().__init__()
        self.frontend = FrontendModule(params)
        self.model = model
        self.with_conv1 = conv1 is not None
        for name, t in zip(self._CONV1, conv1 or ()):
            self.register_buffer(name, t)

    def forward(self, waveforms: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        if waveforms.dim() == 3:  # rows of a flat buffer
            waveforms = waveforms.flatten(1)
        fe = self.frontend.params
        with span("sir.frontend"):
            if not self.with_conv1:
                x = log_mel_frontend(waveforms, lengths, fe)
            else:
                x = log_mel_conv1_frontend(waveforms, lengths, fe,
                                           self.conv1_weight,
                                           self.conv1_bias)
        return torch.softmax(self.model(x).float(), dim=-1)


class Predictor:
    """End-to-end (waveform -> intent) predictor on one device, or on the
    devices of a serving mesh (``mesh``; the model then lives on its first
    device and ``device`` is not read)."""

    def __init__(self, model: CNNAudioGRU, label_map: Dict[str, int],
                 audio_cfg: Optional[AudioConfig] = None,
                 device: "str | torch.device" = "cuda", mesh=None):
        self._setup(model, label_map, audio_cfg, device, mesh)
        self.model.gru.inference_operands()  # kept until a leaf changes
        self.frontend_params = make_frontend_params(self.audio_cfg,
                                                    self.device)
        # the fused front-end + conv1 path (K1 -> the conv1_external
        # variant) when it serves batch waveform inference
        self._conv1: Optional[ServingBody] = None
        self._unfused: Optional[ServingBody] = None  # built at first use

    def _setup(self, model: torch.nn.Module, label_map: Dict[str, int],
               audio_cfg: Optional[AudioConfig],
               device: "str | torch.device", mesh) -> None:
        """What every predictor holds: the device, the model on it in eval
        mode, the label maps, the audio geometry and the serving mesh."""
        check_in_process(mesh)
        self.mesh = mesh
        self._replicas = None  # (body, its replica on each mesh device)
        self.device = torch.device(mesh.devices[0] if mesh is not None
                                   else device)
        self.model = model.to(self.device).eval()
        self.label_map = label_map
        self.inv_label_map = {v: k for k, v in label_map.items()}
        self.audio_cfg = audio_cfg or AudioConfig()

    @classmethod
    def from_checkpoint(cls, model_path: str, label_map_path: str,
                        audio_cfg: Optional[AudioConfig] = None,
                        num_classes: Optional[int] = None,
                        fold_bn: bool = True,
                        device: "str | torch.device" = "cuda",
                        mesh=None) -> "Predictor":
        """``model_path``: a ``.pt`` / ``.pth`` state dict or a ``.msgpack``
        of the JAX trainer; the model takes the checkpoint's widths.
        ``mesh``: the serving mesh."""
        from speech_intent_recognizer_tpu_torch.convert.checkpoint import (
            load_model_checkpoint)
        from speech_intent_recognizer_tpu_torch.data.labelmap import (
            load_label_map)
        from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
            fold_batchnorm)

        label_map = load_label_map(label_map_path)
        state = load_model_checkpoint(model_path)
        widths = _state_widths(state)
        if num_classes is not None:
            widths["num_classes"] = num_classes
        if fold_bn and any(k.startswith("bn") for k in state):
            folded = fold_batchnorm(state)
            model = CNNAudioGRU(fold_bn=True, **widths)
            model.load_state_dict(folded)
            pred = cls(model, label_map, audio_cfg, device, mesh)
            pred._maybe_enable_conv1_fusion(folded)
            return pred
        model = CNNAudioGRU(**widths)
        model.load_state_dict(state)
        return cls(model, label_map, audio_cfg, device, mesh)

    def _widths(self) -> dict:
        """The served model's widths, for its inference variants."""
        m = self.model
        return dict(num_classes=m.num_classes, conv_channels=m.conv_channels,
                    gru_hidden=m.gru.hidden_size, gru_layers=m.gru.num_layers)

    def _maybe_enable_conv1_fusion(self, folded: Dict[str, torch.Tensor]
                                   ) -> None:
        """Serve K1 -> the bf16 ``conv1_external`` variant where K1 serves
        the front-end and the folded conv1 (``fk.conv1_engages``): in the
        ``conv23`` form where K5 serves conv2 / conv3 (``k5.engages``),
        else with torch's epilogues.  Elsewhere the unfused model serves."""
        from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
            conv1_external_params, conv23_params)
        from speech_intent_recognizer_tpu_torch.ops import conv23 as k5
        from speech_intent_recognizer_tpu_torch.ops import (
            frontend_kernels as fk)

        if not fk.conv1_engages(self.frontend_params,
                                folded.get("conv1.weight"),
                                folded.get("conv1.bias")):
            return
        if k5.engages(self.model.conv_channels):
            self._serve_k1(*conv23_params(folded), conv23=True)
        else:
            self._serve_k1(*conv1_external_params(folded))

    def _serve_k1(self, variant_state: Dict[str, torch.Tensor],
                  conv1_weight: torch.Tensor, conv1_bias: torch.Tensor,
                  **form) -> None:
        """Serve K1 -> the bf16 ``conv1_external`` variant loaded from
        ``variant_state``, in ``form``: ``CNNAudioGRU``'s keywords of the
        variant's conv stage (none: torch's epilogues).  The variant's GRU
        keeps its inference operands (``TorchGRU.inference_operands``), as
        the ``conv23`` form holds K5's."""
        variant = CNNAudioGRU(compute_dtype=torch.bfloat16, fold_bn=True,
                              conv1_external=True, **form, **self._widths())
        variant.load_state_dict(variant_state)
        variant.to(self.device).eval().gru.inference_operands()
        self._conv1 = ServingBody(
            self.frontend_params, variant,
            conv1=(conv1_weight.to(self.device, torch.bfloat16).contiguous(),
                   conv1_bias.to(self.device, torch.bfloat16).contiguous()))

    def enable_conv23_kernel(self) -> None:
        """The JAX predictor's switch to K1 -> K5 -> GRU head.  Where K5
        serves, the predictor already runs it and nothing changes; elsewhere
        this raises."""
        if self._conv1 is None or not self._conv1.model.conv23:
            raise ValueError("conv23 kernel requires the reference "
                             "geometry and channels (32, 64, 128)")

    def _fused_body(self) -> ServingBody:
        """The module the batch path runs in the current configuration
        (the fused conv1 path, or the unfused model); its state dict is
        the weights it reads.  What ``infer.export.export_predictor``
        traces for the production flavour."""
        if self._conv1 is not None:
            return self._conv1
        if self._unfused is None:
            self._unfused = ServingBody(self.frontend_params, self.model)
        return self._unfused

    def _probabilities(self, wf: torch.Tensor, ln: torch.Tensor
                       ) -> torch.Tensor:
        body = self._fused_body()
        if self.mesh is None:
            return body(wf, ln)
        if self._replicas is None or self._replicas[0] is not body:
            self._replicas = (body, replicas(body, self.mesh))
        bodies = self._replicas[1]
        return run_sharded(lambda i, w, n: bodies[i](w, n), self.mesh, wf,
                           ln)

    def predict_waveform_batch(self, waveforms, lengths) -> np.ndarray:
        """(B, L) float32 + (B,) lengths -> (B, C) probabilities.

        ``waveforms`` is a NumPy array or a tensor (one already on the
        predictor's device is used in place); each row is zero-padded past
        its true length, and lengths stay below L.  Traced as the span
        ``sir.predict``, with its copies to the device and of the
        probabilities to the host in spans of their own."""
        with span("sir.predict"), torch.inference_mode():
            with span("sir.predict.upload"):
                wf = torch.as_tensor(waveforms).to(
                    self.device, torch.float32).contiguous()
                ln = torch.as_tensor(lengths).to(
                    self.device, torch.int32).contiguous()
            probs = self._probabilities(wf, ln)
            with span("sir.predict.fetch"):
                return probs.cpu().numpy()

    # ------------------------------------------------------------- file API

    def _buffer_width(self) -> int:
        return padded_samples(self.audio_cfg.max_samples,
                              self.audio_cfg.hop_length)

    def _buffer(self, x: np.ndarray):
        n = min(len(x), self.audio_cfg.max_samples)
        buf = np.zeros((1, self._buffer_width()), np.float32)
        buf[0, :n] = x[:n]
        return buf, np.asarray([max(n, 1)], np.int32)

    def _result(self, buf: np.ndarray, lengths: np.ndarray,
                top_k: int) -> dict:
        probs = self.predict_waveform_batch(buf, lengths)[0]
        pred = int(np.argmax(probs))
        return {
            "predicted_label": self.inv_label_map.get(pred, "Unknown"),
            "confidence": float(probs[pred]),
            "top_predictions": top_k_predictions(probs, self.inv_label_map,
                                                 top_k),
        }

    def predict_file(self, audio_path: str, top_k: int = 3) -> Optional[dict]:
        """Reference ``predict`` result shape (``test_model.py:136-140``);
        None when the file cannot be read or decoded."""
        try:
            x, _ = load_audio(audio_path,
                              target_sample_rate=self.audio_cfg.sample_rate)
        except Exception as e:  # unreadable or undecodable, as the reference
            logger.error("error processing %s: %s", audio_path, e)
            return None
        return self._result(*self._buffer(x), top_k)

    def predict_array(self, samples: np.ndarray, sample_rate: int,
                      top_k: int = 3) -> dict:
        """Predict from an in-memory waveform (the mic-callback path)."""
        from speech_intent_recognizer_tpu_torch.ops.resample import (
            resample_np)

        x = np.asarray(samples, np.float32).reshape(-1)
        if sample_rate != self.audio_cfg.sample_rate:
            x = resample_np(x, sample_rate,
                            self.audio_cfg.sample_rate).astype(np.float32)
        return self._result(*self._buffer(x), top_k)

    def predict_directory(self, audio_dir: str, top_k: int = 3) -> List[dict]:
        """Batch mode over a directory (``test_model.py:190-223``)."""
        files = sorted(
            os.path.join(audio_dir, f) for f in os.listdir(audio_dir)
            if f.lower().endswith(_AUDIO_EXTS))
        results = []
        for path in files:
            r = self.predict_file(path, top_k)
            if r is None:
                continue
            r["file"] = os.path.basename(path)
            results.append(r)
        return results


class Wav2VecServingBody(torch.nn.Module):
    """The wav2vec batch path: (B, L) float32 waveforms and (B,) int32
    lengths -> (B, C) float32 probabilities, the padding mask ``arange(L) <
    lengths`` (the JAX ``Wav2VecPredictor``'s).  Launches none of the
    package's kernels: the model is PyTorch's own convolutions, GEMMs and
    norms."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, waveforms: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        mask = (torch.arange(waveforms.shape[1], device=waveforms.device)
                [None, :] < lengths[:, None])
        return torch.softmax(self.model(waveforms, mask).float(), dim=-1)


class Wav2VecPredictor(Predictor):
    """Predictor over the raw-waveform ``Wav2VecIntent`` model.

    Counterpart of the JAX package's ``Wav2VecPredictor``: the same file /
    array / directory API as :class:`Predictor`, but the batch path feeds
    raw waveforms and their padding mask to the wav2vec backbone
    (:class:`Wav2VecServingBody`); there is no log-mel front-end and no
    framing, so a buffer is ``max_samples`` wide.
    """

    def __init__(self, model: torch.nn.Module, label_map: Dict[str, int],
                 audio_cfg: Optional[AudioConfig] = None,
                 device: "str | torch.device" = "cuda", mesh=None):
        self._setup(model, label_map, audio_cfg, device, mesh)
        self._body = Wav2VecServingBody(self.model)

    @classmethod
    def from_checkpoint(cls, model_path: str, label_map_path: str,
                        audio_cfg: Optional[AudioConfig] = None,
                        num_classes: Optional[int] = None,
                        wav2vec_config=None,
                        device: "str | torch.device" = "cuda",
                        compute_dtype=torch.float32,
                        mesh=None) -> "Wav2VecPredictor":
        """``model_path``: the port's ``.pt``, a reference-layout ``.pt``
        (``wav2vec.*`` / ``wav2vec2.*`` backbone, ``attention.*``,
        ``fc.*``) or the JAX trainer's ``.msgpack``.  The backbone config
        comes from ``wav2vec_config``, else the ``wav2vec_config`` of the
        ``.json`` beside the checkpoint, else the weights' shapes
        (``infer_wav2vec_config``).  ``compute_dtype`` fp32 by default, as
        the JAX predictor builds its model.  ``mesh``: the serving mesh."""
        import json

        from speech_intent_recognizer_tpu_torch.convert.checkpoint import (
            load_model_checkpoint)
        from speech_intent_recognizer_tpu_torch.convert.wav2vec_import import (
            infer_wav2vec_config)
        from speech_intent_recognizer_tpu_torch.data.labelmap import (
            load_label_map)
        from speech_intent_recognizer_tpu_torch.models.wav2vec import (
            Wav2Vec2Config, Wav2VecIntent)

        label_map = load_label_map(label_map_path)
        state = load_model_checkpoint(model_path)
        if num_classes is None:
            num_classes = int(state["fc.weight"].shape[0])
        if wav2vec_config is None:
            meta_path = os.path.splitext(model_path)[0] + ".json"
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
                if "wav2vec_config" in meta:
                    wav2vec_config = Wav2Vec2Config.from_dict(
                        meta["wav2vec_config"])
        if wav2vec_config is None:
            wav2vec_config = infer_wav2vec_config(
                {k[len("wav2vec."):]: v for k, v in state.items()
                 if k.startswith("wav2vec.")})
        model = Wav2VecIntent(wav2vec_config, num_classes, compute_dtype)
        model.load_state_dict(state)
        return cls(model, label_map, audio_cfg, device, mesh)

    def _fused_body(self) -> Wav2VecServingBody:
        return self._body

    def _buffer_width(self) -> int:
        return self.audio_cfg.max_samples  # raw-waveform model: no framing
