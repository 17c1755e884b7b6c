"""Serving artifacts: the batch path and the streaming finalize as traced
programs (``torch.export``), beside their weights.

Counterpart of ``speech_intent_recognizer_tpu/infer/export.py``.  A
serving host loads an artifact with :class:`ServingModel` (or
:class:`StreamingArtifactPredictor`) and needs ``torch`` and, where a
program holds the kernels, this package's op library
(``ops/library.py``): nothing of ``models/``, ``infer/predict``,
``train/`` or ``data/``.

Artifact layout (a directory):

    program.pt2         portable: a torch.export program, symbolic batch "b"
    program_b{N}.pt2    production: one program per pinned batch N
    variables.pt        the weights (a torch.save state dict)
    label_map.json      intent label mapping
    manifest.json       audio geometry, flavour, kernel ops, export metadata

The programs read their weights from ``variables.pt`` at load time, so a
fine-tuned checkpoint dropped into an existing artifact is served without
re-exporting.  Geometry constants (window, twiddles, filterbank) stay in
the programs.

Two flavours:

* ``portable`` (default): the unfused model behind the plain front-end,
  traced on the CPU, where every kernel wrapper runs its plain version: a
  graph of PyTorch's own ops with a symbolic batch, which the loader moves
  to the caller's device (``move_to_device_pass``).  No hand-written
  kernel runs in it.
* ``production``: the predictor's live batch path
  (``Predictor._fused_body``) traced on the card, where each kernel is one
  ``sir`` op node; one program per ``batch_sizes`` entry, each taking the
  flat buffer's (B, L / hop, hop) rows (``rows_input``).
  :class:`ServingModel` sends a request to the smallest program that
  holds it (rows of length 1 fill the rest) and cuts larger requests
  into chunks.

A ``Wav2VecPredictor`` exports the same two flavours (the JAX package's
wav2vec branch): ``portable`` is ``Wav2VecIntent`` in fp32 behind the
padding mask, traced on the CPU with a symbolic batch; ``production`` its
``Wav2VecServingBody`` in the predictor's compute dtype, traced on the card
per pinned batch and fed (B, L) waveforms.  Neither holds a ``sir`` node:
the wav2vec path runs PyTorch's own convolutions, GEMMs and norms.

Loading checks the manifest's ``format``: this package writes
``sir_tpu_torch.serving_export.v1`` and ``sir_tpu_torch.streaming_export.v1``,
so neither package's loader takes the other's artifact.
"""

from __future__ import annotations

import copy
import json
import os
from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch

FORMAT = "sir_tpu_torch.serving_export.v1"
STREAM_FORMAT = "sir_tpu_torch.streaming_export.v1"
_PROGRAM = "program.pt2"
_VARIABLES = "variables.pt"
_LABELS = "label_map.json"
_MANIFEST = "manifest.json"
_STREAM_PROGRAM = "stream_finalize.pt2"
_STREAM_CLASSIFY = "stream_classify.pt2"
_AUDIO_KEYS = ("sample_rate", "n_fft", "hop_length", "win_length", "n_mels",
               "f_min", "f_max", "mel_spec_length", "max_samples", "frontend",
               "norm_eps")


def kernel_ops(program) -> Dict[str, int]:
    """How many nodes of each ``sir`` op (a kernel) a program's graph
    holds: ``{"sir.gru_layer_btc": 2, ...}``.  ``program``: an
    ``ExportedProgram`` or a ``torch.fx.GraphModule``."""
    found = Counter(str(node.target).rsplit(".", 1)[0]  # "sir.<op>.default"
                    for node in program.graph.nodes
                    if node.op == "call_function"
                    and getattr(node.target, "namespace", None) == "sir")
    return dict(sorted(found.items()))


def _trace(module: torch.nn.Module, args: tuple,
           dynamic_shapes=None) -> "torch.export.ExportedProgram":
    with torch.no_grad():
        return torch.export.export(module.eval(), args,
                                   dynamic_shapes=dynamic_shapes,
                                   strict=False)


def trace_production(body: torch.nn.Module, batch: int, rows: tuple,
                     device) -> "torch.export.ExportedProgram":
    """A production program: ``body`` traced at ``batch`` rows of shape
    ``rows`` (the (L / hop, hop) buffer, or (L,) for the wav2vec model) on
    ``device``, whose wrappers there call the kernels' ops.  Traces on fake
    tensors and launches nothing."""
    wf = torch.zeros((batch,) + tuple(rows), device=device)
    ln = torch.ones((batch,), dtype=torch.int32, device=device)
    return _trace(body, (wf, ln))


def _audio_manifest(cfg) -> dict:
    return {k: getattr(cfg, k) for k in _AUDIO_KEYS}


def _audio_config(manifest: dict):
    from speech_intent_recognizer_tpu_torch.config import AudioConfig

    a = dict(manifest["audio"])
    max_samples = a.pop("max_samples")
    return AudioConfig(max_duration=max_samples / a["sample_rate"], **a)


def _write(out_dir: str, variables: dict, label_map: dict,
           manifest: dict) -> None:
    torch.save({k: v.detach().cpu() for k, v in variables.items()},
               os.path.join(out_dir, _VARIABLES))
    with open(os.path.join(out_dir, _LABELS), "w") as f:
        json.dump(label_map, f, indent=2)
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)


def _plats(platforms, ops: dict) -> list:
    """A program that holds kernel ops runs where they launch; one of
    PyTorch's own ops anywhere."""
    return list(platforms) if platforms else (
        ["cuda"] if ops else ["cpu", "cuda"])


def export_predictor(predictor, out_dir: str,
                     platforms: Optional[list] = None,
                     flavor: str = "portable",
                     batch_sizes: tuple = (8, 256, 2048)) -> str:
    """Export a :class:`.predict.Predictor`'s batch path to ``out_dir``.

    ``flavor="portable"``: the unfused model (``predictor.model``) behind
    the plain front-end, traced on the CPU with a symbolic batch.
    ``flavor="production"``: ``predictor._fused_body()``, the path
    ``predict_waveform_batch`` runs in the predictor's configuration,
    traced on the predictor's CUDA device once per ``batch_sizes`` entry.
    ``platforms``: the torch device types the manifest names (default:
    ``cuda`` for a program that holds kernel ops, else ``cpu`` and
    ``cuda``).  Returns ``out_dir``.
    """
    from torch.export import Dim

    from speech_intent_recognizer_tpu_torch.infer.predict import (
        ServingBody, Wav2VecPredictor, Wav2VecServingBody)
    from speech_intent_recognizer_tpu_torch.ops.frontend import (
        make_frontend_params)

    os.makedirs(out_dir, exist_ok=True)
    cfg = predictor.audio_cfg
    width = predictor._buffer_width()
    wav2vec = isinstance(predictor, Wav2VecPredictor)
    if flavor == "production":
        if predictor.device.type != "cuda":
            raise ValueError("the production flavour traces the kernels' "
                             "ops on the card: give a predictor on a CUDA "
                             "device")
        body = predictor._fused_body()
        hop = cfg.hop_length
        rows = (width,) if wav2vec else (width // hop, hop)
        programs, ops = {}, {}
        for bs in sorted(set(int(b) for b in batch_sizes)):
            ep = trace_production(body, bs, rows, predictor.device)
            name = f"program_b{bs}.pt2"
            torch.export.save(ep, os.path.join(out_dir, name))
            programs[str(bs)] = name
            ops = kernel_ops(ep)
        extra = {"flavor": "production", "programs": programs}
        if not wav2vec:
            extra["rows_input"] = list(rows)
    elif flavor == "portable":
        if wav2vec:
            from speech_intent_recognizer_tpu_torch.models.wav2vec import (
                Wav2VecIntent)

            m = predictor.model
            model = Wav2VecIntent(m.config, m.num_classes)  # fp32
            model.load_state_dict(m.state_dict())
            body = Wav2VecServingBody(model)
        else:
            model = copy.deepcopy(predictor.model).cpu()
            body = ServingBody(make_frontend_params(cfg, "cpu"), model)
        b = Dim("b", min=1)
        example = (torch.zeros((3, width)),
                   torch.full((3,), width // 2, dtype=torch.int32))
        ep = _trace(body, example, {"waveforms": {0: b}, "lengths": {0: b}})
        torch.export.save(ep, os.path.join(out_dir, _PROGRAM))
        ops = kernel_ops(ep)
        extra = {"flavor": "portable"}
    else:
        raise ValueError(f"unknown flavor {flavor!r}")

    _write(out_dir, body.state_dict(), predictor.label_map, {
        "format": FORMAT,
        "model": type(predictor.model).__name__,
        "platforms": _plats(platforms, ops),
        "buffer_width": width,
        "num_classes": int(len(predictor.inv_label_map)),
        "audio": _audio_manifest(cfg),
        "ops": ops,
        **extra,
    })
    return out_dir


def export_streaming(predictor, out_dir: str,
                     platforms: Optional[list] = None) -> str:
    """Export the streaming end of utterance as an artifact.

    Traces the one-call finalize of one utterance
    (:class:`.streaming.StreamFinalize`: the (target_length, n_mels) rows
    emitted so far, their count, the (4, n_fft) tail frames and how many
    are valid) and the partial hypothesis's classifier
    (:class:`.streaming.StreamClassify`) on the predictor's device: on the
    card K4 and the fp32 K2 are op nodes, on the CPU their plain versions.
    :class:`StreamingArtifactPredictor` serves them to a
    :class:`.streaming.StreamingRecognizer`.  Returns ``out_dir``.
    """
    from speech_intent_recognizer_tpu_torch.infer.streaming import (
        StreamClassify, StreamFinalize, StreamingRecognizer)

    os.makedirs(out_dir, exist_ok=True)
    cfg = predictor.audio_cfg
    p = predictor.frontend_params
    dev = predictor.device
    tail_max = StreamingRecognizer._TAIL_MAX
    finalize = _trace(StreamFinalize(predictor.model, p), (
        torch.zeros((p.target_length, p.n_mels), device=dev),
        torch.zeros((), dtype=torch.int64, device=dev),
        torch.zeros((tail_max, p.n_fft), device=dev),
        torch.zeros((), dtype=torch.int64, device=dev)))
    classify = _trace(StreamClassify(predictor.model), (
        torch.zeros((p.n_mels, p.target_length), device=dev),))
    torch.export.save(finalize, os.path.join(out_dir, _STREAM_PROGRAM))
    torch.export.save(classify, os.path.join(out_dir, _STREAM_CLASSIFY))
    ops = kernel_ops(finalize)
    _write(out_dir, {f"model.{k}": v
                     for k, v in predictor.model.state_dict().items()},
           predictor.label_map, {
               "format": STREAM_FORMAT,
               "model": type(predictor.model).__name__,
               "platforms": _plats(platforms, ops),
               "tail_max": tail_max,
               "num_classes": int(len(predictor.inv_label_map)),
               "audio": _audio_manifest(cfg),
               "ops": ops,
               "classify_ops": kernel_ops(classify),
           })
    return out_dir


def _read(artifact_dir: str, fmt: str) -> tuple:
    with open(os.path.join(artifact_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != fmt:
        raise ValueError(f"unrecognized artifact format in {artifact_dir}: "
                         f"{manifest.get('format')!r} (want {fmt!r})")
    with open(os.path.join(artifact_dir, _LABELS)) as f:
        label_map = json.load(f)
    variables = torch.load(os.path.join(artifact_dir, _VARIABLES),
                           map_location="cpu", weights_only=True)
    if manifest.get("ops") or manifest.get("classify_ops"):
        from speech_intent_recognizer_tpu_torch.ops import library

        library.load()  # the kernels' ops, before a program names them
    return manifest, label_map, variables


def _program(path: str, variables: dict, device) -> torch.nn.Module:
    """A saved program on ``device`` with ``variables`` as its weights."""
    from torch.export.passes import move_to_device_pass

    ep = move_to_device_pass(torch.export.load(path), torch.device(device))
    module = ep.module()
    module.load_state_dict(variables)
    return module


class StreamingArtifactPredictor:
    """Predictor stand-in backed by an exported streaming artifact.

    Has what :class:`.streaming.StreamingRecognizer` reads from a live
    ``Predictor`` (``audio_cfg``, ``frontend_params``, ``device``,
    ``label_map``, ``inv_label_map``) and brings its finalize and
    classifier programs (``_stream_calls``), so

        rec = StreamingRecognizer(StreamingArtifactPredictor.load(d))

    serves streams from the artifact alone, without the model's code.
    """

    def __init__(self, finalize_call, classify_call,
                 label_map: Dict[str, int], manifest: Dict,
                 device: "str | torch.device" = "cuda"):
        from speech_intent_recognizer_tpu_torch.ops.frontend import (
            make_frontend_params)

        self.device = torch.device(device)
        self.label_map = label_map
        self.inv_label_map = {v: k for k, v in label_map.items()}
        self.manifest = manifest
        self.audio_cfg = _audio_config(manifest)
        self.frontend_params = make_frontend_params(self.audio_cfg,
                                                    self.device)
        self._stream_calls = {"fused_finalize": finalize_call,
                              "classify": classify_call}

    @classmethod
    def load(cls, artifact_dir: str, device: "str | torch.device" = "cuda"
             ) -> "StreamingArtifactPredictor":
        manifest, label_map, variables = _read(artifact_dir, STREAM_FORMAT)
        finalize = _program(os.path.join(artifact_dir, _STREAM_PROGRAM),
                            variables, device)
        classify = _program(os.path.join(artifact_dir, _STREAM_CLASSIFY),
                            variables, device)
        return cls(finalize, classify, label_map, manifest, device)


class ServingModel:
    """Run an exported artifact: waveforms in, probabilities out.

    ``programs`` is one callable ``(waveforms, lengths) -> probabilities``
    taking any batch (portable), or ``{batch: callable}`` of pinned batches
    (production).  :meth:`load` builds them from an artifact directory.
    """

    def __init__(self, programs, label_map: Dict[str, int], manifest: Dict,
                 device: "str | torch.device" = "cuda"):
        self.device = torch.device(device)
        if isinstance(programs, dict):
            self._calls = dict(sorted(programs.items()))
            self._call = None
        else:
            self._calls, self._call = None, programs
        self.label_map = label_map
        self.inv_label_map = {v: k for k, v in label_map.items()}
        self.manifest = manifest
        self.buffer_width = int(manifest["buffer_width"])

    @classmethod
    def load(cls, artifact_dir: str, device: "str | torch.device" = "cuda"
             ) -> "ServingModel":
        """The artifact in ``artifact_dir`` on ``device`` (``cuda`` unless
        the caller asks for the CPU)."""
        manifest, label_map, variables = _read(artifact_dir, FORMAT)
        if manifest.get("flavor") == "production":
            programs = {int(bs): _program(os.path.join(artifact_dir, name),
                                          variables, device)
                        for bs, name in manifest["programs"].items()}
        else:
            programs = _program(os.path.join(artifact_dir, _PROGRAM),
                                variables, device)
        return cls(programs, label_map, manifest, device)

    def predict_waveform_batch(self, waveforms, lengths) -> np.ndarray:
        """(B, L <= buffer_width) float32 + (B,) lengths -> (B, C)
        probabilities.

        ``waveforms`` is a NumPy array or a tensor (one already on the
        model's device is used in place); rows shorter than the exported
        width are zero-padded.  A production artifact runs each chunk of at
        most its largest batch through the smallest program that holds
        it, filling the rest with rows of length 1, and takes the flat
        buffer's (B, L / hop, hop) rows (``rows_input``, a view)."""
        with torch.inference_mode():
            wf = torch.as_tensor(waveforms).to(self.device, torch.float32)
            ln = torch.as_tensor(lengths).to(self.device, torch.int32)
            pad = self.buffer_width - wf.shape[1]
            if pad < 0:
                raise ValueError(f"waveform buffer {wf.shape[1]} exceeds the "
                                 f"exported width {self.buffer_width}")
            if pad:
                wf = torch.nn.functional.pad(wf, (0, pad))
            wf, ln = wf.contiguous(), ln.contiguous()
            if self._calls is None:
                return self._call(wf, ln).cpu().numpy()
            rows = self.manifest.get("rows_input")
            if rows:
                wf = wf.view(wf.shape[0], *rows)
            sizes = list(self._calls)
            outs = []
            for s in range(0, wf.shape[0], sizes[-1]):
                cw, cl = wf[s:s + sizes[-1]], ln[s:s + sizes[-1]]
                n = cw.shape[0]
                bs = next(sz for sz in sizes if sz >= n)
                if n < bs:
                    cw = torch.cat([cw, cw.new_zeros((bs - n,) + cw.shape[1:])])
                    cl = torch.cat([cl, cl.new_ones(bs - n)])
                outs.append(self._calls[bs](cw, cl)[:n])
            return torch.cat(outs).cpu().numpy()
