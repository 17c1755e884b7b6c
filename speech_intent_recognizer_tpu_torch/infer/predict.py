"""Offline inference: batch waveforms, single file, array, directory.

Counterpart of ``speech_intent_recognizer_tpu/infer/predict.py``
(``Predictor``).  ``from_checkpoint`` folds BatchNorm and, for the reference
geometry, serves the ``conv1_external`` bf16 variant behind the fused
front-end + conv1 kernel: on a CUDA device ``predict_waveform_batch`` always
launches K1 once and K2 once per GRU layer.  There is no probe and no switch
to another path at run time; CPU devices run the kernels' plain versions.
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Dict, List, Optional

import numpy as np
import torch

from speech_intent_recognizer_tpu_torch.config.schema import AudioConfig
from speech_intent_recognizer_tpu_torch.data.audio_io import load_audio
from speech_intent_recognizer_tpu_torch.evaluation.metrics import (
    top_k_predictions)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    log_mel_conv1_frontend, log_mel_frontend, make_frontend_params,
    padded_samples)

logger = logging.getLogger(__name__)

_AUDIO_EXTS = (".wav", ".mp3", ".flac")


class Predictor:
    """End-to-end (waveform -> intent) predictor on one device."""

    def __init__(self, model: CNNAudioGRU, label_map: Dict[str, int],
                 audio_cfg: Optional[AudioConfig] = None,
                 device: "str | torch.device" = "cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.label_map = label_map
        self.inv_label_map = {v: k for k, v in label_map.items()}
        self.audio_cfg = audio_cfg or AudioConfig()
        self.frontend_params = make_frontend_params(self.audio_cfg,
                                                    self.device)
        # (variant model, conv1 weight, conv1 bias) when the fused
        # front-end + conv1 path serves batch waveform inference
        self._conv1 = None

    @classmethod
    def from_checkpoint(cls, model_path: str, label_map_path: str,
                        audio_cfg: Optional[AudioConfig] = None,
                        num_classes: Optional[int] = None,
                        fold_bn: bool = True,
                        device: "str | torch.device" = "cuda") -> "Predictor":
        from speech_intent_recognizer_tpu_torch.convert.checkpoint import (
            load_model_checkpoint)
        from speech_intent_recognizer_tpu_torch.data.labelmap import (
            load_label_map)
        from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
            fold_batchnorm)

        label_map = load_label_map(label_map_path)
        state = load_model_checkpoint(model_path)
        if num_classes is None:  # the classifier head's output width
            num_classes = int(state["fc.weight"].shape[0])
        if fold_bn and any(k.startswith("bn") for k in state):
            folded = fold_batchnorm(state)
            model = CNNAudioGRU(num_classes=num_classes, fold_bn=True)
            model.load_state_dict(folded)
            pred = cls(model, label_map, audio_cfg, device)
            pred._maybe_enable_conv1_fusion(folded)
            return pred
        model = CNNAudioGRU(num_classes=num_classes)
        model.load_state_dict(state)
        return cls(model, label_map, audio_cfg, device)

    def _maybe_enable_conv1_fusion(self, folded: Dict[str, torch.Tensor]
                                   ) -> None:
        """Serve the fused front-end + conv1 path when the audio geometry
        and conv1 match the K1 kernel's contract (n_fft=1024, hop=512,
        64 mels, 200 frames, 32 conv1 channels)."""
        from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
            conv1_external_params)

        cfg = self.audio_cfg
        w = folded.get("conv1.weight")
        if not (cfg.n_fft == 1024 and cfg.hop_length == 512
                and cfg.n_mels == 64
                and cfg.mel_spec_length == 200 and w is not None
                and tuple(w.shape) == (32, 1, 3, 3)
                and "conv1.bias" in folded):
            return
        var_state, c1w, c1b = conv1_external_params(folded)
        variant = CNNAudioGRU(num_classes=self.model.num_classes,
                              compute_dtype=torch.bfloat16, fold_bn=True,
                              conv1_external=True)
        variant.load_state_dict(var_state)
        self._conv1 = (variant.to(self.device).eval(),
                       c1w.to(self.device, torch.bfloat16).contiguous(),
                       c1b.to(self.device, torch.bfloat16).contiguous())

    def _probabilities(self, wf: torch.Tensor, ln: torch.Tensor
                       ) -> torch.Tensor:
        fe = self.frontend_params
        if self._conv1 is not None:
            variant, c1w, c1b = self._conv1
            logits = variant(log_mel_conv1_frontend(wf, ln, fe, c1w, c1b))
        else:
            logits = self.model(log_mel_frontend(wf, ln, fe))
        return torch.softmax(logits.float(), dim=-1)

    def predict_waveform_batch(self, waveforms, lengths) -> np.ndarray:
        """(B, L) float32 + (B,) lengths -> (B, C) probabilities.

        ``waveforms`` is a NumPy array or a tensor (one already on the
        predictor's device is used in place); each row is zero-padded past
        its true length, and lengths stay below L."""
        with torch.inference_mode():
            wf = torch.as_tensor(waveforms).to(self.device, torch.float32)
            ln = torch.as_tensor(lengths).to(self.device, torch.int32)
            probs = self._probabilities(wf.contiguous(), ln.contiguous())
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
        except (OSError, RuntimeError, struct.error) as e:  # unreadable
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
