"""Host-side audio sources for the live demo.

Counterpart of ``speech_intent_recognizer_tpu/infer/mic.py``.  The
reference captures audio with PyAudio (``scripts/testing.py:33,52-58``).
Capture stays on the host here too, behind a small source abstraction:

* :class:`MicrophoneSource`: real capture via sounddevice or pyaudio,
  whichever imports (both optional, imported only when a source is made);
* :class:`FileAudioSource`: replays a WAV/MP3 file in mic-sized chunks at
  the model rate, so the whole streaming stack (VAD -> incremental
  features -> classifier) runs without audio hardware;
* :func:`run_live`: the capture loop: chunks into a
  :class:`~speech_intent_recognizer_tpu_torch.infer.streaming.StreamingRecognizer`,
  results printed, utterance WAVs optionally saved like the reference's
  ``mic_recordings/`` flow.
"""

from __future__ import annotations

import logging
import os
import time
from datetime import datetime
from typing import Callable, Iterator, Optional

import numpy as np

from speech_intent_recognizer_tpu_torch.data.audio_io import (
    load_audio, save_wav)

logger = logging.getLogger(__name__)


class FileAudioSource:
    """Replay an audio file as a stream of fixed-size chunks."""

    def __init__(self, path: str, sample_rate: int = 16000,
                 chunk_size: int = 1024, realtime: bool = False,
                 trailing_silence: float = 1.5):
        self.sample_rate = sample_rate
        self.chunk_size = chunk_size
        self.realtime = realtime
        x, _ = load_audio(path, target_sample_rate=sample_rate)
        pad = int(trailing_silence * sample_rate)
        self._samples = np.concatenate([x, np.zeros(pad, np.float32)])

    def chunks(self) -> Iterator[np.ndarray]:
        n = len(self._samples)
        for start in range(0, n, self.chunk_size):
            chunk = self._samples[start : start + self.chunk_size]
            if len(chunk) < self.chunk_size:
                chunk = np.pad(chunk, (0, self.chunk_size - len(chunk)))
            if self.realtime:
                time.sleep(self.chunk_size / self.sample_rate)
            yield chunk


class MicrophoneSource:
    """Real microphone capture (sounddevice preferred, pyaudio fallback)."""

    def __init__(self, sample_rate: int = 16000, chunk_size: int = 1024):
        self.sample_rate = sample_rate
        self.chunk_size = chunk_size
        self._backend = None
        try:
            import sounddevice  # type: ignore

            self._backend = ("sounddevice", sounddevice)
        except ImportError:
            try:
                import pyaudio  # type: ignore

                self._backend = ("pyaudio", pyaudio)
            except ImportError:
                pass
        if self._backend is None:
            raise RuntimeError(
                "no microphone backend available (install sounddevice or "
                "pyaudio); use FileAudioSource / --audio replay instead")

    def chunks(self) -> Iterator[np.ndarray]:
        name, mod = self._backend
        if name == "sounddevice":
            with mod.InputStream(samplerate=self.sample_rate, channels=1,
                                 dtype="float32",
                                 blocksize=self.chunk_size) as stream:
                while True:
                    data, _overflow = stream.read(self.chunk_size)
                    yield data.reshape(-1).astype(np.float32)
        else:  # pyaudio
            pa = mod.PyAudio()
            stream = pa.open(format=mod.paInt16, channels=1,
                             rate=self.sample_rate, input=True,
                             frames_per_buffer=self.chunk_size)
            try:
                while True:
                    raw = stream.read(self.chunk_size,
                                      exception_on_overflow=False)
                    yield (np.frombuffer(raw, np.int16).astype(np.float32)
                           / 32768.0)
            finally:
                stream.stop_stream()
                stream.close()
                pa.terminate()


def run_live(
    recognizer,
    source,
    on_result: Optional[Callable[[dict], None]] = None,
    save_dir: Optional[str] = None,
    max_utterances: Optional[int] = None,
) -> list:
    """Drive a streaming recognizer from an audio source."""
    results = []
    pending: list[np.ndarray] = []
    try:
        for chunk in source.chunks():
            pending.append(chunk)
            result = recognizer.feed(chunk)
            if result is not None:
                if save_dir:
                    os.makedirs(save_dir, exist_ok=True)
                    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
                    save_wav(os.path.join(save_dir,
                                          f"recording_{stamp}.wav"),
                             np.concatenate(pending),
                             recognizer.audio_cfg.sample_rate)
                pending = []
                results.append(result)
                if on_result:
                    on_result(result)
                if max_utterances and len(results) >= max_utterances:
                    break
    except KeyboardInterrupt:  # pragma: no cover
        logger.info("stopping listener")
    tail = recognizer.flush()
    if tail is not None:
        results.append(tail)
        if on_result:
            on_result(tail)
    return results


def print_result(result: dict) -> None:
    """Console rendering in the reference's format
    (``testing.py:272-281``)."""
    print("\n=== INTENT RECOGNITION RESULTS ===")
    print(f"Predicted Intent: {result['predicted_label']}")
    print(f"Confidence: {result['confidence'] * 100:.2f}%")
    print("\nTop Predictions:")
    for i, p in enumerate(result["top_predictions"]):
        print(f"  {i + 1}. {p['label']} ({p['probability'] * 100:.2f}%)")
    print("=" * 35)
