"""Synthetic test-set generation (TTS).

Copy of ``speech_intent_recognizer_tpu/tts/generate.py`` (the reference's
gTTS generator ``scripts/generate_tts_samples.py:19-69``: one WAV per
transcription named ``{i:03d}_{sanitized_text}.wav`` plus a ``details.csv``
of (filename, text, class), and its offline pyttsx3 variant
``scripts/utils/tts.py``).  The port keeps its own copy, written through
its own ``data/audio_io.save_wav``; ``tests/test_torch_tts.py`` holds the
WAVs and ``details.csv`` byte-equal to the original's.

Engines, tried in order unless pinned:

* ``gtts``   — Google TTS (network; optional dependency)
* ``pyttsx3`` — offline host TTS (optional dependency)
* ``synthetic`` — built-in deterministic fallback: a formant-style tone
  sequence derived from the text's SHA-256.  Not intelligible speech, but
  stable, distinct per text and decodable by the normal pipeline, so the
  TTS-holdout flow runs without a network.

``gtts`` and ``pyttsx3`` are imported inside their engines only: offline,
or where they are not installed, the engine fails and the next is tried.
"""

from __future__ import annotations

import csv
import hashlib
import logging
import os
import re
import time
from typing import Iterable, Optional

import numpy as np

from speech_intent_recognizer_tpu_torch.data.audio_io import save_wav

logger = logging.getLogger(__name__)


def _read_sentence_sheet(csv_path: str) -> list:
    """Parse a sentence sheet (reference schema: transcription, action,
    object, location, label) -> [(text, class_label), ...]."""
    rows = []
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            cols = {k.lower().strip(): v for k, v in row.items() if k}
            text = (cols.get("transcription") or cols.get("text")
                    or cols.get("sentence") or "")
            label = cols.get("label") or cols.get("class") or ""
            if not label and "action" in cols and "object" in cols:
                label = f"{cols['action']}_{cols['object']}"
            if text:
                rows.append((text.strip(), label.strip()))
    if not rows:
        raise ValueError(f"no transcriptions found in {csv_path}")
    return rows


def sanitize_filename(text: str, max_len: int = 50) -> str:
    """Reference naming semantics (``generate_tts_samples.py:10-16``)."""
    out = re.sub(r"[^\w\s-]", "", text).strip()
    out = re.sub(r"[\s]+", " ", out)
    return out[:max_len]


def _synthesize_gtts(text: str, path: str, accent: str = "en",
                     slow: bool = False) -> None:
    from gtts import gTTS  # type: ignore

    tld_map = {"en": "com", "en-us": "us", "en-uk": "co.uk", "en-au": "com.au"}
    tts = gTTS(text=text, lang="en", tld=tld_map.get(accent, "com"), slow=slow)
    tts.save(path)


def _synthesize_pyttsx3(text: str, path: str, rate: int = 150) -> None:
    import pyttsx3  # type: ignore

    engine = pyttsx3.init()
    engine.setProperty("rate", rate)
    engine.save_to_file(text, path)
    engine.runAndWait()


def _synthesize_synthetic(text: str, path: str,
                          sample_rate: int = 16000) -> None:
    """Deterministic per-text tone sequence (hermetic fallback)."""
    digest = hashlib.sha256(text.encode()).digest()
    words = max(len(text.split()), 1)
    dur_per = 0.22
    total = int(sample_rate * (0.2 + dur_per * words))
    t = np.arange(total) / sample_rate
    x = np.zeros(total, np.float64)
    for w in range(words):
        f0 = 120.0 + (digest[w % 32] / 255.0) * 160.0
        f1 = 500.0 + (digest[(w + 7) % 32] / 255.0) * 1800.0
        start = int(sample_rate * (0.1 + dur_per * w))
        end = min(start + int(sample_rate * dur_per * 0.85), total)
        seg_t = t[start:end] - t[start]
        env = np.sin(np.pi * seg_t / max(seg_t[-1], 1e-3)) ** 2
        x[start:end] += env * (0.35 * np.sin(2 * np.pi * f0 * seg_t)
                               + 0.18 * np.sin(2 * np.pi * f1 * seg_t)
                               + 0.05 * np.sin(2 * np.pi * 2 * f1 * seg_t))
    x += 0.002 * np.random.default_rng(digest[0]).standard_normal(total)
    save_wav(path, (x / max(np.abs(x).max(), 1e-6) * 0.7).astype(np.float32),
             sample_rate)


def synthesize_text(text: str, path: str, engine: str = "auto",
                    accent: str = "en", slow: bool = False) -> str:
    """Render one utterance; returns the engine actually used."""
    engines = ([engine] if engine != "auto"
               else ["gtts", "pyttsx3", "synthetic"])
    last_err: Optional[Exception] = None
    for name in engines:
        try:
            if name == "gtts":
                _synthesize_gtts(text, path, accent, slow)
            elif name == "pyttsx3":
                _synthesize_pyttsx3(text, path)
            elif name == "synthetic":
                _synthesize_synthetic(text, path)
            else:
                raise ValueError(f"unknown engine {name!r}")
            return name
        except Exception as e:  # engine unavailable; try next
            last_err = e
    raise RuntimeError(f"all TTS engines failed: {last_err}")


def generate_audio_files(
    csv_path: str,
    output_dir: str,
    engine: str = "auto",
    accent: str = "en",
    slow: bool = False,
    rate_limit_s: float = 0.2,
    texts_and_classes: Optional[Iterable[tuple]] = None,
) -> str:
    """Generate a synthetic corpus + details.csv from a sentence manifest.

    ``csv_path`` uses the reference's sentence-sheet schema
    (transcription, action, object, location, label — see
    ``configs/custom_intents_sentences.csv``).  Returns the path of
    ``details.csv``.
    """
    os.makedirs(output_dir, exist_ok=True)
    if texts_and_classes is None:
        rows = _read_sentence_sheet(csv_path)
    else:
        rows = list(texts_and_classes)

    details_path = os.path.join(output_dir, "details.csv")
    used_engine = None
    with open(details_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "text", "class"])
        for i, (text, label) in enumerate(rows, start=1):
            fname = f"{i:03d}_{sanitize_filename(text)}.wav"
            out_path = os.path.join(output_dir, fname)
            used_engine = synthesize_text(text, out_path, engine, accent, slow)
            w.writerow([fname, text, label])
            if used_engine == "gtts" and rate_limit_s:
                time.sleep(rate_limit_s)
    logger.info("generated %d samples (%s engine) in %s",
                len(rows), used_engine, output_dir)
    return details_path
