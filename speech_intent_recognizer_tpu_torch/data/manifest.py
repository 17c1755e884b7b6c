"""CSV manifest reading with the reference's column-normalization rules.

Copy of ``speech_intent_recognizer_tpu/data/manifest.py`` (pure Python,
``csv`` and ``os``); ``tests/test_torch_precompute.py`` pins it to the
original.

Reference semantics (``scripts/preprocess_fsc.py:83-114`` and
``scripts/utils/path_utils.py:11-33``):

* the audio path column may be named ``path``/``file_path``/``audio_path``/
  ``filepath``/``audio_file``/``wav_path``/``wav_file``;
* the label is ``label``, or ``intent``/``class`` renamed, or synthesized as
  ``action + '_' + object``;
* relative audio paths are resolved against a list of candidate roots
  including the FSC dataset layout.

Uses the stdlib csv module — no pandas dependency in the core data path.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_PATH_ALIASES = ("path", "file_path", "audio_path", "filepath", "audio_file",
                 "wav_path", "wav_file", "filename")
_LABEL_ALIASES = ("label", "intent", "class")


@dataclass
class Manifest:
    """A validated list of (audio path, label) rows plus passthrough columns."""

    paths: List[str] = field(default_factory=list)
    labels: List[str] = field(default_factory=list)
    extras: Dict[str, List[str]] = field(default_factory=dict)
    source: str = ""

    def __len__(self) -> int:
        return len(self.paths)

    def subset(self, indices) -> "Manifest":
        return Manifest(
            paths=[self.paths[i] for i in indices],
            labels=[self.labels[i] for i in indices],
            extras={k: [v[i] for i in indices] for k, v in self.extras.items()},
            source=self.source,
        )

    def write_csv(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        cols = ["path", "label"] + sorted(self.extras)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            for i in range(len(self.paths)):
                row = [self.paths[i], self.labels[i]]
                row += [self.extras[c][i] for c in sorted(self.extras)]
                w.writerow(row)


def normalize_audio_path(path: str, base_path: str) -> str:
    """Resolve a manifest path against candidate roots (reference
    ``path_utils.py:11-33`` semantics, including the FSC dataset layouts)."""
    if os.path.isabs(path):
        return path
    candidates = [
        path,
        os.path.join(base_path, path),
        os.path.join(base_path, "data", "FSC",
                     "fluent_speech_commands_dataset", path),
        os.path.join(base_path, "data", "FSC",
                     "fluent_speech_commands_dataset", "wavs", path),
    ]
    for c in candidates:
        if os.path.exists(c):
            return c
    return path


def read_manifest(
    csv_path: str,
    base_path: Optional[str] = None,
    resolve_paths: bool = True,
) -> Manifest:
    """Read a manifest CSV, normalizing column names per the reference rules."""
    if not os.path.exists(csv_path):
        raise FileNotFoundError(f"manifest not found: {csv_path}")
    with open(csv_path, "r", newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        fieldnames = [c.strip() for c in (reader.fieldnames or [])]
    if not rows:
        raise ValueError(f"empty manifest: {csv_path}")

    cols = {c.lower(): c for c in fieldnames}
    path_col = next((cols[a] for a in _PATH_ALIASES if a in cols), None)
    if path_col is None:
        raise ValueError(
            f"{csv_path}: no audio path column (looked for {_PATH_ALIASES})")

    label_col = next((cols[a] for a in _LABEL_ALIASES if a in cols), None)
    synthesize = label_col is None and "action" in cols and "object" in cols

    base = base_path or os.getcwd()
    m = Manifest(source=csv_path)
    extra_cols = [c for c in fieldnames
                  if c not in (path_col, label_col) and c]
    for c in extra_cols:
        m.extras[c] = []
    for row in rows:
        p = (row.get(path_col) or "").strip()
        if not p:
            continue
        if resolve_paths:
            p = normalize_audio_path(p, base)
        if synthesize:
            label = f"{row.get(cols['action'], '')}_{row.get(cols['object'], '')}"
        elif label_col is not None:
            label = str(row.get(label_col, ""))
        else:
            label = "unknown"
        m.paths.append(p)
        m.labels.append(label)
        for c in extra_cols:
            m.extras[c].append(str(row.get(c, "")))
    return m
