"""Label map creation and persistence.

Reference semantics (``scripts/preprocess_fsc.py:133-148``): labels are the
sorted unique values of the ``label`` column (synthesized as
``action + '_' + object`` when absent), mapped to contiguous ids, stored as
JSON ``{label: id}``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable


def create_label_map(labels: Iterable[str]) -> Dict[str, int]:
    unique = sorted({str(l) for l in labels})
    return {label: idx for idx, label in enumerate(unique)}


def save_label_map(label_map: Dict[str, int], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(label_map, f, indent=2)


def load_label_map(path: str) -> Dict[str, int]:
    with open(path, "r") as f:
        return {str(k): int(v) for k, v in json.load(f).items()}


def invert_label_map(label_map: Dict[str, int]) -> Dict[int, str]:
    return {v: k for k, v in label_map.items()}
