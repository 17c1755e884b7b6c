"""Classification metrics (pure NumPy).

The part of ``speech_intent_recognizer_tpu/evaluation/metrics.py`` that
inference reports use, copied so the port imports no JAX; pinned to the
original by ``tests/test_torch_host.py``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def top_k_predictions(probs: np.ndarray, inv_label_map: Dict[int, str],
                      k: int = 3):
    """Top-k (label, probability) pairs for one probability vector —
    the reference's top-3 report format (``test_model.py:145-156``)."""
    probs = np.asarray(probs).reshape(-1)
    top = np.argsort(probs)[::-1][:k]
    return [{"label": inv_label_map.get(int(i), "Unknown"),
             "probability": float(probs[i])} for i in top]
