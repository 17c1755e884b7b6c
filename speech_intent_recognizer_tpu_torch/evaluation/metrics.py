"""Classification metrics (pure NumPy).

Copy of ``speech_intent_recognizer_tpu/evaluation/metrics.py`` (accuracy,
confusion matrix, the sklearn-style classification report and its text,
top-k), so the port imports no JAX; pinned to the original by
``tests/test_torch_host.py`` and ``tests/test_torch_precompute.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def accuracy_score(y_true, y_pred) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.size == 0:
        return 0.0
    return float((y_true == y_pred).mean())


def confusion_matrix(y_true, y_pred, num_classes: Optional[int] = None
                     ) -> np.ndarray:
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    n = num_classes or (int(max(y_true.max(initial=0),
                                y_pred.max(initial=0))) + 1)
    cm = np.zeros((n, n), np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def classification_report_dict(
    y_true, y_pred,
    target_names: Optional[Sequence[str]] = None,
    num_classes: Optional[int] = None,
) -> Dict:
    """Per-class precision/recall/F1/support + macro and weighted averages."""
    cm = confusion_matrix(y_true, y_pred, num_classes)
    n = cm.shape[0]
    names = list(target_names) if target_names else [str(i) for i in range(n)]
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(axis=1).astype(np.float64)
    pred_count = cm.sum(axis=0).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_count > 0, tp / pred_count, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)

    report = {"classes": {}, "accuracy": accuracy_score(y_true, y_pred)}
    for i, name in enumerate(names[:n]):
        report["classes"][name] = {
            "precision": float(precision[i]),
            "recall": float(recall[i]),
            "f1-score": float(f1[i]),
            "support": int(support[i]),
        }
    total = support.sum()
    w = support / total if total else np.zeros_like(support)
    report["macro avg"] = {
        "precision": float(precision.mean()),
        "recall": float(recall.mean()),
        "f1-score": float(f1.mean()),
        "support": int(total),
    }
    report["weighted avg"] = {
        "precision": float((precision * w).sum()),
        "recall": float((recall * w).sum()),
        "f1-score": float((f1 * w).sum()),
        "support": int(total),
    }
    return report


def format_classification_report(report: Dict) -> str:
    """sklearn-style fixed-width text rendering."""
    names = list(report["classes"].keys())
    width = max([len(n) for n in names] + [12])
    head = f"{'':>{width}}  {'precision':>9} {'recall':>9} {'f1-score':>9} {'support':>9}\n"
    lines = [head, "\n"]
    for name in names:
        c = report["classes"][name]
        lines.append(
            f"{name:>{width}}  {c['precision']:>9.2f} {c['recall']:>9.2f} "
            f"{c['f1-score']:>9.2f} {c['support']:>9}\n")
    lines.append("\n")
    total = report["macro avg"]["support"]
    acc = report["accuracy"]
    lines.append(f"{'accuracy':>{width}}  {'':>9} {'':>9} {acc:>9.2f} "
                 f"{total:>9}\n")
    for avg in ("macro avg", "weighted avg"):
        a = report[avg]
        lines.append(
            f"{avg:>{width}}  {a['precision']:>9.2f} {a['recall']:>9.2f} "
            f"{a['f1-score']:>9.2f} {a['support']:>9}\n")
    return "".join(lines)


def top_k_predictions(probs: np.ndarray, inv_label_map: Dict[int, str],
                      k: int = 3):
    """Top-k (label, probability) pairs for one probability vector —
    the reference's top-3 report format (``test_model.py:145-156``)."""
    probs = np.asarray(probs).reshape(-1)
    top = np.argsort(probs)[::-1][:k]
    return [{"label": inv_label_map.get(int(i), "Unknown"),
             "probability": float(probs[i])} for i in top]
