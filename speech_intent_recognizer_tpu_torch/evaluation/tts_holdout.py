"""TTS-holdout evaluation with the full artifact set.

Counterpart of ``speech_intent_recognizer_tpu/evaluation/tts_holdout.py``
(the reference's ``scripts/test_tts_samples.py``): run a predictor over a
directory of synthetic utterances, join the expected labels from
``details.csv``, and write

* ``detailed_results.csv`` — per-file expected/predicted/confidence/match
* ``classification_report.csv`` — per-class precision/recall/F1 + accuracy
* ``confusion_matrix.png``, ``class_accuracy.png``,
  ``confidence_distribution.png`` (when matplotlib imports)

under the given report directory.  With the port's ``Predictor`` each file
is one batch of one: on the card K1 once, then K2 once per GRU layer.
"""

from __future__ import annotations

import csv
import logging
import os
from typing import Dict, Optional

import numpy as np

from speech_intent_recognizer_tpu_torch.evaluation import metrics as M

logger = logging.getLogger(__name__)


def evaluate_tts_directory(
    predictor,
    audio_dir: str,
    details_csv: Optional[str] = None,
    report_dir: Optional[str] = None,
) -> Dict:
    """Predict every audio file; join expected labels; emit artifacts.

    ``predictor`` needs ``predict_directory``, ``label_map`` and
    ``inv_label_map``.  Returns ``{"accuracy", "rows", "report"}``."""
    details_csv = details_csv or os.path.join(audio_dir, "details.csv")
    expected: Dict[str, str] = {}
    texts: Dict[str, str] = {}
    if os.path.exists(details_csv):
        with open(details_csv, newline="") as f:
            for row in csv.DictReader(f):
                fname = row.get("filename") or row.get("path") or ""
                expected[fname] = row.get("class") or row.get("label") or ""
                texts[fname] = row.get("text") or ""

    results = predictor.predict_directory(audio_dir)
    rows = []
    for r in results:
        fname = r["file"]
        exp = expected.get(fname, "")
        rows.append({
            "file": fname,
            "text": texts.get(fname, ""),
            "expected": exp,
            "predicted": r["predicted_label"],
            "confidence": r["confidence"],
            "match": bool(exp) and exp == r["predicted_label"],
        })

    labeled = [r for r in rows if r["expected"]]
    label_map = predictor.label_map
    y_true = [label_map.get(r["expected"], -1) for r in labeled]
    y_pred = [label_map.get(r["predicted"], -1) for r in labeled]
    known = [(t, p) for t, p in zip(y_true, y_pred) if t >= 0]
    accuracy = (float(np.mean([t == p for t, p in known])) if known else 0.0)
    inv = predictor.inv_label_map
    n_classes = max(label_map.values()) + 1 if label_map else 0
    names = [inv.get(i, str(i)) for i in range(n_classes)]
    report = (M.classification_report_dict(
        [t for t, _ in known], [p for _, p in known], names, n_classes)
        if known else {"classes": {}, "accuracy": 0.0})

    out = {"accuracy": accuracy, "rows": rows, "report": report}
    if report_dir:
        _write_artifacts(out, names, report_dir)
    logger.info("TTS holdout accuracy: %.4f over %d labeled files",
                accuracy, len(labeled))
    return out


def _write_artifacts(result: Dict, names, report_dir: str) -> None:
    os.makedirs(report_dir, exist_ok=True)
    rows = result["rows"]
    with open(os.path.join(report_dir, "detailed_results.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file", "text", "expected",
                                          "predicted", "confidence", "match"])
        w.writeheader()
        w.writerows(rows)

    report = result["report"]
    with open(os.path.join(report_dir, "classification_report.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["class", "precision", "recall", "f1-score", "support"])
        for name, c in report.get("classes", {}).items():
            w.writerow([name, c["precision"], c["recall"], c["f1-score"],
                        c["support"]])
        w.writerow(["accuracy", "", "", result["accuracy"], len(rows)])
        for avg in ("macro avg", "weighted avg"):
            if avg in report:
                a = report[avg]
                w.writerow([avg, a["precision"], a["recall"], a["f1-score"],
                            a["support"]])

    try:  # the plots are optional: a host without matplotlib skips them
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return

    labeled = [r for r in rows if r["expected"]]
    if labeled:
        # confusion matrix
        lm = {n: i for i, n in enumerate(names)}
        y_true = [lm.get(r["expected"], -1) for r in labeled]
        y_pred = [lm.get(r["predicted"], -1) for r in labeled]
        pairs = [(t, p) for t, p in zip(y_true, y_pred) if t >= 0 and p >= 0]
        if pairs:
            cm = M.confusion_matrix([t for t, _ in pairs],
                                    [p for _, p in pairs], len(names))
            fig, ax = plt.subplots(figsize=(10, 8))
            ax.imshow(cm, cmap="Blues")
            ax.set_xticks(range(len(names)))
            ax.set_yticks(range(len(names)))
            ax.set_xticklabels(names, rotation=90, fontsize=6)
            ax.set_yticklabels(names, fontsize=6)
            ax.set_title("TTS holdout confusion matrix")
            fig.tight_layout()
            fig.savefig(os.path.join(report_dir, "confusion_matrix.png"),
                        dpi=120)
            plt.close(fig)

        # per-class accuracy
        per_class: Dict[str, list] = {}
        for r in labeled:
            per_class.setdefault(r["expected"], []).append(r["match"])
        cls = sorted(per_class)
        accs = [float(np.mean(per_class[c])) for c in cls]
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.bar(range(len(cls)), accs)
        ax.set_xticks(range(len(cls)))
        ax.set_xticklabels(cls, rotation=90, fontsize=6)
        ax.set_ylabel("accuracy")
        ax.set_title("Per-class accuracy")
        fig.tight_layout()
        fig.savefig(os.path.join(report_dir, "class_accuracy.png"), dpi=120)
        plt.close(fig)

    # confidence histogram
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist([r["confidence"] for r in rows], bins=20, range=(0, 1))
    ax.set_xlabel("confidence")
    ax.set_ylabel("count")
    ax.set_title("Prediction confidence distribution")
    fig.tight_layout()
    fig.savefig(os.path.join(report_dir, "confidence_distribution.png"),
                dpi=120)
    plt.close(fig)
