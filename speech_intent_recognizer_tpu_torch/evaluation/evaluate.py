"""Test-set evaluation with report artifacts.

Counterpart of ``speech_intent_recognizer_tpu/evaluation/evaluate.py``
(reference ``scripts/evaluate.py:88-116``): accuracy, an sklearn-style
``classification_report.txt``, the confusion matrix as ``.npy`` and (when
matplotlib imports) ``.png``, and ``metrics.json``.  The model's class
count comes from its ``fc`` layer, as the JAX version reads it from the
checkpoint's head.

With ``mesh=`` (a mesh of devices in this process, ``parallel.create_mesh``)
the forward is data-parallel, as the JAX version's ``shard_map`` over the
``data`` axis: a replica of the model on each data shard's device, each
batch rounded up to a multiple of the data axis and split over them, the
pad rows stripped; a ``model`` axis is replicated, as under JAX's
``shard_map(in_specs=P("data"))``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from speech_intent_recognizer_tpu_torch.evaluation import metrics as M
from speech_intent_recognizer_tpu_torch.parallel.sharding import (
    check_in_process, replicas, run_sharded)

logger = logging.getLogger(__name__)


@torch.no_grad()
def predict_dataset(model: torch.nn.Module, features: torch.Tensor,
                    batch_size: int = 64, mesh=None):
    """Batched argmax predictions, probabilities and logits (host NumPy)
    for features on the model's device; with ``mesh``, data-parallel over
    its devices."""
    check_in_process(mesh)
    model.eval()
    n = int(features.shape[0])
    if mesh is None:
        logits = torch.cat([model(features[i:i + batch_size]).float()
                            for i in range(0, n, batch_size)])
    else:
        dp = mesh.spec.data
        bs = -(-min(batch_size, n) // dp) * dp
        models = replicas(model, mesh)
        logits = torch.cat([
            run_sharded(lambda k, x: models[k](x).float(), mesh,
                        features[i:i + bs])
            for i in range(0, n, bs)])
    probs = torch.softmax(logits, dim=-1)
    logits, probs = logits.cpu().numpy(), probs.cpu().numpy()
    return np.argmax(logits, axis=-1), probs, logits


def evaluate_dataset(model: torch.nn.Module, features: torch.Tensor,
                     labels, label_map: Dict[str, int],
                     results_dir: Optional[str] = None,
                     batch_size: int = 64, mesh=None) -> Dict:
    """Evaluate and (optionally) write the report artifact set; with
    ``mesh``, the forward data-parallel over its devices."""
    inv = {v: k for k, v in label_map.items()}
    y_true = np.asarray(torch.as_tensor(labels).cpu())
    y_pred, probs, _ = predict_dataset(model, features, batch_size, mesh)

    num_classes = probs.shape[1]
    names = [inv.get(i, str(i)) for i in range(num_classes)]
    report = M.classification_report_dict(y_true, y_pred, names, num_classes)
    cm = M.confusion_matrix(y_true, y_pred, num_classes)
    acc = report["accuracy"]
    logger.info("test accuracy: %.4f", acc)

    if results_dir is not None:
        os.makedirs(results_dir, exist_ok=True)
        with open(os.path.join(results_dir, "classification_report.txt"),
                  "w") as f:
            f.write(f"Test Accuracy: {acc:.4f}\n\n")
            f.write(M.format_classification_report(report))
        np.save(os.path.join(results_dir, "confusion_matrix.npy"), cm)
        with open(os.path.join(results_dir, "metrics.json"), "w") as f:
            json.dump(report, f, indent=2)
        _plot_confusion(cm, names,
                        os.path.join(results_dir, "confusion_matrix.png"))
        logger.info("evaluation artifacts written to %s", results_dir)

    return {"accuracy": acc, "report": report, "confusion_matrix": cm,
            "predictions": y_pred, "probabilities": probs}


def evaluate_manifest_with_predictor(
    predictor,
    manifest,
    results_dir: Optional[str] = None,
) -> Dict:
    """Evaluate any waveform predictor (a ``Wav2VecPredictor``) file by file
    over a manifest: the raw-audio counterpart of :func:`evaluate_dataset`
    for a model without a feature cache (the JAX package's function of the
    same name).  Labels outside the map, true or predicted, count as a
    trailing ``<unknown>`` class, so the confusion matrix sums to the files
    evaluated; a file that cannot be decoded is skipped."""
    label_map = predictor.label_map
    inv = predictor.inv_label_map
    num_classes = max(label_map.values()) + 1 if label_map else 0
    unknown_idx = num_classes
    n_unknown_true = n_unknown_pred = 0
    y_true, y_pred = [], []
    for path, label in zip(manifest.paths, manifest.labels):
        r = predictor.predict_file(path)
        if r is None:
            continue
        t = label_map.get(label)
        if t is None:
            n_unknown_true += 1
            t = unknown_idx
        p = label_map.get(r["predicted_label"])
        if p is None:
            n_unknown_pred += 1
            p = unknown_idx
        y_true.append(t)
        y_pred.append(p)
    has_unknown = bool(n_unknown_true or n_unknown_pred)
    if has_unknown:
        logger.warning(
            "labels outside the label map: %d true, %d predicted — "
            "reported as '<unknown>'", n_unknown_true, n_unknown_pred)
    n_eff = num_classes + 1 if has_unknown else num_classes
    names = [inv.get(i, str(i)) for i in range(num_classes)]
    if has_unknown:
        names.append("<unknown>")
    report = M.classification_report_dict(y_true, y_pred, names, n_eff)
    cm = M.confusion_matrix(y_true, y_pred, n_eff)
    if results_dir is not None:
        os.makedirs(results_dir, exist_ok=True)
        with open(os.path.join(results_dir, "classification_report.txt"),
                  "w") as f:
            f.write(f"Test Accuracy: {report['accuracy']:.4f}\n\n")
            f.write(M.format_classification_report(report))
        np.save(os.path.join(results_dir, "confusion_matrix.npy"), cm)
        _plot_confusion(cm, names,
                        os.path.join(results_dir, "confusion_matrix.png"))
    return {"accuracy": report["accuracy"], "report": report,
            "confusion_matrix": cm}


def _plot_confusion(cm: np.ndarray, names, path: str) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logger.warning("matplotlib unavailable; skipping %s", path)
        return
    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(cm, cmap="Blues")
    fig.colorbar(im, ax=ax)
    ax.set_xticks(range(len(names)))
    ax.set_yticks(range(len(names)))
    ax.set_xticklabels(names, rotation=45, ha="right", fontsize=6)
    ax.set_yticklabels(names, fontsize=6)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title("Confusion matrix")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
