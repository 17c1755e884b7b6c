"""Convergence control: the reference recipe on a precomputed feature
corpus, best held-out accuracy over seeds.

Counterpart of the JAX side of the JAX package's
``examples/convergence_ab.py`` (``train_jax`` and its ``--features``
mode), importing only the port: the port's ``Trainer.fit`` trains the
reference architecture (dropout 0.5) with the reference loop's recipe
(Adam + L2 weight decay, global-norm clip 1.0, per-epoch validation,
best-validation bookkeeping, fp32) on the features of
``make_ab_corpus`` with the same deterministic stratified holdout, and
the same seed streams (init ``100 * seed + 42``, the trainer's
``100 * seed + 3``).  Each seed is one independent run; report the mean
and spread, not one seed::

    python -m speech_intent_recognizer_tpu_torch.examples.make_ab_corpus \\
        --variants 80 --profile harder --seed 0 --out ab_corpus_harder
    python -m speech_intent_recognizer_tpu_torch.examples.convergence_ab \\
        --features ab_corpus_harder/features.npz --epochs 20 --batch 16 \\
        --lr 2e-3 --seeds 5 --out ab.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

LR = 1e-3
WD = 1e-4
CLIP = 1.0
BATCH = 8
NUM_CLASSES = 19


def load_features_npz(path: str, holdout_frac: float):
    """Load a precomputed feature corpus (features/labels npz) and make a
    deterministic stratified holdout split (per class, ``rng(0)``)."""
    d = np.load(path)
    feats = d["features"].astype(np.float32)
    labels = d["labels"].astype(np.int64)
    rng = np.random.default_rng(0)
    tr, he = [], []
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        k = max(1, int(round(len(idx) * holdout_frac)))
        he.extend(idx[:k])
        tr.extend(idx[k:])
    tr = np.sort(np.asarray(tr))
    he = np.sort(np.asarray(he))
    return feats[tr], labels[tr], feats[he], labels[he]


def train_port(feats, labels, v_feats, v_labels, epochs: int,
               seed: int = 0, lr: float = LR, batch: int = BATCH,
               warmup_steps: int = 0, lr_schedule: str = "constant",
               device: str = "cuda"):
    """``Trainer.fit`` with the reference recipe on ``device``.

    Returns (best held-out acc, per-epoch held-out curve)."""
    from speech_intent_recognizer_tpu_torch.config import Config
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
        CNNAudioGRU)
    from speech_intent_recognizer_tpu_torch.train.loop import Trainer
    from speech_intent_recognizer_tpu_torch.train.state import (
        create_optimizer)

    dev = torch.device(device)
    model = CNNAudioGRU(num_classes=NUM_CLASSES)  # architecture dropout 0.5
    model.reset_parameters(torch.Generator().manual_seed(100 * seed + 42))
    model.to(dev)
    cfg = Config.from_dict({
        "num_labels": NUM_CLASSES, "epochs": epochs, "batch_size": batch,
        "lr": lr, "weight_decay": WD, "grad_clip": CLIP, "bf16": False,
        "use_augmentation": False, "use_mixup": False,
        "seed": 100 * seed + 3,
        "early_stop_patience": epochs, "early_stop_delta": 0.0,
    })
    total_steps = epochs * -(-len(feats) // batch)
    opt = create_optimizer(model.parameters(), lr=lr, weight_decay=WD,
                           grad_clip=CLIP, warmup_steps=warmup_steps,
                           schedule=lr_schedule, total_steps=total_steps)
    trainer = Trainer(model, cfg, optimizer=opt, num_classes=NUM_CLASSES)
    result = trainer.fit(
        torch.from_numpy(feats).to(dev), torch.from_numpy(labels).to(dev),
        torch.from_numpy(v_feats).to(dev),
        torch.from_numpy(v_labels).to(dev), log=lambda *_: None)
    curve = [e["val_acc"] for e in result.history]
    return float(result.best_val_acc), curve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--features", required=True,
                    help="precomputed features/labels npz (make_ab_corpus)")
    ap.add_argument("--holdout_frac", type=float, default=0.2,
                    help="stratified holdout fraction")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--lr", type=float, default=LR)
    ap.add_argument("--warmup_steps", type=int, default=0,
                    help="linear LR warmup (large-batch recipe)")
    ap.add_argument("--lr_schedule", default="constant",
                    choices=["constant", "cosine"])
    ap.add_argument("--seed_offset", type=int, default=0,
                    help="first seed index (extend an existing seed sample "
                         "without rerunning it)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="independent seeds; per-seed accuracies and their "
                         "mean are reported")
    ap.add_argument("--curves", action="store_true",
                    help="include per-epoch held-out accuracy curves")
    ap.add_argument("--out", default=None, help="write result JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the kernels, cpu their "
                         "plain versions")
    args = ap.parse_args(argv)

    feats, labels, v_feats, v_labels = load_features_npz(
        args.features, args.holdout_frac)
    accs, curves, walls = [], [], []
    for seed in range(args.seed_offset, args.seed_offset + args.seeds):
        t0 = time.perf_counter()
        acc, curve = train_port(feats, labels, v_feats, v_labels,
                                args.epochs, seed=seed, lr=args.lr,
                                batch=args.batch,
                                warmup_steps=args.warmup_steps,
                                lr_schedule=args.lr_schedule,
                                device=args.device)
        walls.append(time.perf_counter() - t0)
        accs.append(acc)
        curves.append(curve)
        print(f"seed {seed}: {acc:.4f} ({walls[-1]:.1f} s)",
              file=sys.stderr, flush=True)

    result = {
        "epochs": args.epochs,
        "holdout_size": int(len(v_labels)),
        "train_size": int(len(labels)),
        "recipe": {"lr": args.lr, "weight_decay": WD, "grad_clip": CLIP,
                   "batch_size": args.batch, "dropout": 0.5},
        "device": args.device,
        "features": args.features,
        "seeds": list(range(args.seed_offset,
                            args.seed_offset + args.seeds)),
        "accs": accs,
        "best_held_acc": float(np.mean(accs)),
        "std": float(np.std(accs, ddof=1)) if len(accs) > 1 else None,
        "seconds": walls,
    }
    if args.curves:
        result["curves"] = curves
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
