"""Waveform-resident vs feature-cached convergence A/B (same package).

Counterpart of the JAX package's ``examples/waveform_ab.py``, importing
only the port.  Three arms train the reference architecture with one
recipe (fp32, batch 8, lr 1e-3, wd 1e-4, clip 1.0), one stratified split
and the same seed streams (init ``100 * seed + 42``, the trainer's
``100 * seed + 3``) on the 3,040-utterance ``harder`` corpus of
``make_ab_corpus``:

* ``feat`` — from the corpus's golden features;
* ``wave`` — from int16 waveforms on the device, featurized inside every
  step (``data.train_on_waveforms``; K3 on the card);
* ``wave_aug`` — the same with waveform augmentation
  (``data.use_waveform_augment``, ``ops/augment.py``).

The corpus is reused from ``--corpus`` when its ``features.npz`` holds
3,040 rows, else synthesized there first; the int16 waveform cache is kept
beside it::

    python -m speech_intent_recognizer_tpu_torch.examples.waveform_ab \\
        --corpus ab_corpus_harder --seeds 5 --epochs 20 --out wab.json

Exits 0 when the waveform-resident arm's mean is within two standard
errors of the feature-cached arm's (or above it), else 1.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

NUM_CLASSES = 19
LR = 1e-3
WD = 1e-4
CLIP = 1.0
BATCH = 8
CORPUS_ROWS = 3040


def ensure_corpus(corpus_dir: str) -> str:
    """Reuse (or synthesize) the 3,040-utterance A/B corpus in
    ``corpus_dir``."""
    from speech_intent_recognizer_tpu_torch.examples.make_ab_corpus import (
        make_corpus)

    npz = os.path.join(corpus_dir, "features.npz")
    if os.path.exists(npz):
        if np.load(npz)["features"].shape == (CORPUS_ROWS, 64, 200):
            return corpus_dir
    make_corpus(corpus_dir, variants=80, profile="harder", seed=0)
    return corpus_dir


def stratified_split(labels: np.ndarray, holdout_frac: float):
    """Deterministic per-class holdout, the indices of
    ``convergence_ab.load_features_npz`` (``rng(0)``)."""
    rng = np.random.default_rng(0)
    tr, he = [], []
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        k = max(1, int(round(len(idx) * holdout_frac)))
        he.extend(idx[:k])
        tr.extend(idx[k:])
    return np.sort(np.asarray(tr)), np.sort(np.asarray(he))


def load_waveforms(corpus_dir: str, labels: np.ndarray,
                   classes: np.ndarray):
    """Decode the corpus WAVs in manifest order into the int16 cache
    (``data/cache.precompute_waveforms``, the waveform-mode ingest path),
    reusing a cache file built before."""
    from speech_intent_recognizer_tpu_torch.config import AudioConfig
    from speech_intent_recognizer_tpu_torch.data import cache as cache_mod
    from speech_intent_recognizer_tpu_torch.data.manifest import Manifest

    paths = sorted(glob.glob(os.path.join(corpus_dir, "audio", "utt_*.wav")))
    if len(paths) != len(labels):
        raise RuntimeError(f"corpus mismatch: {len(paths)} wavs vs "
                           f"{len(labels)} feature rows")
    cache_npy = os.path.join(corpus_dir, "waveforms_int16.npy")
    audio_cfg = AudioConfig()
    if os.path.exists(cache_npy):
        waves = np.load(cache_npy, mmap_mode="r")
        lengths = np.load(cache_npy + ".lengths.npy")
        if waves.shape == (len(paths), audio_cfg.max_samples):
            return np.asarray(waves), lengths
    label_map = {str(c): i for i, c in enumerate(classes)}
    manifest = Manifest(paths=paths,
                        labels=[str(classes[l]) for l in labels])
    t0 = time.perf_counter()
    waves, lengths, lab2, ok, _ = cache_mod.precompute_waveforms(
        manifest, label_map, audio_cfg, progress=False,
        waves_out=cache_npy)
    if not ok.all() or not np.array_equal(lab2, labels.astype(np.int32)):
        raise RuntimeError("waveform decode mismatch vs feature corpus")
    np.save(cache_npy + ".lengths.npy", lengths)
    print(f"decoded {len(paths)} wavs -> int16 cache in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return np.asarray(waves), lengths


def run_side(mode: str, train_x, train_y, val_x, val_y, epochs: int,
             seed: int, train_len=None, val_len=None,
             device: str = "cuda"):
    """One training run; ``mode`` in {feat, wave, wave_aug}.  The same
    recipe and init / trainer seed streams in every mode.  Returns (best
    held-out acc, wall seconds, epochs run)."""
    from speech_intent_recognizer_tpu_torch.config import Config
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
        CNNAudioGRU)
    from speech_intent_recognizer_tpu_torch.train.loop import Trainer
    from speech_intent_recognizer_tpu_torch.train.state import (
        create_optimizer)

    dev = torch.device(device)
    from_waveforms = mode != "feat"
    cfg = Config.from_dict({
        "num_labels": NUM_CLASSES, "epochs": epochs, "batch_size": BATCH,
        "lr": LR, "weight_decay": WD, "grad_clip": CLIP, "bf16": False,
        "use_augmentation": False, "use_mixup": False,
        "train_on_waveforms": from_waveforms,
        "use_waveform_augment": mode == "wave_aug",
        "augment_prob": 0.5,
        "seed": 100 * seed + 3,
        "early_stop_patience": epochs, "early_stop_delta": 0.0,
    })
    model = CNNAudioGRU(num_classes=NUM_CLASSES)
    model.reset_parameters(torch.Generator().manual_seed(100 * seed + 42))
    model.to(dev)
    opt = create_optimizer(model.parameters(), lr=LR, weight_decay=WD,
                           grad_clip=CLIP)
    trainer = Trainer(model, cfg, optimizer=opt, num_classes=NUM_CLASSES,
                      from_waveforms=from_waveforms)

    def on_dev(a, dtype=None):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(dev, dtype)

    t0 = time.perf_counter()
    result = trainer.fit(
        on_dev(train_x), on_dev(train_y, torch.int64), on_dev(val_x),
        on_dev(val_y, torch.int64), log=lambda *_: None,
        train_lengths=on_dev(train_len, torch.int32),
        val_lengths=on_dev(val_len, torch.int32))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return float(result.best_val_acc), wall, result.epochs_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", required=True,
                    help="A/B corpus directory (synthesized there if absent)")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the kernels, cpu their "
                         "plain versions")
    args = ap.parse_args(argv)

    corpus = ensure_corpus(args.corpus)
    d = np.load(os.path.join(corpus, "features.npz"))
    feats = d["features"].astype(np.float32)
    labels = d["labels"].astype(np.int64)
    classes = d["classes"]
    waves, lengths = load_waveforms(corpus, labels, classes)
    tr, he = stratified_split(labels, 0.2)
    print(f"corpus {corpus}: {len(tr)} train / {len(he)} holdout",
          flush=True)

    sides = ("feat", "wave", "wave_aug")
    accs = {k: [] for k in sides}
    walls = {k: [] for k in sides}
    for seed in range(args.seeds):
        for mode in sides:
            if mode == "feat":
                a, w, ep = run_side(mode, feats[tr], labels[tr],
                                    feats[he], labels[he],
                                    args.epochs, seed, device=args.device)
            else:
                a, w, ep = run_side(mode, waves[tr], labels[tr],
                                    waves[he], labels[he],
                                    args.epochs, seed,
                                    train_len=lengths[tr],
                                    val_len=lengths[he], device=args.device)
            accs[mode].append(a)
            walls[mode].append(w)
            print(f"seed {seed} {mode}: best holdout acc {a:.4f} "
                  f"({w:.1f}s, {ep} epochs)", flush=True)

    def stats(xs):
        return {"mean": float(np.mean(xs)), "std": float(np.std(xs)),
                "accs": [float(x) for x in xs]}

    n = max(args.seeds, 1)
    sem_pair = float(np.sqrt(np.var(accs["feat"]) / n
                             + np.var(accs["wave"]) / n))
    result = {
        "metric": "waveform_resident_ab",
        "corpus": corpus,
        "device": args.device,
        "seeds": args.seeds,
        "epochs": args.epochs,
        "recipe": {"lr": LR, "weight_decay": WD, "grad_clip": CLIP,
                   "batch": BATCH},
        "feature_cached": stats(accs["feat"]),
        "waveform_resident": stats(accs["wave"]),
        "waveform_resident_augmented": stats(accs["wave_aug"]),
        "wall_s_per_run": {k: float(np.mean(v)) for k, v in walls.items()},
        # pass: waveform-resident within 2 standard errors of the mean
        # difference below feature-cached, or above it
        "pass": bool(np.mean(accs["wave"])
                     >= np.mean(accs["feat"]) - 2 * sem_pair - 1e-9),
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line)
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
