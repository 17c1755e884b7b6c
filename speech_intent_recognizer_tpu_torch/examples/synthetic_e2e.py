"""End-to-end accuracy on a synthesized corpus.

Counterpart of the JAX package's ``examples/synthetic_e2e.py``, importing
only the port.  FSC audio is not distributable, so this synthesizes a
multi-hundred-utterance corpus with the hermetic TTS engine (19 intent
classes, distinct per-text acoustics and per-variant jitter), then runs the
whole pipeline, ``cli.run_pipeline`` (preprocess -> feature precompute, K3
on the card -> training, K2 and K2T -> evaluation), and reports held-out
intent accuracy::

    python -m speech_intent_recognizer_tpu_torch.examples.synthetic_e2e \\
        --variants 20 --epochs 8 --workdir /tmp/sir_synth

:func:`train_and_evaluate` takes any manifest, e.g. the one
``make_ab_corpus.make_corpus`` returns.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import tempfile

import numpy as np

from speech_intent_recognizer_tpu_torch.examples.make_ab_corpus import (
    SENTENCES)


def synthesize_corpus(sentence_csv: str, out_dir: str, variants: int,
                      rng: np.random.Generator):
    """``variants`` recordings per sentence with speed, gain and noise
    jitter; -> [(wav path, class label), ...]."""
    from speech_intent_recognizer_tpu_torch.data.audio_io import (
        load_audio, save_wav)
    from speech_intent_recognizer_tpu_torch.tts.generate import (
        _read_sentence_sheet, synthesize_text)

    rows = _read_sentence_sheet(sentence_csv)
    os.makedirs(out_dir, exist_ok=True)
    manifest = []
    for idx, (text, label) in enumerate(rows):
        base = os.path.join(out_dir, f"base_{idx:04d}.wav")
        synthesize_text(text, base, engine="synthetic")
        x, sr = load_audio(base)
        for v in range(variants):
            # linear-interp speed/pitch jitter + noise + gain variation
            # (a bandlimited resampler is overkill here, and coprime rate
            # pairs would build enormous polyphase banks)
            rate = float(rng.uniform(0.9, 1.1))
            pos = np.arange(int(len(x) / rate)) * rate
            y = np.interp(pos, np.arange(len(x)), x).astype(np.float32)
            y = y * float(rng.uniform(0.6, 1.0))
            y = y + rng.normal(0, 0.005, len(y)).astype(np.float32)
            path = os.path.join(out_dir, f"utt_{idx:04d}_{v:02d}.wav")
            save_wav(path, y, sr)
            manifest.append((path, label))
        os.remove(base)
    return manifest


def write_splits(manifest, workdir: str, rng: np.random.Generator) -> dict:
    """A random 60 / 20 / 20 train / valid / test split of ``manifest``
    as ``<workdir>/{train,valid,test}.csv``; -> {split: csv path}."""
    order = rng.permutation(len(manifest))
    n_test = len(manifest) // 5
    n_val = len(manifest) // 5
    splits = {"test": order[:n_test],
              "valid": order[n_test:n_test + n_val],
              "train": order[n_test + n_val:]}
    paths = {}
    for name, ids in splits.items():
        path = os.path.join(workdir, f"{name}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["path", "label"])
            for i in ids:
                w.writerow(manifest[i])
        paths[name] = path
    print(f"corpus: {len(manifest)} utterances "
          f"({len(splits['train'])} train / {n_val} val / {n_test} test)",
          flush=True)
    return paths


def train_and_evaluate(paths: dict, workdir: str, epochs: int,
                       device: str = "cuda", num_labels: int = 19,
                       stage_times: dict | None = None) -> dict:
    """``cli.run_pipeline`` on the splits (the JAX script's recipe: batch
    16, lr 2e-3, SpecAugment at 0.5, seed 0); -> the evaluation's
    ``metrics.json``.  Raises if the pipeline fails."""
    from speech_intent_recognizer_tpu_torch.cli.run_pipeline import (
        run_pipeline)
    from speech_intent_recognizer_tpu_torch.config import Config
    from speech_intent_recognizer_tpu_torch.config.loader import save_config

    cfg = Config.from_dict({
        "train_csv": paths["train"], "valid_csv": paths["valid"],
        "test_csv": paths["test"],
        "label_map_path": os.path.join(workdir, "label_map.json"),
        "output_dir": os.path.join(workdir, "processed"),
        "cache_dir": os.path.join(workdir, "cache"),
        "save_path": os.path.join(workdir, "ckpt"),
        "num_labels": num_labels, "epochs": epochs, "batch_size": 16,
        "lr": 0.002, "augment_prob": 0.5, "precompute_batch_size": 128,
        "seed": 0,
    })
    cfg_path = os.path.join(workdir, "config.json")
    save_config(cfg, cfg_path)
    if not run_pipeline(cfg_path, validate_audio=False,
                        stage_times=stage_times, device=device):
        raise RuntimeError("the pipeline failed (see its log)")
    with open(os.path.join(workdir, "ckpt", "evaluation_results",
                           "metrics.json")) as f:
        return json.load(f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", type=int, default=20)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the kernels, cpu their "
                        "plain versions")
    args = p.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="sir_synth_")
    rng = np.random.default_rng(0)
    print(f"synthesizing corpus ({args.variants} variants/sentence) ...",
          flush=True)
    manifest = synthesize_corpus(SENTENCES,
                                 os.path.join(workdir, "audio"),
                                 args.variants, rng)
    paths = write_splits(manifest, workdir, rng)
    try:
        metrics = train_and_evaluate(paths, workdir, args.epochs,
                                     args.device)
    except RuntimeError as e:
        print(e)
        return 1
    print(json.dumps({"synthetic_e2e_test_accuracy": metrics["accuracy"],
                      "classes": len(metrics["classes"]),
                      "workdir": workdir}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
