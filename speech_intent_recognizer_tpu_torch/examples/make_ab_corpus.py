"""Synthesize a convergence-A/B corpus and cache golden features as npz.

Counterpart of the JAX package's ``examples/make_ab_corpus.py``, importing
only the port: at the same ``--seed``, ``--profile`` and ``--variants`` its
WAVs are byte-equal to that script's and its ``features.npz`` arrays equal
(the fp64 golden front-end, ``ops/frontend_numpy.py``; classes sorted).

Every sentence of the sheet is rendered by the hermetic TTS engine, then
``--variants`` copies each get a speed, gain and noise jitter drawn from
the profile: ``easy`` saturates held-out accuracy early, ``hard`` widens
the jitter, ``harder`` adds enough per-utterance noise to hold a 15-epoch
asymptote near 0.9, where a systematic difference between two training
paths shows::

    python -m speech_intent_recognizer_tpu_torch.examples.make_ab_corpus \\
        --variants 80 --profile harder --seed 0 --out ab_corpus_harder

The output is ``<out>/audio/utt_<sentence>_<variant>.wav`` and
``<out>/features.npz`` (``features`` (N, 64, 200) float32, ``labels``
(N,) int64, ``classes``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SENTENCES = os.path.join(REPO, "configs", "custom_intents_sentences.csv")

PROFILES = {
    # (rate lo/hi, gain lo/hi, noise sigma lo/hi)
    "easy": ((0.9, 1.1), (0.6, 1.0), (0.005, 0.005)),
    "hard": ((0.78, 1.28), (0.25, 1.0), (0.01, 0.08)),
    # enough per-utterance noise to buy an irreducible error floor: the
    # 15-epoch asymptote sits at ~0.9 where training differences show
    "harder": ((0.7, 1.4), (0.15, 1.0), (0.05, 0.3)),
}


def synthesize(sentence_csv: str, out_dir: str, variants: int,
               rng: np.random.Generator, profile: str):
    """``variants`` jittered copies of every sentence's synthetic rendering;
    -> [(wav path, class label), ...] in sentence, then variant order."""
    from speech_intent_recognizer_tpu_torch.data.audio_io import (
        load_audio, save_wav)
    from speech_intent_recognizer_tpu_torch.tts.generate import (
        _read_sentence_sheet, synthesize_text)

    (rlo, rhi), (glo, ghi), (nlo, nhi) = PROFILES[profile]
    rows = _read_sentence_sheet(sentence_csv)
    os.makedirs(out_dir, exist_ok=True)
    manifest = []
    for idx, (text, label) in enumerate(rows):
        base = os.path.join(out_dir, f"base_{idx:04d}.wav")
        synthesize_text(text, base, engine="synthetic")
        x, sr = load_audio(base)
        for v in range(variants):
            rate = float(rng.uniform(rlo, rhi))
            pos = np.arange(int(len(x) / rate)) * rate
            y = np.interp(pos, np.arange(len(x)), x).astype(np.float32)
            y = y * float(rng.uniform(glo, ghi))
            y = y + rng.normal(0, float(rng.uniform(nlo, nhi)),
                               len(y)).astype(np.float32)
            path = os.path.join(out_dir, f"utt_{idx:04d}_{v:02d}.wav")
            save_wav(path, y, sr)
            manifest.append((path, label))
        os.remove(base)
    return manifest


def featurize(manifest) -> tuple:
    """Golden (fp64 NumPy) features of every WAV -> (features (N, 64, 200)
    float32, labels (N,) int64, classes sorted)."""
    from speech_intent_recognizer_tpu_torch.data.audio_io import load_audio
    from speech_intent_recognizer_tpu_torch.ops import (
        frontend_numpy as golden)

    classes = sorted({lab for _, lab in manifest})
    label_map = {c: i for i, c in enumerate(classes)}
    feats = np.zeros((len(manifest), 64, 200), np.float32)
    labels = np.zeros(len(manifest), np.int64)
    for i, (path, lab) in enumerate(manifest):
        x, _ = load_audio(path, target_sample_rate=16000)
        feats[i] = golden.pad_or_trim_np(
            golden.log_mel_spectrogram_np(x), 200)
        labels[i] = label_map[lab]
    return feats, labels, classes


def make_corpus(out: str, variants: int, profile: str,
                seed: int = 0) -> list:
    """Synthesize ``<out>/audio`` from the repository's sentence sheet and
    write ``<out>/features.npz``; returns the manifest."""
    rng = np.random.default_rng(seed)
    t0 = time.time()
    manifest = synthesize(SENTENCES, os.path.join(out, "audio"), variants,
                          rng, profile)
    print(f"synth[{profile}]: {len(manifest)} utts "
          f"in {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    feats, labels, classes = featurize(manifest)
    out_npz = os.path.join(out, "features.npz")
    np.savez(out_npz, features=feats, labels=labels,
             classes=np.array(classes))
    print(f"featurized in {time.time() - t0:.1f}s -> {out_npz}", flush=True)
    return manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", type=int, default=80)
    ap.add_argument("--profile", choices=sorted(PROFILES), default="hard")
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    make_corpus(args.out, args.variants, args.profile, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
