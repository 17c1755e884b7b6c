"""Dataset preprocessing: manifest validation + label map construction.

Copy of ``speech_intent_recognizer_tpu/data/preprocess.py`` (reference
``scripts/preprocess_fsc.py:56-207``): read each split's manifest, resolve
its audio paths, drop rows whose audio is missing, undecodable or shorter
than 100 samples, build the sorted label map from the training split, and
write ``{train,valid,test}_data.csv`` + ``label_map.json``.  Pure host
code; ``tests/test_torch_pipeline.py`` holds its files byte-equal to the
JAX package's.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

from speech_intent_recognizer_tpu_torch.data.audio_io import validate_audio
from speech_intent_recognizer_tpu_torch.data.labelmap import (
    create_label_map, save_label_map)
from speech_intent_recognizer_tpu_torch.data.manifest import (
    Manifest, read_manifest)

logger = logging.getLogger(__name__)


def process_manifest(csv_path: str, base_path: Optional[str] = None,
                     validate: bool = True,
                     progress: bool = True) -> Manifest:
    """Read + validate one split; returns the filtered manifest.
    ``validate=False`` only checks that each file exists."""
    m = read_manifest(csv_path, base_path=base_path)
    logger.info("loaded %d examples from %s", len(m), csv_path)
    if not validate:
        keep = [i for i, p in enumerate(m.paths) if os.path.exists(p)]
    else:
        iterator = range(len(m))
        if progress:
            try:
                from tqdm import tqdm

                iterator = tqdm(iterator, desc="validating audio")
            except ImportError:
                pass
        keep = [i for i in iterator if validate_audio(m.paths[i])]
    dropped = len(m) - len(keep)
    if dropped:
        logger.warning("dropped %d invalid audio files from %s",
                       dropped, csv_path)
    if not keep:
        raise ValueError(f"no valid audio files found in {csv_path}")
    return m.subset(keep)


def preprocess_dataset(
    train_csv: str,
    valid_csv: str,
    test_csv: str,
    output_dir: str,
    label_map_path: Optional[str] = None,
    base_path: Optional[str] = None,
    validate: bool = True,
) -> Dict[str, str]:
    """Full preprocessing stage; returns the processed artifact paths."""
    os.makedirs(output_dir, exist_ok=True)
    splits = {}
    for name, path in (("train", train_csv), ("valid", valid_csv),
                       ("test", test_csv)):
        splits[name] = process_manifest(path, base_path, validate)

    label_map = create_label_map(splits["train"].labels)
    logger.info("created label map with %d classes", len(label_map))

    out = {}
    for name, m in splits.items():
        out_path = os.path.join(output_dir, f"{name}_data.csv")
        m.write_csv(out_path)
        out[f"{name}_csv"] = out_path
    label_map_path = label_map_path or os.path.join(output_dir,
                                                    "label_map.json")
    save_label_map(label_map, label_map_path)
    out["label_map"] = label_map_path
    logger.info("samples: train=%d valid=%d test=%d",
                len(splits["train"]), len(splits["valid"]),
                len(splits["test"]))
    return out
