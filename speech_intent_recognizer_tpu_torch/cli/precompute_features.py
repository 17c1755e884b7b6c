"""CLI: batch feature precomputation on the device.

Mirrors the JAX package's ``cli/precompute_features.py`` (reference
``scripts/precompute_features.py:149-179``): the same flags, the same
``.npz`` caches and ``cache_info.json``, plus ``--device`` (default
``cuda``, where the K3 kernel runs, or K4 off the reference geometry)::

    python -m speech_intent_recognizer_tpu_torch.cli.precompute_features \\
        --train_csv train.csv --valid_csv valid.csv --test_csv test.csv \\
        --output_dir data/cached_features
"""

from __future__ import annotations

import argparse
import json
import os

from speech_intent_recognizer_tpu_torch.cli.common import (
    add_device_arg, load_config_or_default, setup_logging)
from speech_intent_recognizer_tpu_torch.data import cache as cache_mod
from speech_intent_recognizer_tpu_torch.data.labelmap import (
    create_label_map, load_label_map)
from speech_intent_recognizer_tpu_torch.data.manifest import read_manifest


def main(argv=None) -> dict:
    logger = setup_logging()
    p = argparse.ArgumentParser(description="Precompute log-mel features")
    p.add_argument("--train_csv", required=True)
    p.add_argument("--valid_csv", required=True)
    p.add_argument("--test_csv", required=True)
    p.add_argument("--output_dir", default="data/cached_features")
    p.add_argument("--label_map", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--wire_dtype",
                   choices=("int16_packed", "int16", "float32"),
                   default=None, help="waveform staging format (default: "
                   "config data.precompute_wire_dtype = int16_packed)")
    p.add_argument("--fetch_dtype", choices=("int16", "float32"),
                   default=None, help="feature readback format (default: "
                   "config data.precompute_fetch_dtype = int16)")
    add_device_arg(p)
    args = p.parse_args(argv)

    cfg = load_config_or_default(args.config)
    bs = args.batch_size or cfg.data.precompute_batch_size
    wire = args.wire_dtype or cfg.data.precompute_wire_dtype
    fetch = args.fetch_dtype or cfg.data.precompute_fetch_dtype
    os.makedirs(args.output_dir, exist_ok=True)

    manifests = {name: read_manifest(path) for name, path in
                 (("train", args.train_csv), ("valid", args.valid_csv),
                  ("test", args.test_csv))}
    if args.label_map and os.path.exists(args.label_map):
        label_map = load_label_map(args.label_map)
    else:
        label_map = create_label_map(manifests["train"].labels)

    info = {}
    for name, manifest in manifests.items():
        csv_path = getattr(args, f"{name}_csv")
        out = cache_mod.cache_path_for(csv_path, args.output_dir)
        # stream features to a sidecar .npy memmap (no (N, n_mels, T) RAM
        # copy), then zip-store it
        tmp_npy = out + ".features.tmp.npy"
        timings: dict = {}
        feats, labels, ok, paths = cache_mod.precompute_features(
            manifest, label_map, cfg.audio, batch_size=bs,
            wire_dtype=wire, fetch_dtype=fetch,
            features_out=tmp_npy, timings=timings, device=args.device)
        cache_mod.save_cache(out, feats, labels, paths, label_map, cfg.audio)
        del feats  # release the memmap handle before unlinking
        os.unlink(tmp_npy)
        info[f"{name}_features"] = out
        logger.info("%s: %d features cached (%d failed) "
                    "[decode %.1fs dispatch %.1fs fetch %.1fs "
                    "wire=%s fetch_fmt=%s]",
                    name, len(labels), int((~ok).sum()),
                    timings["decode_s"], timings["stage_dispatch_s"],
                    timings["fetch_s"], wire, fetch)

    with open(os.path.join(args.output_dir, "cache_info.json"), "w") as f:
        json.dump(info, f, indent=2)
    logger.info("feature precomputation complete")
    return info


if __name__ == "__main__":
    main()
