"""CLI: full pipeline orchestrator — preprocess -> precompute -> train ->
evaluate.

Mirrors the JAX package's ``cli/run_pipeline.py`` (the reference's
``run_pipeline.py:39-238``: the same four stages, the same
``--config_path`` / ``--force_precompute`` flags, the same data-path
fallback search), with the stages run in-process as library calls, plus
``--device`` (default ``cuda``)::

    python -m speech_intent_recognizer_tpu_torch.cli.run_pipeline \\
        --config_path configs/config.yaml

With ``data.train_on_waveforms`` step 2 writes int16 waveform caches for
the train and valid splits (host decode only) and a feature cache for the
test split; training then featurizes every batch inside its step (K3 on a
CUDA device), with ``data.use_waveform_augment`` augmenting the waveforms
first.  Step 4 evaluates the port's checkpoint, ``best_model.pt`` in
``train.save_path`` (the JAX package reads ``best_model.msgpack`` there).
"""

from __future__ import annotations

import argparse
import os
import time

from speech_intent_recognizer_tpu_torch.cli.common import (
    add_device_arg, setup_logging)
from speech_intent_recognizer_tpu_torch.config import load_config
from speech_intent_recognizer_tpu_torch.data import cache as cache_mod
from speech_intent_recognizer_tpu_torch.data.preprocess import (
    preprocess_dataset)
from speech_intent_recognizer_tpu_torch.utils.profiling import (
    device_memory_stats)

_FALLBACK_ROOTS = ("data/processed/{name}_data.csv",
                   "data/FSC/fluent_speech_commands_dataset/data/"
                   "{name}_data.csv",
                   "data/{name}_data.csv")


def _resolve_split(configured: str, name: str, logger) -> str:
    if os.path.exists(configured):
        return configured
    for pattern in _FALLBACK_ROOTS:
        candidate = pattern.format(name=name)
        if os.path.exists(candidate):
            logger.info("using alternative %s data path: %s", name, candidate)
            return candidate
    return configured


def _precompute_waveform_mode(cfg, train_csv, valid_csv, test_csv,
                              label_map_path, device) -> None:
    """Step 2 of waveform-resident training: waveform caches for train and
    valid, a feature cache for the test split that step 4 reads."""
    from speech_intent_recognizer_tpu_torch.data.labelmap import (
        load_label_map)
    from speech_intent_recognizer_tpu_torch.data.manifest import (
        read_manifest)

    label_map = load_label_map(label_map_path)
    for csvp in (train_csv, valid_csv):
        wf_cache = cache_mod.waveform_cache_path_for(csvp, cfg.data.cache_dir)
        if cfg.data.force_precompute or not os.path.exists(wf_cache):
            waves, lengths, labels, _ok, paths = (
                cache_mod.precompute_waveforms(
                    read_manifest(csvp), label_map, cfg.audio,
                    progress=False))
            cache_mod.save_waveform_cache(wf_cache, waves, lengths, labels,
                                          paths, label_map, cfg.audio)
    test_cache = cache_mod.cache_path_for(test_csv, cfg.data.cache_dir)
    if cfg.data.force_precompute or not os.path.exists(test_cache):
        feats, labels, _ok, paths = cache_mod.precompute_features(
            read_manifest(test_csv), label_map, cfg.audio,
            batch_size=cfg.data.precompute_batch_size, progress=False,
            wire_dtype=cfg.data.precompute_wire_dtype,
            fetch_dtype=cfg.data.precompute_fetch_dtype, device=device)
        cache_mod.save_cache(test_cache, feats, labels, paths, label_map,
                             cfg.audio)


def run_pipeline(config_path: str, force_precompute: bool = False,
                 validate_audio: bool = True,
                 stage_times: dict | None = None,
                 device: str = "cuda") -> bool:
    """Run preprocess -> precompute -> train -> evaluate on ``device``.

    ``stage_times`` (optional) is filled with each stage's wall-clock
    seconds."""
    if stage_times is None:
        stage_times = {}
    logger = setup_logging()
    logger.info("=== Starting Speech Intent Recognition Pipeline (%s) ===",
                device)
    for name, s in device_memory_stats().items():
        logger.info("%s: %.0fMB used / %.0fMB", name,
                    s["bytes_in_use"] / 2**20, s["bytes_limit"] / 2**20)
    cfg = load_config(config_path)
    if force_precompute:
        cfg.data.force_precompute = True

    train_csv = _resolve_split(cfg.data.train_csv, "train", logger)
    valid_csv = _resolve_split(cfg.data.valid_csv, "valid", logger)
    test_csv = _resolve_split(cfg.data.test_csv, "test", logger)
    missing = [p for p in (train_csv, valid_csv, test_csv)
               if not os.path.exists(p)]
    if missing:
        logger.error("could not find required data files: %s", missing)
        return False

    # STEP 1: preprocess (validate + label map)
    logger.info("=== STEP 1: DATA PREPROCESSING ===")
    t_stage = time.perf_counter()
    processed = preprocess_dataset(
        train_csv, valid_csv, test_csv, cfg.data.output_dir,
        label_map_path=cfg.data.label_map_path, validate=validate_audio)
    train_csv = processed["train_csv"]
    valid_csv = processed["valid_csv"]
    test_csv = processed["test_csv"]
    label_map_path = processed["label_map"]
    stage_times["preprocess"] = time.perf_counter() - t_stage

    # STEP 2: precompute; build_dataset inside train / evaluate handles
    # cache hits, so this stage only fills misses
    t_stage = time.perf_counter()
    if cfg.data.use_feature_cache and cfg.data.train_on_waveforms:
        logger.info("=== STEP 2: PRECOMPUTING WAVEFORM CACHE "
                    "(train/valid) + TEST FEATURES ===")
        _precompute_waveform_mode(cfg, train_csv, valid_csv, test_csv,
                                  label_map_path, device)
        cfg.data.force_precompute = False
    elif cfg.data.use_feature_cache:
        logger.info("=== STEP 2: PRECOMPUTING FEATURES ===")
        train_cache = cache_mod.cache_path_for(train_csv, cfg.data.cache_dir)
        if cfg.data.force_precompute or not os.path.exists(train_cache):
            from speech_intent_recognizer_tpu_torch.cli.precompute_features \
                import main as precompute_main

            try:
                precompute_main([
                    "--train_csv", train_csv, "--valid_csv", valid_csv,
                    "--test_csv", test_csv,
                    "--output_dir", cfg.data.cache_dir,
                    "--label_map", label_map_path,
                    "--config", config_path, "--device", device])
            except Exception as e:
                logger.warning("feature precomputation failed (%s); "
                               "continuing with on-the-fly extraction", e)
                cfg.data.use_feature_cache = False
            else:
                # the flag means "rebuild the cache once": the train and
                # evaluate stages read the caches this stage just built
                cfg.data.force_precompute = False
        else:
            logger.info("using existing cached features in %s",
                        cfg.data.cache_dir)
    stage_times["precompute"] = time.perf_counter() - t_stage

    # STEP 3: train
    logger.info("=== STEP 3: TRAINING MODEL ===")
    t_stage = time.perf_counter()
    from speech_intent_recognizer_tpu_torch.cli.train import (
        train_from_config)

    try:
        train_from_config(cfg, train_csv, valid_csv, label_map_path,
                          logger=logger, device=device)
    except Exception:
        logger.exception("training failed; stopping pipeline")
        return False
    stage_times["train"] = time.perf_counter() - t_stage

    # STEP 4: evaluate
    logger.info("=== STEP 4: EVALUATING MODEL ===")
    t_stage = time.perf_counter()
    model_path = os.path.join(cfg.train.save_path, "best_model.pt")
    if not os.path.exists(model_path):
        logger.error("model file not found: %s", model_path)
        return False
    from speech_intent_recognizer_tpu_torch.cli.evaluate import (
        evaluate_from_config)

    try:
        evaluate_from_config(cfg, test_csv, label_map_path, model_path,
                             logger=logger, device=device)
    except Exception:
        logger.exception("evaluation failed; stopping pipeline")
        return False
    stage_times["evaluate"] = time.perf_counter() - t_stage

    logger.info("stage wall-clock: %s",
                "  ".join(f"{k}={v:.1f}s" for k, v in stage_times.items()))
    logger.info("=== Pipeline Completed Successfully ===")
    return True


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Run the full speech intent recognition pipeline")
    p.add_argument("--config_path", default="configs/config.yaml")
    p.add_argument("--force_precompute", action="store_true")
    p.add_argument("--no_validate", action="store_true",
                   help="skip per-file audio validation in preprocessing")
    add_device_arg(p)
    args = p.parse_args(argv)
    ok = run_pipeline(args.config_path, args.force_precompute,
                      validate_audio=not args.no_validate,
                      device=args.device)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
