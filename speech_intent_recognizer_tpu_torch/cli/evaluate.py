"""CLI: evaluate a trained model on the test split.

Mirrors the JAX package's ``cli/evaluate.py`` (reference
``scripts/evaluate.py:119-128``): ``--config --test_csv --label_map
--model_path`` (``--model`` is accepted too) ``--results_dir``, plus
``--device`` (default ``cuda``).  Reads reference-layout ``.pt`` state
dicts of the config's model widths (the class count is read from the
checkpoint); features come from the feature cache, computed on a miss (on a
CUDA device by the K3 kernel, or K4 off the reference geometry).
``--model_type wav2vec`` evaluates a ``Wav2VecIntent`` checkpoint file by
file over the manifest (``evaluate_manifest_with_predictor``), its report
under ``<save_path>/evaluation_results_wav2vec`` by default.
``--data_parallel`` runs the forward over a ``(data, model)`` mesh of every
card (``--device cpu``: ``parallel.data_axis`` x ``parallel.model_axis``
entries of the CPU), a replica of the model on each data shard's device,
the ``model`` axis replicated, as the JAX CLI's mesh over its devices::

    python -m speech_intent_recognizer_tpu_torch.cli.evaluate \\
        --test_csv test.csv --label_map label_map.json \\
        --model_path checkpoints/best_model.pt
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from speech_intent_recognizer_tpu_torch.cli.common import (
    add_config_arg, add_device_arg, add_model_type_arg, load_config_or_default,
    setup_logging)
from speech_intent_recognizer_tpu_torch.convert.checkpoint import (
    load_model_checkpoint)
from speech_intent_recognizer_tpu_torch.data.labelmap import load_label_map
from speech_intent_recognizer_tpu_torch.data.pipeline import build_dataset
from speech_intent_recognizer_tpu_torch.evaluation.evaluate import (
    evaluate_dataset)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
from speech_intent_recognizer_tpu_torch.parallel.mesh import create_mesh


def data_parallel_mesh(cfg, device):
    """Every card for ``cuda``; ``parallel.data_axis`` (at least one) x
    ``parallel.model_axis`` entries of any other device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but torch.cuda.is_available() "
                               "is False")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev] * (max(1, cfg.parallel.data_axis)
                           * max(1, cfg.parallel.model_axis))
    return create_mesh(cfg.parallel.data_axis, cfg.parallel.model_axis,
                       devices)


def evaluate_from_config(cfg, test_csv, label_map_path, model_path,
                         results_dir=None, logger=None,
                         model_type="cnn_gru", data_parallel=False,
                         device="cuda"):
    logger = logger or logging.getLogger("sir_torch")
    mesh = None
    if data_parallel:
        mesh = data_parallel_mesh(cfg, device)
        device = mesh.devices[0]
        logger.info("data-parallel evaluation over mesh %s on %s",
                    mesh.shape, [str(d) for d in mesh.data_devices])
    if model_type == "wav2vec":
        from speech_intent_recognizer_tpu_torch.data.manifest import (
            read_manifest)
        from speech_intent_recognizer_tpu_torch.evaluation.evaluate import (
            evaluate_manifest_with_predictor)
        from speech_intent_recognizer_tpu_torch.infer.predict import (
            Wav2VecPredictor)

        predictor = Wav2VecPredictor.from_checkpoint(
            model_path, label_map_path, audio_cfg=cfg.audio, device=device,
            mesh=mesh)
        results_dir = results_dir or os.path.join(
            cfg.train.save_path, "evaluation_results_wav2vec")
        result = evaluate_manifest_with_predictor(
            predictor, read_manifest(test_csv), results_dir)
        logger.info("wav2vec test accuracy: %.4f", result["accuracy"])
        return result
    if model_type != "cnn_gru":
        raise ValueError(f"unknown model_type {model_type!r}")
    dev = torch.device(device)
    label_map = load_label_map(label_map_path)
    state = load_model_checkpoint(model_path)
    # the class count from the checkpoint's head, not hardcoded (the
    # reference pins 31 at evaluate.py:44-45)
    num_classes = int(state["fc.weight"].shape[0])
    model = CNNAudioGRU(num_classes=num_classes,
                        conv_channels=cfg.model.conv_channels,
                        gru_hidden=cfg.model.gru_hidden,
                        gru_layers=cfg.model.gru_layers,
                        n_mels=cfg.audio.n_mels)
    model.load_state_dict(state)
    model.to(dev)

    test_ds = build_dataset(test_csv, label_map, cfg, dev)
    results_dir = results_dir or os.path.join(cfg.train.save_path,
                                              "evaluation_results")
    result = evaluate_dataset(
        model, test_ds.features, test_ds.labels, label_map,
        results_dir=results_dir,
        batch_size=cfg.train.batch_size * cfg.train.eval_batch_multiplier,
        mesh=mesh)
    logger.info("test accuracy: %.4f", result["accuracy"])
    return result


def main(argv=None):
    logger = setup_logging()
    p = argparse.ArgumentParser(
        description="Evaluate speech intent recognition model")
    add_config_arg(p, default="configs/config.yaml")
    p.add_argument("--test_csv", required=True)
    p.add_argument("--label_map", required=True)
    p.add_argument("--model_path", "--model", dest="model_path",
                   required=True)
    p.add_argument("--results_dir", default=None)
    add_model_type_arg(p)
    p.add_argument("--data_parallel", action="store_true",
                   help="run the forward over a mesh of every card")
    add_device_arg(p)
    args = p.parse_args(argv)
    cfg = load_config_or_default(args.config)
    return evaluate_from_config(cfg, args.test_csv, args.label_map,
                                args.model_path, args.results_dir, logger,
                                model_type=args.model_type,
                                data_parallel=args.data_parallel,
                                device=args.device)


if __name__ == "__main__":
    main()
