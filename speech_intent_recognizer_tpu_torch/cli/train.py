"""CLI: train the intent classifier from precomputed features or, with
``data.train_on_waveforms``, from int16 waveforms featurized in each step.

Mirrors the JAX package's ``cli/train.py`` (reference
``scripts/train.py:304-336``): ``--config --train_csv --val_csv --label_map
--resume`` with config fallbacks, plus ``--device`` (default ``cuda``,
where the K2 kernel and its backward run, and in waveform mode K3)::

    python -m speech_intent_recognizer_tpu_torch.cli.train \\
        --config configs/config.yaml --label_map label_map.json

The config's ``parallel`` section runs it data-parallel, one process per
device, each launched with its own ``process_id`` (0 .. ``num_processes``
- 1) and the same ``coordinator_address`` (``host:port``, ``tcp://...``
or ``file:///shared/path``); process p trains on ``cuda:{p % cards}``::

    parallel: {coordinator_address: "localhost:29500", num_processes: 2,
               process_id: 0, data_axis: -1}

The processes form a ``data_axis`` x ``model_axis`` grid (``data_axis``
-1 takes all that ``model_axis`` leaves): ``model_axis`` above 1 splits
the GRU, ``attention`` and ``fc`` leaves over each group of that many
processes (tensor parallelism, ``parallel/sharding.py``), each of which
runs the same rows.  wav2vec trains with ``cli.train_wav2vec``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch

from speech_intent_recognizer_tpu_torch.cli.common import (
    add_config_arg, add_device_arg, load_config_or_default, setup_logging)
from speech_intent_recognizer_tpu_torch.data.labelmap import load_label_map
from speech_intent_recognizer_tpu_torch.data.pipeline import (
    build_dataset, build_waveform_dataset)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
from speech_intent_recognizer_tpu_torch.parallel.distributed import (
    initialize_distributed)
from speech_intent_recognizer_tpu_torch.parallel.mesh import create_mesh
from speech_intent_recognizer_tpu_torch.parallel.sharding import place_params
from speech_intent_recognizer_tpu_torch.train.checkpoint import Checkpointer
from speech_intent_recognizer_tpu_torch.train.loop import Trainer
from speech_intent_recognizer_tpu_torch.train.state import (
    optimizer_from_config)


def check_supported(cfg) -> None:
    """Refuse the JAX package's options that this port does not run."""
    if cfg.model.name != "cnn_gru":
        raise NotImplementedError(
            f"model {cfg.model.name!r}: this CLI trains cnn_gru, as the JAX "
            "package's does; fine-tune wav2vec with "
            "speech_intent_recognizer_tpu_torch.cli.train_wav2vec")


def train_from_config(cfg, train_csv=None, val_csv=None, label_map_path=None,
                      resume=False, logger=None, device="cuda"):
    logger = logger or logging.getLogger("sir_torch")
    check_supported(cfg)
    par = cfg.parallel
    dev = initialize_distributed(par.coordinator_address, par.num_processes,
                                 par.process_id, device=device)
    mesh = None
    if dev is None:  # one process, one device
        dev = torch.device(device)
        for axis in ("data_axis", "model_axis"):
            if getattr(par, axis) not in (-1, 1):
                raise ValueError(
                    f"{axis}={getattr(par, axis)} needs that many processes: "
                    "set parallel.coordinator_address, num_processes, "
                    "process_id")
    else:
        mesh = create_mesh(par.data_axis, par.model_axis)
        logger.info("process %d of %d on %s, mesh %s", mesh.rank,
                    mesh.spec.num_devices, dev, mesh.shape)
    train_csv = train_csv or cfg.data.train_csv
    val_csv = val_csv or cfg.data.valid_csv
    label_map_path = label_map_path or cfg.data.label_map_path
    label_map = load_label_map(label_map_path)
    num_classes = max(cfg.model.num_labels, len(label_map))

    from_waveforms = cfg.data.train_on_waveforms
    build = build_waveform_dataset if from_waveforms else build_dataset
    train_ds = build(train_csv, label_map, cfg, dev)
    val_ds = build(val_csv, label_map, cfg, dev)
    logger.info("datasets loaded - train: %d, val: %d on %s%s",
                train_ds.num_items, val_ds.num_items, dev,
                " (waveform-resident)" if from_waveforms else "")

    model = CNNAudioGRU(
        num_classes=num_classes, conv_channels=cfg.model.conv_channels,
        gru_hidden=cfg.model.gru_hidden, gru_layers=cfg.model.gru_layers,
        dropout=cfg.model.dropout, n_mels=cfg.audio.n_mels,
        compute_dtype=torch.bfloat16 if cfg.train.bf16 else torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(cfg.train.seed))
    model.to(dev)
    place_params(model, mesh)  # this process's parts of the split leaves
    optimizer = optimizer_from_config(cfg, model.parameters(),
                                      train_ds.num_items)

    meta = {"num_classes": num_classes, "model": cfg.model.name,
            "label_map": label_map_path,
            "audio": {"sample_rate": cfg.audio.sample_rate,
                      "n_mels": cfg.audio.n_mels,
                      "mel_spec_length": cfg.audio.mel_spec_length}}
    ckpt = Checkpointer(cfg.train.save_path, model_meta=meta,
                        keep=cfg.train.keep_checkpoints)

    start_epoch, best_val_acc, no_improve = 0, 0.0, 0
    if resume or cfg.train.resume:
        book = ckpt.restore_state(model, optimizer, mesh)
        if book is not None:
            start_epoch = book["epoch"]
            best_val_acc = book["best_val_acc"]
            no_improve = book["no_improve"]

    trainer = Trainer(model, cfg, optimizer=optimizer,
                      num_classes=num_classes, from_waveforms=from_waveforms,
                      mesh=mesh)
    result = trainer.fit(
        train_ds.features, train_ds.labels, val_ds.features, val_ds.labels,
        checkpointer=ckpt, start_epoch=start_epoch,
        best_val_acc=best_val_acc, no_improve=no_improve, log=logger.info,
        train_lengths=train_ds.lengths, val_lengths=val_ds.lengths)

    if trainer.rank == 0:
        history_path = os.path.join(cfg.train.save_path,
                                    "training_history.json")
        with open(history_path, "w") as f:
            json.dump({"best_val_acc": result.best_val_acc,
                       "epochs_run": result.epochs_run,
                       "stopped_early": result.stopped_early,
                       "history": result.history}, f, indent=2)
    return model, result


def main(argv=None):
    logger = setup_logging()
    p = argparse.ArgumentParser(description="Train intent recognition model")
    add_config_arg(p, default="configs/config.yaml")
    p.add_argument("--train_csv", default=None)
    p.add_argument("--val_csv", default=None)
    p.add_argument("--label_map", default="data/processed/label_map.json")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest full-state checkpoint")
    add_device_arg(p)
    args = p.parse_args(argv)
    cfg = load_config_or_default(args.config)
    _model, result = train_from_config(
        cfg, args.train_csv, args.val_csv, args.label_map,
        resume=args.resume, logger=logger, device=args.device)
    logger.info("training completed; best validation accuracy: %.4f",
                result.best_val_acc)
    return result


if __name__ == "__main__":
    main()
