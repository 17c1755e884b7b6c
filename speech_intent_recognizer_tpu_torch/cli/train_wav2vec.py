"""CLI: fine-tune the raw-waveform ``Wav2VecIntent`` model.

Counterpart of the JAX package's ``cli/train_wav2vec.py`` (the reference's
bytecode-only ``python -m scripts.train_wav2vec``: batch 8, 20 epochs,
``facebook/wav2vec2-base``, the feature extractor frozen), with the same
arguments plus ``--device`` (default ``cuda``)::

    python -m speech_intent_recognizer_tpu_torch.cli.train_wav2vec \\
        --config cfg.yaml --train_csv tr.csv --val_csv va.csv \\
        --label_map lm.json [--small] [--warmup_steps N]

``--model_name`` is read as a local ``save_pretrained`` directory; one that
cannot be loaded falls back to ``small_wav2vec_config()`` (hidden 64, 2
layers) with a warning, as in the JAX package.  The model is built in
fp32 whatever the config's ``bf16``, as the JAX CLI builds it.  Writes
``<save_path>/wav2vec_intent.pt`` (the best model's state dict, the
reference ``Wav2VecIntent`` layout) and ``wav2vec_intent.json`` (class
count, val accuracy, backbone config); resumable state goes to
``<save_path>/wav2vec_state``.
"""

from __future__ import annotations

import argparse
import os

import torch

from speech_intent_recognizer_tpu_torch.cli.common import (
    add_config_arg, add_device_arg, load_config_or_default, setup_logging)
from speech_intent_recognizer_tpu_torch.data.labelmap import load_label_map
from speech_intent_recognizer_tpu_torch.data.manifest import read_manifest
from speech_intent_recognizer_tpu_torch.models.wav2vec import (
    create_wav2vec_intent, feature_extractor_params, init_wav2vec,
    small_wav2vec_config)
from speech_intent_recognizer_tpu_torch.train.checkpoint import (
    Checkpointer, save_model)
from speech_intent_recognizer_tpu_torch.train.wav2vec_trainer import (
    Wav2VecTrainer, create_wav2vec_optimizer)


def main(argv=None):
    logger = setup_logging()
    p = argparse.ArgumentParser(description="Fine-tune wav2vec intent model")
    add_config_arg(p, default="configs/config.yaml")
    p.add_argument("--train_csv", required=True)
    p.add_argument("--val_csv", required=True)
    p.add_argument("--label_map", required=True)
    p.add_argument("--model_name", default="facebook/wav2vec2-base",
                   help="a local save_pretrained directory")
    p.add_argument("--small", action="store_true",
                   help="use the built-in small config (no checkpoint)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--freeze_feature_extractor", action="store_true",
                   default=True)
    p.add_argument("--no_freeze", dest="freeze_feature_extractor",
                   action="store_false")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help=">0: linear warmup to --lr then cosine decay, no "
                        "plateau transform (configs/wav2vec_large_batch.yaml)")
    add_device_arg(p)
    args = p.parse_args(argv)

    cfg = load_config_or_default(args.config)
    dev = torch.device(args.device)
    label_map = load_label_map(args.label_map)
    num_classes = max(len(label_map), cfg.model.num_labels)

    model, pretrained = create_wav2vec_intent(
        num_classes, model_name=None if args.small else args.model_name,
        config=small_wav2vec_config() if args.small else None)
    init_wav2vec(model, cfg.train.seed, pretrained)
    if args.freeze_feature_extractor:
        for param in feature_extractor_params(model):
            param.requires_grad_(False)
    model.to(dev)

    train_m = read_manifest(args.train_csv)
    val_m = read_manifest(args.val_csv)
    steps_per_epoch = max(len(train_m) // args.batch_size, 1)
    optimizer = create_wav2vec_optimizer(
        model.parameters(), lr=args.lr, grad_clip=cfg.train.grad_clip,
        warmup_steps=args.warmup_steps,
        decay_steps=steps_per_epoch * args.epochs)

    def to_ids(m):
        return [label_map.get(label, 0) for label in m.labels]

    trainer = Wav2VecTrainer(model, optimizer, num_classes,
                             max_length=cfg.audio.max_samples,
                             sample_rate=cfg.audio.sample_rate)
    ckpt = Checkpointer(
        os.path.join(cfg.train.save_path, "wav2vec_state"),
        model_meta={"num_classes": num_classes, "model": "wav2vec"})
    result = trainer.fit(
        train_m.paths, to_ids(train_m), val_m.paths, to_ids(val_m),
        epochs=args.epochs, batch_size=args.batch_size, seed=cfg.train.seed,
        early_stop_patience=cfg.train.early_stop_patience, checkpointer=ckpt,
        log=logger.info)

    out = os.path.join(cfg.train.save_path, "wav2vec_intent.pt")
    save_model(out, result["best_state"] or model.state_dict(),
               meta={"num_classes": num_classes, "model": "wav2vec",
                     "val_acc": result["best_val_acc"],
                     "wav2vec_config": model.config.to_dict()})
    logger.info("saved %s (best val acc %.4f)", out, result["best_val_acc"])
    return result


if __name__ == "__main__":
    main()
