"""The port's training path against the JAX package on the same numpy
inputs: BatchNorm statistics, the optimizer chain and schedules, the
batching helpers, SpecAugment and mixup, the Trainer step for step, early
stopping, best-model export and resume, the config reader, and the
train -> evaluate CLIs."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu.config import load_config as ref_load_config
from speech_intent_recognizer_tpu.config.schema import Config as RefConfig
from speech_intent_recognizer_tpu.convert.torch_import import (
    convert_torch_state_dict)
from speech_intent_recognizer_tpu.models import cnn_gru as ref_model
from speech_intent_recognizer_tpu.train import loop as ref_loop
from speech_intent_recognizer_tpu.train import state as ref_state
from speech_intent_recognizer_tpu_torch.config import (
    Config, load_audio_config, load_config)
from speech_intent_recognizer_tpu_torch.convert.jax_bridge import (
    from_jax_variables)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
from speech_intent_recognizer_tpu_torch.ops.augment import mixup
from speech_intent_recognizer_tpu_torch.ops.specaugment import spec_augment
from speech_intent_recognizer_tpu_torch.train.checkpoint import Checkpointer
from speech_intent_recognizer_tpu_torch.train.loop import (
    Trainer, pad_permutation, sequential_batches)
from speech_intent_recognizer_tpu_torch.train.state import (
    create_optimizer, optimizer_from_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
# the narrow model of the parity tests: conv (8, 16, 16), H = 32
NARROW = dict(conv_channels=(8, 16, 16), gru_hidden=32)
CLASSES, T_IN = 5, 64


def _flax_narrow(dropout=0.0, seed=0):
    model = ref_model.CNNAudioGRU(num_classes=CLASSES, dropout=dropout,
                                  **NARROW)
    variables = ref_model.init_model(model, jax.random.key(seed),
                                     input_shape=(1, 64, T_IN))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    return model, params, stats


def _port_narrow(params, stats, dropout=0.0):
    model = CNNAudioGRU(num_classes=CLASSES, dropout=dropout, **NARROW)
    model.load_state_dict(from_jax_variables(params, stats))
    return model


def test_batchnorm_running_stats_match_flax(rng):
    """One train-mode forward: the running statistics equal Flax's mutated
    batch_stats (biased variance, momentum 0.9 kept) within 1e-6; torch's
    nn.BatchNorm2d would store the unbiased variance, n / (n - 1) off."""
    model, params, stats = _flax_narrow()
    x = rng.standard_normal((2, 64, T_IN)).astype(np.float32)
    _, mutated = model.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    port = _port_narrow(params, stats).train()
    port(torch.from_numpy(x))
    for i in (1, 2, 3):
        want = mutated["batch_stats"][f"bn{i}"]
        bn = getattr(port, f"bn{i}")
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(want["mean"]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(want["var"]), rtol=0,
                                   atol=1e-6)
        assert int(bn.num_batches_tracked) == 1


def test_batchnorm_keeps_reference_state_dict_names():
    names = set(CNNAudioGRU(num_classes=31).state_dict())
    for i in (1, 2, 3):
        assert {f"bn{i}.{k}" for k in ("weight", "bias", "running_mean",
                                       "running_var", "num_batches_tracked")
                } <= names


@pytest.mark.parametrize("kind", ["constant", "warmup", "cosine"])
def test_optimizer_matches_optax_chain(rng, kind):
    """N updates on the same gradients (clipping active on most of them):
    the port's Adam chain against the JAX package's optax chain, 1e-6."""
    steps = 12
    sched = {"constant": dict(), "warmup": dict(warmup_steps=4),
             "cosine": dict(warmup_steps=3, schedule="cosine",
                            total_steps=10)}[kind]
    shapes = [(7, 5), (5,), (3, 2, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * rng.choice([0.1, 3.0]))
              .astype(np.float32) for s in shapes] for _ in range(steps)]
    kw = dict(lr=1e-2, weight_decay=1e-2, grad_clip=1.0, **sched)

    tx = ref_state.create_optimizer(**kw)
    j_params = [jnp.asarray(p) for p in init]
    j_state = tx.init(j_params)
    torch_params = [torch.nn.Parameter(torch.from_numpy(p.copy()))
                    for p in init]
    opt = create_optimizer(torch_params, **kw)
    for g in grads:
        updates, j_state = tx.update([jnp.asarray(x) for x in g], j_state,
                                     j_params)
        j_params = [p + u for p, u in zip(j_params, updates)]
        for p, x in zip(torch_params, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    for got, want in zip(torch_params, j_params):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_optimizer_from_config_matches_jax(path):
    """Every shipped config: the optimizer the port builds from it runs the
    JAX one's whole schedule (total = epochs x ceil(n_train / batch)
    updates) to the same parameters, 1e-6."""
    cfg = load_config(path)
    ref_cfg = ref_load_config(path)
    n_train = cfg.train.batch_size * max(1, -(-(cfg.train.warmup_steps + 8)
                                              // cfg.train.epochs))
    total = cfg.train.epochs * -(-n_train // cfg.train.batch_size)
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal(6).astype(np.float32)
    tx = ref_state.optimizer_from_config(ref_cfg, n_train)
    j_p = jnp.asarray(p0)
    j_state = tx.init(j_p)
    update = jax.jit(tx.update)
    t_p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = optimizer_from_config(cfg, [t_p], n_train)
    for _ in range(total):
        g = rng.standard_normal(6).astype(np.float32)
        u, j_state = update(jnp.asarray(g), j_state, j_p)
        j_p = j_p + u
        t_p.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(t_p.detach().numpy(), np.asarray(j_p),
                               rtol=0, atol=1e-6)


def test_config_is_the_jax_packages(tmp_path):
    """The port reads configs with its own copy of the JAX package's schema
    and loader (it imports nothing of that package): equal sections on
    every config, the same validation errors."""
    import dataclasses

    from speech_intent_recognizer_tpu.config import schema as ref_schema
    from speech_intent_recognizer_tpu_torch.config import ConfigError

    assert Config is not RefConfig
    assert Config.__module__.startswith("speech_intent_recognizer_tpu_torch.")
    for path in CONFIGS:
        assert load_config(path).to_dict() == ref_load_config(path).to_dict()
        assert dataclasses.asdict(load_audio_config(path)) == \
            dataclasses.asdict(ref_load_config(path).audio)
    bad = tmp_path / "bad.yaml"
    bad.write_text("no_such_key: 1\n")
    with pytest.raises(ConfigError):
        load_config(str(bad))
    with pytest.raises(ref_schema.ConfigError):
        ref_load_config(str(bad))


def test_spec_augment_identity_and_bounds():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((64, 64, 200)) + 5.0  # no natural zeros
    assert torch.equal(spec_augment(x, g, augment_prob=0.0), x)
    y = spec_augment(x, g, augment_prob=1.0, time_mask_param=20,
                     freq_mask_param=10)
    masked = y == 0
    assert ((y == x) | masked).all()
    t_masked = masked.all(dim=1)  # (B, T) whole time columns
    f_masked = masked.all(dim=2)  # (B, M) whole mel rows
    assert ((masked == (t_masked[:, None, :] | f_masked[:, :, None]))).all()
    for row, limit in ((t_masked, 20), (f_masked, 10)):
        for r in row:
            idx = torch.nonzero(r).flatten()
            if len(idx):  # one contiguous run, narrower than the param
                assert len(idx) <= limit  # width < limit, any start
                assert int(idx[-1] - idx[0]) + 1 == len(idx)
    assert t_masked.any() and f_masked.any()


def test_mixup_weights_dominant_sample():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((256, 4, 8))
    y = torch.nn.functional.one_hot(torch.arange(256) % 5, 5).float()
    mx, my = mixup(x, y, g, alpha=0.2)
    lam = my.max(dim=1).values
    assert (lam >= 0.5 - 1e-6).all() and (lam <= 1.0 + 1e-6).all()
    assert torch.allclose(my.sum(dim=1), torch.ones(256))
    assert float(lam.mean()) > 0.75  # Beta(0.2, 0.2) folded: mostly near 1


@pytest.mark.parametrize("n,bs", [(30, 8), (32, 8), (5, 5), (7, 1)])
def test_batches_cover_every_item_once(n, bs):
    g = torch.Generator().manual_seed(n)
    for idx, w in (pad_permutation(g, n, bs, "cpu"),
                   sequential_batches(n, bs)):
        assert idx.shape == w.shape == (-(-n // bs), bs)
        real = idx.flatten()[w.flatten() > 0]
        assert sorted(real.tolist()) == list(range(n))
        assert (idx >= 0).all() and (idx < n).all()


def _parity_cfg(**over):
    # lr of tests/test_train_parity.py: Adam's first updates are about
    # lr * sign(g), so a gradient within fp32 summation noise of zero (whose
    # sign depends on the reduction order, i.e. the thread count) moves its
    # weight by +-lr; at 5e-5 that stays far below the 1e-4 logit bar
    raw = {"num_labels": CLASSES, "epochs": 3, "batch_size": 8, "lr": 5e-5,
           "weight_decay": 1e-4, "grad_clip": 1.0, "bf16": False,
           "use_augmentation": False, "use_mixup": False, "dropout": 0.0}
    raw.update(over)
    return raw


def test_trainer_matches_jax_trainer_step_for_step(rng):
    """The port's train_epoch against the JAX epoch_fn on identical
    (perm, weights) — 30 samples in batches of 8, the last padded with
    weight 0 — one step per call: per-step losses and the final eval
    logits (and so the BatchNorm statistics) within 1e-4."""
    n = 30
    feats = rng.standard_normal((n, 64, T_IN)).astype(np.float32)
    labels = rng.integers(0, CLASSES, n).astype(np.int32)
    held = rng.standard_normal((4, 64, T_IN)).astype(np.float32)
    model, params, stats = _flax_narrow()
    raw = _parity_cfg()

    tx = ref_state.create_optimizer(lr=raw["lr"], weight_decay=1e-4,
                                    grad_clip=1.0)
    j_state = ref_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params), tx=tx)
    j_trainer = ref_loop.Trainer(model, RefConfig.from_dict(raw), tx=tx,
                                 num_classes=CLASSES)
    epoch_fn = j_trainer._build_epoch_fn()

    port = _port_narrow(params, stats)
    trainer = Trainer(port, Config.from_dict(raw), num_classes=CLASSES)
    perm, weights = pad_permutation(torch.Generator().manual_seed(3), n, 8,
                                    "cpu")
    gen = torch.Generator().manual_seed(0)
    t_feats, t_labels = torch.from_numpy(feats), torch.from_numpy(labels)
    t_labels = t_labels.long()
    for s in range(perm.shape[0]):
        j_state, m = epoch_fn(j_state, jnp.asarray(feats),
                              jnp.asarray(labels),
                              jnp.asarray(perm[s:s + 1].numpy(), jnp.int32),
                              jnp.asarray(weights[s:s + 1].numpy()),
                              jax.random.key(0))
        got = trainer.train_epoch(t_feats, t_labels, perm[s:s + 1],
                                  weights[s:s + 1], gen)
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {s}")
    want = np.asarray(model.apply({"params": j_state.params,
                                   "batch_stats": j_state.batch_stats},
                                  jnp.asarray(held), train=False))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(held)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _tiny_data(rng, n=24, n_val=8):
    feats = torch.from_numpy(rng.standard_normal((n, 64, T_IN))
                             .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, CLASSES, n))
    v_feats = torch.from_numpy(rng.standard_normal((n_val, 64, T_IN))
                               .astype(np.float32))
    v_labels = torch.from_numpy(rng.integers(0, CLASSES, n_val))
    return feats, labels, v_feats, v_labels


def _fresh(raw, seed=0):
    model = CNNAudioGRU(num_classes=CLASSES, dropout=raw.get("dropout", 0.5),
                        **NARROW)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    cfg = Config.from_dict(raw)
    return model, cfg


def test_early_stopping_and_best_model_export(rng, tmp_path):
    """A model that cannot change (lr ~ 0) and never predicts the val
    label: val accuracy 0 never improves, yet a best model is exported
    once; with patience 2 training stops after epoch 2."""
    raw = _parity_cfg(lr=1e-12, epochs=5, early_stop_patience=2)
    model, cfg = _fresh(raw)
    feats, labels, v_feats, _ = _tiny_data(rng)
    model.eval()
    with torch.no_grad():
        pred = model(v_feats).argmax(-1)
    v_labels = (pred + 1) % CLASSES
    ckpt = Checkpointer(str(tmp_path), model_meta={"num_classes": CLASSES})
    result = Trainer(model, cfg, num_classes=CLASSES).fit(
        feats, labels, v_feats, v_labels, checkpointer=ckpt)
    assert result.epochs_run == 2 and result.stopped_early
    assert result.best_val_acc == 0.0 and result.best_state is not None
    meta = json.loads((tmp_path / "best_model.json").read_text())
    assert meta["epoch"] == 1 and meta["num_classes"] == CLASSES
    best = torch.load(tmp_path / "best_model.pt", weights_only=True)
    assert set(best) == set(model.state_dict())
    assert ckpt.latest_epoch() == 2


def test_resume_continues_exactly(rng, tmp_path):
    """Three epochs straight equal two epochs, a fresh process-like
    restore (new model and optimizer) and a third, bit for bit — with
    SpecAugment, mixup and dropout all drawing from the epoch generators,
    and the state files beyond ``keep`` deleted."""
    raw = _parity_cfg(epochs=3, dropout=0.3, use_augmentation=True,
                      use_mixup=True, lr=1e-3)
    data = _tiny_data(rng)

    model_a, cfg = _fresh(raw)
    Trainer(model_a, cfg, num_classes=CLASSES).fit(
        *data, checkpointer=Checkpointer(str(tmp_path / "a")))

    raw2 = dict(raw, epochs=2)
    model_b, cfg2 = _fresh(raw2)
    Trainer(model_b, cfg2, num_classes=CLASSES).fit(
        *data, checkpointer=Checkpointer(str(tmp_path / "b"), keep=2))
    model_c, cfg3 = _fresh(raw, seed=99)  # restore overwrites everything
    trainer = Trainer(model_c, cfg3, num_classes=CLASSES)
    ckpt = Checkpointer(str(tmp_path / "b"), keep=2)
    book = ckpt.restore_state(model_c, trainer.optimizer)
    assert book["epoch"] == 2
    trainer.fit(*data, checkpointer=ckpt, start_epoch=book["epoch"],
                best_val_acc=book["best_val_acc"],
                no_improve=book["no_improve"])
    for (name, a), c in zip(model_a.state_dict().items(),
                            model_c.state_dict().values()):
        assert torch.equal(a, c), name
    assert sorted(os.listdir(tmp_path / "b" / "state")) == [
        "epoch_000002.pt", "epoch_000003.pt"]


def test_unported_options_raise(tmp_path):
    """The options the port does not run raise: ``cli.train`` refuses
    ``model_name: wav2vec`` and names ``cli.train_wav2vec``, and
    ``model_axis > 1`` naming ROADMAP.md; the multi-process options are
    accepted.  The wav2vec evaluation is ported and evaluates a tiny
    checkpoint, and ``--data_parallel`` over two CPU shards gives the same
    report."""
    from speech_intent_recognizer_tpu_torch.cli.evaluate import (
        evaluate_from_config)
    from speech_intent_recognizer_tpu_torch.cli.train import check_supported
    from speech_intent_recognizer_tpu_torch.data.audio_io import save_wav
    from speech_intent_recognizer_tpu_torch.models.wav2vec import (
        Wav2VecIntent, small_wav2vec_config)

    # waveform-resident training is ported: both construct
    trainer = Trainer(CNNAudioGRU(num_classes=5, **NARROW),
                      Config.from_dict({}), from_waveforms=True)
    assert trainer.from_waveforms
    check_supported(Config.from_dict({"train_on_waveforms": True}))
    with pytest.raises(NotImplementedError, match="cli.train_wav2vec"):
        check_supported(Config.from_dict({"model_name": "wav2vec"}))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        check_supported(Config.from_dict({"model_axis": 2}))
    for raw in ({"num_processes": 2}, {"data_axis": 4},
                {"coordinator_address": "localhost:1"}, {}):
        check_supported(Config.from_dict(raw))
    cfg = Config.from_dict({"max_duration": 0.5, "data_axis": 2,
                            "save_path": str(tmp_path / "ckpt")})
    model = Wav2VecIntent(small_wav2vec_config(32, 1), 2)
    model.reset_parameters(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "w2v.pt")
    rows = []
    for i in range(3):
        wav = str(tmp_path / f"{i}.wav")
        save_wav(wav, np.sin(np.arange(4000) * (0.05 + 0.02 * i))
                 .astype(np.float32), 16000)
        rows.append(f"{wav},{'ab'[i % 2]}\n")
    (tmp_path / "m.csv").write_text("path,label\n" + "".join(rows))
    (tmp_path / "lm.json").write_text(json.dumps({"a": 0, "b": 1}))
    result = evaluate_from_config(
        cfg, str(tmp_path / "m.csv"), str(tmp_path / "lm.json"),
        str(tmp_path / "w2v.pt"), model_type="wav2vec", device="cpu")
    assert result["confusion_matrix"].sum() == 3
    assert (tmp_path / "ckpt" / "evaluation_results_wav2vec"
            / "classification_report.txt").exists()
    dp = evaluate_from_config(
        cfg, str(tmp_path / "m.csv"), str(tmp_path / "lm.json"),
        str(tmp_path / "w2v.pt"), model_type="wav2vec", device="cpu",
        results_dir=str(tmp_path / "dp"), data_parallel=True)
    assert np.array_equal(dp["confusion_matrix"], result["confusion_matrix"])
    assert dp["accuracy"] == result["accuracy"]


def test_cli_train_then_evaluate_match_jax_evaluate(tmp_path):
    """cli.precompute_features, cli.train and cli.evaluate on a tiny WAV
    corpus (narrow model, CPU); the evaluation's accuracy and predictions
    equal JAX ``evaluate_dataset`` on the same weights and cached
    features."""
    from speech_intent_recognizer_tpu.data.cache import (
        load_cache as ref_load_cache)
    from speech_intent_recognizer_tpu.evaluation.evaluate import (
        evaluate_dataset as ref_evaluate)
    from speech_intent_recognizer_tpu_torch.cli import evaluate as cli_eval
    from speech_intent_recognizer_tpu_torch.cli import (
        precompute_features as cli_pre)
    from speech_intent_recognizer_tpu_torch.cli import train as cli_train
    from speech_intent_recognizer_tpu_torch.data.audio_io import save_wav
    from speech_intent_recognizer_tpu_torch.data.labelmap import (
        save_label_map)

    rng = np.random.default_rng(5)
    names = [f"tone_{k}" for k in range(CLASSES)]
    csvs = {}
    for split, n in (("train", 20), ("valid", 10), ("test", 10)):
        rows = []
        for i in range(n):
            k = i % CLASSES
            t = np.arange(int(rng.integers(8000, 20000))) / 16000
            x = 0.3 * np.sin(2 * np.pi * 300 * (k + 1) * t) \
                + 0.05 * rng.standard_normal(t.size)
            path = tmp_path / split / f"{i:03d}.wav"
            save_wav(str(path), x.astype(np.float32), 16000)
            rows.append(f"{path},{names[k]}\n")
        csvs[split] = tmp_path / f"{split}.csv"
        csvs[split].write_text("path,label\n" + "".join(rows))
    label_map = tmp_path / "label_map.json"
    save_label_map({k: i for i, k in enumerate(names)}, str(label_map))
    cache, ckpt = tmp_path / "cache", tmp_path / "ckpt"
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(
        f"data:\n  cache_dir: {cache}\n  precompute_batch_size: 8\n"
        f"model:\n  num_labels: {CLASSES}\n  conv_channels: [8, 16, 16]\n"
        f"  gru_hidden: 32\ntrain:\n  epochs: 2\n  batch_size: 8\n"
        f"  lr: 0.003\n  bf16: false\n  save_path: {ckpt}\n")
    common = ["--config", str(cfg_path), "--device", "cpu"]
    cli_pre.main(["--train_csv", str(csvs["train"]), "--valid_csv",
                  str(csvs["valid"]), "--test_csv", str(csvs["test"]),
                  "--output_dir", str(cache), "--label_map", str(label_map),
                  "--config", str(cfg_path), "--device", "cpu"])
    assert json.loads((cache / "cache_info.json").read_text()).keys() == {
        "train_features", "valid_features", "test_features"}
    result = cli_train.main(common + ["--train_csv", str(csvs["train"]),
                                      "--val_csv", str(csvs["valid"]),
                                      "--label_map", str(label_map)])
    assert result.epochs_run == 2
    assert (ckpt / "training_history.json").exists()
    got = cli_eval.main(common + ["--test_csv", str(csvs["test"]),
                                  "--label_map", str(label_map),
                                  "--model", str(ckpt / "best_model.pt")])
    report = (ckpt / "evaluation_results" / "classification_report.txt")
    assert report.read_text().startswith(
        f"Test Accuracy: {got['accuracy']:.4f}")
    assert (ckpt / "evaluation_results" / "confusion_matrix.npy").exists()

    params, stats = convert_torch_state_dict({
        k: v.numpy() for k, v in torch.load(
            ckpt / "best_model.pt", weights_only=True).items()})
    feats, labels, _ = ref_load_cache(str(cache / "test_features.npz"))
    want = ref_evaluate(
        ref_model.CNNAudioGRU(num_classes=CLASSES, **NARROW),
        {"params": params, "batch_stats": stats}, jnp.asarray(feats),
        labels, json.loads(label_map.read_text()), batch_size=16)
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
