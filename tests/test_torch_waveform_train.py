"""Waveform-resident training in the port against the JAX package on the
same numpy inputs: the in-step featurization, the trainer step for step,
waveform mode against feature mode, augmentation that still learns, and an
exact resume with augmentation on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu.config.schema import Config as RefConfig
from speech_intent_recognizer_tpu.models import cnn_gru as ref_model
from speech_intent_recognizer_tpu.train import loop as ref_loop
from speech_intent_recognizer_tpu.train import state as ref_state
from speech_intent_recognizer_tpu_torch.config import Config
from speech_intent_recognizer_tpu_torch.convert.jax_bridge import (
    from_jax_variables)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    log_mel_frontend, make_frontend_params)
from speech_intent_recognizer_tpu_torch.train.checkpoint import Checkpointer
from speech_intent_recognizer_tpu_torch.train.loop import (
    Trainer, pad_permutation)

# the narrow model of tests/test_torch_train.py
NARROW = dict(conv_channels=(8, 16, 16), gru_hidden=32)
CLASSES = 3
# the bar JAX holds its K3 kernel to against its XLA front-end
# (tests/test_pallas_frontend.py:62); the port's plain front-end is the
# float32 FFT route, JAX's XLA one runs its DFT at Precision.HIGH
K3_BAR = 2e-3
# per-step losses and final logits, port vs JAX trainer in waveform mode:
# the bar of the feature-cache test (tests/test_torch_train.py), kept
# although the two front-ends' features differ by up to ~1e-4 here;
# measured on the CPU: losses within 7.2e-7, logits 1.1e-7
STEP_BAR = 1e-4
WIDTH = 24000  # 1.5 s buffers: 47 frames, padded to 200 by the front-end


def toy_waves(rng, n, width=WIDTH, classes=CLASSES):
    """Class-separable tones of several lengths in int16 rows, zero beyond
    each length (tests/test_train.py's toy corpus, shorter)."""
    labels = (np.arange(n) % classes).astype(np.int64)
    waves = np.zeros((n, width), np.int16)
    lengths = np.zeros(n, np.int32)
    for i, c in enumerate(labels):
        m = int(width * (0.5 + 0.1 * (i % 6)))
        t = np.arange(m, dtype=np.float32) / 16000
        x = 0.4 * np.sin(2 * np.pi * (300.0 + 400.0 * c) * t)
        x += 0.02 * rng.standard_normal(m).astype(np.float32)
        waves[i, :m] = np.clip(np.round(x * 32768.0), -32768, 32767)
        lengths[i] = m
    return waves, lengths, labels


def _raw(**over):
    raw = {"num_labels": CLASSES, "epochs": 2, "batch_size": 8, "lr": 5e-5,
           "weight_decay": 1e-4, "grad_clip": 1.0, "bf16": False,
           "use_augmentation": False, "use_mixup": False, "dropout": 0.0,
           "train_on_waveforms": True}
    raw.update(over)
    return raw


def _flax_narrow(seed=0):
    model = ref_model.CNNAudioGRU(num_classes=CLASSES, dropout=0.0, **NARROW)
    variables = ref_model.init_model(model, jax.random.key(seed),
                                     input_shape=(1, 64, 200))
    return (model, jax.tree.map(np.asarray, variables["params"]),
            jax.tree.map(np.asarray, variables["batch_stats"]))


def _port_fresh(raw, seed=0):
    model = CNNAudioGRU(num_classes=CLASSES, dropout=raw["dropout"],
                        **NARROW)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model, Config.from_dict(raw)


@pytest.mark.parametrize("backend", ["picked", "xla"])
def test_featurize_matches_jax_trainer(backend):
    """Port ``Trainer._featurize`` (the plain front-end on the CPU) on
    gathered int16 rows, among them a silent row of length 0 (clamped to 1
    on both sides) and one of length 1, against JAX ``Trainer._featurize``
    with the backend its trainer picks on the CPU (the Pallas kernel,
    interpret mode) and with XLA.  Rows are zero beyond their lengths, the
    waveform cache's precondition: past it the JAX front-end adds its
    right reflection onto what the row holds, the port writes it.  The
    silent row normalizes 0 / eps: the port and the Pallas kernel give 0,
    JAX's XLA path -0.269 (its mean of the 64 x -100 dB rounds off -100),
    so against XLA it is left out."""
    rng = np.random.default_rng(3)
    waves, lengths, _ = toy_waves(rng, 8)
    waves[2], lengths[2] = 0, 0
    waves[6, 1:], lengths[6] = 0, 1
    idx = np.array([5, 1, 6, 2], np.int64)
    j_model, _, _ = _flax_narrow()
    j_trainer = ref_loop.Trainer(j_model, RefConfig.from_dict(_raw()),
                                 num_classes=CLASSES, from_waveforms=True)
    if backend == "xla":
        j_trainer._frontend_backend = "xla"
    x = waves[idx].astype(np.float32) * (1.0 / 32768.0)
    want = np.asarray(jax.jit(j_trainer._featurize)(
        jnp.asarray(x), jnp.asarray(lengths[idx])))

    trainer = Trainer(CNNAudioGRU(num_classes=CLASSES, **NARROW),
                      Config.from_dict(_raw()), num_classes=CLASSES,
                      from_waveforms=True)
    t_waves = torch.from_numpy(waves)
    t_len = torch.from_numpy(lengths)
    got = trainer._inputs(t_waves, t_len, torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (4, 64, 200)
    rows = [0, 1, 2] if backend == "xla" else [0, 1, 2, 3]
    np.testing.assert_allclose(got.numpy()[rows], want[rows], rtol=0,
                               atol=K3_BAR)
    assert not got[3].any()
    direct = log_mel_frontend(torch.from_numpy(x),
                              torch.from_numpy(lengths[idx]).clamp(min=1),
                              make_frontend_params())
    assert torch.equal(got, direct)


def test_waveform_trainer_matches_jax_step_for_step():
    """Port ``train_epoch(..., lengths=)`` against JAX ``epoch_fn(...,
    lengths=)`` on identical (perm, weights), 20 int16 rows in batches of
    8 (the last padded at weight 0), augmentation and dropout off, one step
    per call: per-step losses and the final eval logits within STEP_BAR.
    The JAX trainer's front-end runs its XLA backend here (its Pallas
    kernel in interpret mode would add a compile; the featurize test holds
    the port to both)."""
    rng = np.random.default_rng(4)
    n = 20
    waves, lengths, labels = toy_waves(rng, n)
    held_w, held_ln, _ = toy_waves(np.random.default_rng(5), 4)
    model, params, stats = _flax_narrow()
    raw = _raw()
    tx = ref_state.create_optimizer(lr=raw["lr"], weight_decay=1e-4,
                                    grad_clip=1.0)
    j_state = ref_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params), tx=tx)
    j_trainer = ref_loop.Trainer(model, RefConfig.from_dict(raw), tx=tx,
                                 num_classes=CLASSES, from_waveforms=True)
    j_trainer._frontend_backend = "xla"
    epoch_fn = j_trainer._build_epoch_fn()

    port = CNNAudioGRU(num_classes=CLASSES, dropout=0.0, **NARROW)
    port.load_state_dict(from_jax_variables(params, stats))
    trainer = Trainer(port, Config.from_dict(raw), num_classes=CLASSES,
                      from_waveforms=True)
    perm, weights = pad_permutation(torch.Generator().manual_seed(3), n, 8,
                                    "cpu")
    gen = torch.Generator().manual_seed(0)
    t_waves, t_len = torch.from_numpy(waves), torch.from_numpy(lengths)
    t_labels = torch.from_numpy(labels)
    for s in range(perm.shape[0]):
        j_state, m = epoch_fn(j_state, jnp.asarray(waves),
                              jnp.asarray(labels, jnp.int32),
                              jnp.asarray(perm[s:s + 1].numpy(), jnp.int32),
                              jnp.asarray(weights[s:s + 1].numpy()),
                              jax.random.key(0), lengths=jnp.asarray(lengths))
        got = trainer.train_epoch(t_waves, t_labels, perm[s:s + 1],
                                  weights[s:s + 1], gen, lengths=t_len)
        np.testing.assert_allclose(got["loss"], float(m["loss"]),
                                   rtol=STEP_BAR, atol=STEP_BAR,
                                   err_msg=f"step {s}")
    feats = j_trainer._featurize(
        jnp.asarray(held_w.astype(np.float32) / 32768.0),
        jnp.asarray(held_ln))
    want = np.asarray(model.apply({"params": j_state.params,
                                   "batch_stats": j_state.batch_stats},
                                  feats, train=False))
    port.eval()
    with torch.no_grad():
        got = port(trainer._inputs(torch.from_numpy(held_w),
                                   torch.from_numpy(held_ln),
                                   torch.arange(4))).numpy()
    np.testing.assert_allclose(got, want, rtol=STEP_BAR, atol=STEP_BAR)


def test_waveform_mode_matches_feature_mode():
    """Augmentation off, the same seeded model: training on int16
    waveforms (featurized in each step) tracks training on the features of
    the same waveforms (the port's counterpart of JAX
    tests/test_train.py:150-191): equal accuracies, losses within rtol
    2e-2."""
    rng = np.random.default_rng(3)
    waves, lengths, labels = toy_waves(rng, 16)
    raw = _raw(lr=2e-3)
    t_waves, t_len = torch.from_numpy(waves), torch.from_numpy(lengths)
    t_labels = torch.from_numpy(labels)
    feats = log_mel_frontend(t_waves.float() / 32768.0, t_len.clamp(min=1),
                             make_frontend_params())
    results = {}
    for mode in ("features", "waveforms"):
        model, cfg = _port_fresh(raw)
        if mode == "waveforms":
            results[mode] = Trainer(model, cfg, num_classes=CLASSES,
                                    from_waveforms=True).fit(
                t_waves, t_labels, t_waves, t_labels, log=lambda m: None,
                train_lengths=t_len, val_lengths=t_len)
        else:
            results[mode] = Trainer(model, cfg, num_classes=CLASSES).fit(
                feats, t_labels, feats, t_labels, log=lambda m: None)
    for ef, ew in zip(results["features"].history,
                      results["waveforms"].history):
        np.testing.assert_allclose(ef["train_loss"], ew["train_loss"],
                                   rtol=2e-2)
        np.testing.assert_allclose(ef["val_loss"], ew["val_loss"], rtol=2e-2)
        assert ef["train_acc"] == ew["train_acc"]
        assert ef["val_acc"] == ew["val_acc"]


def test_waveform_augment_trains_and_learns():
    """Waveform augmentation live inside the step (with SpecAugment): three
    tone classes, four epochs, the loss falls and val accuracy > 0.5 (JAX
    tests/test_train.py:193-212)."""
    rng = np.random.default_rng(4)
    waves, lengths, labels = toy_waves(rng, 30)
    raw = _raw(epochs=4, lr=2e-3, use_augmentation=True,
               use_waveform_augment=True, augment_prob=0.7,
               early_stop_patience=5)
    model, cfg = _port_fresh(raw, seed=1)
    t_waves, t_len = torch.from_numpy(waves), torch.from_numpy(lengths)
    t_labels = torch.from_numpy(labels)
    res = Trainer(model, cfg, num_classes=CLASSES, from_waveforms=True).fit(
        t_waves, t_labels, t_waves, t_labels, log=lambda m: None,
        train_lengths=t_len, val_lengths=t_len)
    assert res.history[-1]["train_loss"] < res.history[0]["train_loss"]
    assert res.best_val_acc > 0.5


def test_waveform_resume_continues_exactly(tmp_path):
    """Waveform mode with waveform augmentation, SpecAugment, mixup and
    dropout on: three epochs straight equal two epochs, a restore into a
    new model and optimizer, and a third, bit for bit."""
    rng = np.random.default_rng(6)
    waves, lengths, labels = toy_waves(rng, 12)
    v_waves, v_len, v_labels = toy_waves(np.random.default_rng(7), 6)
    data = (torch.from_numpy(waves), torch.from_numpy(labels),
            torch.from_numpy(v_waves), torch.from_numpy(v_labels))
    lens = dict(train_lengths=torch.from_numpy(lengths),
                val_lengths=torch.from_numpy(v_len))
    raw = _raw(epochs=3, dropout=0.3, use_augmentation=True, use_mixup=True,
               use_waveform_augment=True, augment_prob=1.0, lr=1e-3)

    model_a, cfg = _port_fresh(raw)
    Trainer(model_a, cfg, num_classes=CLASSES, from_waveforms=True).fit(
        *data, checkpointer=Checkpointer(str(tmp_path / "a")), **lens)
    model_b, cfg2 = _port_fresh(dict(raw, epochs=2))
    Trainer(model_b, cfg2, num_classes=CLASSES, from_waveforms=True).fit(
        *data, checkpointer=Checkpointer(str(tmp_path / "b")), **lens)
    model_c, cfg3 = _port_fresh(raw, seed=99)  # restore overwrites all
    trainer = Trainer(model_c, cfg3, num_classes=CLASSES,
                      from_waveforms=True)
    ckpt = Checkpointer(str(tmp_path / "b"))
    book = ckpt.restore_state(model_c, trainer.optimizer)
    assert book["epoch"] == 2
    trainer.fit(*data, checkpointer=ckpt, start_epoch=book["epoch"],
                best_val_acc=book["best_val_acc"],
                no_improve=book["no_improve"], **lens)
    for (name, a), c in zip(model_a.state_dict().items(),
                            model_c.state_dict().values()):
        assert torch.equal(a, c), name


def test_waveform_mode_needs_lengths():
    model, cfg = _port_fresh(_raw())
    trainer = Trainer(model, cfg, num_classes=CLASSES, from_waveforms=True)
    w = torch.zeros((4, 2000), dtype=torch.int16)
    with pytest.raises(ValueError, match="lengths"):
        trainer.evaluate(w, torch.zeros(4, dtype=torch.int64))
