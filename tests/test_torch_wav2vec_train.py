"""Fine-tuning the wav2vec model in the torch port against the JAX package:
waveform batching and the train-time noise, the optimizer chain (clip,
AdamW, the plateau transform, warmup-cosine, the frozen feature extractor)
against optax step for step, one trainer step against the JAX step, resume,
and the CLIs (train_wav2vec, test_model and evaluate with ``--model_type
wav2vec``) on a tiny WAV corpus on the CPU."""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# transformers imports TensorFlow when it finds it (~10 s here), which
# neither package's wav2vec code uses
os.environ.setdefault("USE_TF", "0")
import optax

transformers = pytest.importorskip("transformers")

from speech_intent_recognizer_tpu.models import wav2vec as jw  # noqa: E402
from speech_intent_recognizer_tpu.train import (  # noqa: E402
    wav2vec_trainer as jt)

from speech_intent_recognizer_tpu_torch.convert.wav2vec_import import (  # noqa
    from_jax_params)
from speech_intent_recognizer_tpu_torch.data import (  # noqa: E402
    wav2vec_data as wd)
from speech_intent_recognizer_tpu_torch.data.audio_io import (  # noqa: E402
    save_wav)
from speech_intent_recognizer_tpu_torch.models import wav2vec as pw  # noqa
from speech_intent_recognizer_tpu_torch.train import (  # noqa: E402
    wav2vec_trainer as pt)
from speech_intent_recognizer_tpu_torch.train.checkpoint import (  # noqa
    Checkpointer)

L = 4000
ZERO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0,
                    activation_dropout=0.0, feat_proj_dropout=0.0,
                    layerdrop=0.0)


def _wavs(d, n, seed=0, lengths=(2000, 6000)):
    """n seeded WAVs (tones + noise, 3 classes), lengths in ``lengths``."""
    rng = np.random.default_rng(seed)
    paths = []
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        m = int(rng.integers(*lengths))
        t = np.arange(m) / 16000
        x = (0.3 * np.sin(2 * np.pi * (300 + 200 * (i % 3)) * t)
             + 0.05 * rng.standard_normal(m)).astype(np.float32)
        p = os.path.join(str(d), f"{i:02d}.wav")
        save_wav(p, x, 16000)
        paths.append(p)
    return paths


# -------------------------------------------------------------------- data


def test_batch_waveforms_matches_jax(tmp_path):
    """Decoded rows, masks and ``ok`` equal the JAX function's, with a
    file that does not decode (a zero row, a 1-sample mask, ok false) and
    rows longer than ``max_length`` (cut)."""
    from speech_intent_recognizer_tpu.data.wav2vec_data import (
        batch_waveforms as jax_batch)

    paths = _wavs(tmp_path, 3)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF not audio")
    paths.insert(1, str(bad))
    got = wd.batch_waveforms(paths, max_length=L)
    want = jax_batch(paths, max_length=L)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert list(got[2]) == [True, False, True, True]
    assert got[1][1].sum() == 1 and not got[0][1].any()


def test_train_noise_matches_jax():
    """The noise applied to the JAX function's own draws equals JAX's
    ``add_train_noise`` (1e-7)."""
    from speech_intent_recognizer_tpu.data.wav2vec_data import (
        add_train_noise)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 500)).astype(np.float32)
    mask = (np.arange(500)[None] < np.array([[500], [200], [1], [0]])
            ).astype(np.int32)
    key = jax.random.key(3)
    want = add_train_noise(jnp.asarray(x), jnp.asarray(mask), key, prob=0.5,
                           level=1e-2)
    k1, k2 = jax.random.split(key)
    gate_u = np.array(jax.random.uniform(k1, (4, 1)))
    normals = np.array(jax.random.normal(k2, (4, 500)))
    got = wd.apply_train_noise(torch.from_numpy(x), torch.from_numpy(mask),
                               torch.from_numpy(gate_u),
                               torch.from_numpy(normals), prob=0.5,
                               level=1e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)
    u, n = wd.draw_train_noise((4, 500), "cpu",
                               torch.Generator().manual_seed(0))
    assert u.shape == (4, 1) and n.shape == (4, 500)


# --------------------------------------------------------------- optimizer


SHAPES = {"wav2vec2": {"feature_extractor": {"w": (3, 4), "b": (4,)},
                       "encoder": {"w": (4, 4), "b": (4,)},
                       "masked_spec_embed": (4,)},
          "fc": {"w": (4, 2)}}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _plateau_states(state):
    from optax.contrib._reduce_on_plateau import ReduceLROnPlateauState

    return [s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda s: isinstance(s, ReduceLROnPlateauState))
        if isinstance(s, ReduceLROnPlateauState)]


@pytest.mark.parametrize("kind", ["plateau", "plateau_frozen",
                                  "warmup_cosine"])
def test_optimizer_matches_optax(kind):
    """The port's chain and the JAX package's optax chain over 8 steps of
    the same gradients (``masked_spec_embed``'s zero in JAX, none in torch:
    decayed all the same): ``value`` inf for 4 steps, then a repeated
    finite one; parameters within 1e-6 after every step, the plateau scale
    and counts equal; warmup-cosine across the end of warmup (3) and of
    decay (6)."""
    rng = np.random.default_rng(1)
    # weights of a network's magnitude (|w| < ~1.5): the optax and torch
    # forms of the decayed update (p - lr (u + wd p) against p (1 - lr wd)
    # - lr u) round apart by an ulp or so a step, 1e-6 is ~8 ulps at 1
    params = jax.tree.map(
        lambda s: (0.5 * rng.standard_normal(s)).astype(np.float32), SHAPES,
        is_leaf=lambda s: isinstance(s, tuple))
    frozen = kind == "plateau_frozen"
    warm = 3 if kind == "warmup_cosine" else 0
    tx = jt.create_wav2vec_optimizer(
        lr=0.01, grad_clip=1.0, warmup_steps=warm, decay_steps=6,
        freeze_mask=jw.feature_extractor_mask(params) if frozen else None)
    update = jax.jit(tx.update)
    state = tx.init(params)
    torch_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                    for k, v in _flat(params)}
    for name, p in torch_params.items():
        p.requires_grad_(not (frozen and "feature_extractor" in name))
    opt = pt.create_wav2vec_optimizer(torch_params.values(), lr=0.01,
                                      grad_clip=1.0, warmup_steps=warm,
                                      decay_steps=6)
    jparams = params
    for step in range(8):
        grads = jax.tree.map(
            lambda a: (3.0 * rng.standard_normal(a.shape)).astype(
                np.float32), params)
        grads["wav2vec2"]["masked_spec_embed"] = np.zeros(4, np.float32)
        value = np.inf if step < 4 else 0.7
        updates, state = update(grads, state, jparams,
                                value=jnp.asarray(value, jnp.float32))
        jparams = jax.tree.map(np.asarray,
                               optax.apply_updates(jparams, updates))
        opt.zero_grad()
        for name, g in _flat(grads):
            p = torch_params[name]
            if p.requires_grad and "masked_spec_embed" not in name:
                p.grad = torch.from_numpy(g.copy())
        opt.step(value)
        for name, want in _flat(jparams):
            np.testing.assert_allclose(
                torch_params[name].detach().numpy(), want, rtol=0,
                atol=1e-6, err_msg=f"{name} after step {step + 1}")
        ref = _plateau_states(state)
        if warm:
            assert not ref and opt.plateau is None
            continue
        (ref,) = ref
        assert opt.plateau.scale == float(ref.scale), step
        assert opt.plateau.plateau_count == int(ref.plateau_count)
        assert opt.plateau.best_value == float(ref.best_value)
    if not warm:
        # the reference's behaviour: the plateau check runs every call (4
        # steps of inf: 1, .5, .5, .25; 0.7 improves once, then two
        # repeats halve again)
        assert opt.plateau.scale == 0.125


def test_plateau_halves_every_second_step_as_the_reference():
    """``ReduceOnPlateau`` as optax's ``reduce_on_plateau`` (factor 0.5,
    patience 2) is called by the trainer, once a train step: ``inf`` (epoch
    1) never improves on ``inf``, and a repeated value never on itself, so
    the scale halves every second step (ROADMAP Queue 3, noted in the
    reference)."""
    tx = optax.contrib.reduce_on_plateau(factor=0.5, patience=2)
    update = jax.jit(tx.update)
    state = tx.init({"w": jnp.zeros(2)})
    mine = pt.ReduceOnPlateau(0.5, 2)
    scales = []
    for value in [np.inf] * 8 + [1.5] * 6:
        _, state = update({"w": jnp.ones(2)}, state,
                          value=jnp.asarray(value, jnp.float32))
        scales.append(mine.update(value))
        assert scales[-1] == float(state.scale)
    assert scales[:8] == [1, 0.5, 0.5, 0.25, 0.25, 0.125, 0.125, 0.0625]
    # 1.5 improves once on inf, then plateaus again
    assert scales[8:] == [0.0625, 0.0625, 0.03125, 0.03125, 0.015625,
                          0.015625]
    restored = pt.ReduceOnPlateau(0.5, 2)
    restored.load_state_dict(mine.state_dict())
    assert restored.state_dict() == mine.state_dict()


# ----------------------------------------------------------------- trainer


def test_trainer_step_matches_jax():
    """One train step of the reference recipe (feature extractor frozen,
    AdamW + plateau, clip 1.0; dropouts and LayerDrop 0) from the same
    weights and batch, the noise from JAX's own draws fed through the
    draw / apply split: loss within 1e-5 relative, every parameter within
    1e-5 after the step, the frozen ones unchanged."""
    jcfg = jw.small_wav2vec_base_config(hidden_size=32, num_layers=1)
    for k, v in ZERO_DROPOUT.items():
        setattr(jcfg, k, v)
    jmodel, _ = jw.create_wav2vec_intent(3, config=jcfg)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, L)),
        jnp.ones((1, L), jnp.int32)))(jax.random.key(0))["params"])
    tx = jt.create_wav2vec_optimizer(
        lr=1e-4, freeze_mask=jw.feature_extractor_mask(params))
    trainer = jt.Wav2VecTrainer(jmodel, tx, 3, max_length=L)
    step, _ = trainer._build()
    rng = np.random.default_rng(2)
    x = (0.1 * rng.standard_normal((4, L))).astype(np.float32)
    lengths = np.array([L, 3000, 1500, 30])
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    x *= mask
    y = np.array([0, 1, 2, 1])
    key = jax.random.key(9)
    new_params, _, loss, _ = step(params, tx.init(params), x, mask, y, key,
                                  jnp.asarray(jnp.inf))
    nrng, _ = jax.random.split(key)
    k1, k2 = jax.random.split(nrng)
    gate_u = np.array(jax.random.uniform(k1, (4, 1)))
    normals = np.array(jax.random.normal(k2, (4, L)))

    model = pw.Wav2VecIntent(pw.Wav2Vec2Config.from_dict(jcfg.to_dict()), 3)
    model.load_state_dict(from_jax_params(params))
    for p in pw.feature_extractor_params(model):
        p.requires_grad_(False)
    port = pt.Wav2VecTrainer(model, pt.create_wav2vec_optimizer(
        model.parameters(), lr=1e-4), 3, max_length=L)
    tx_, tm = torch.from_numpy(x), torch.from_numpy(mask)
    noisy = wd.apply_train_noise(tx_, tm, torch.from_numpy(gate_u),
                                 torch.from_numpy(normals))
    got_loss, _ = port.update(noisy, tm, torch.from_numpy(y))
    assert abs(float(got_loss) - float(loss)) <= 1e-5 * abs(float(loss))
    want = from_jax_params(jax.tree.map(np.asarray, new_params))
    before = from_jax_params(params)
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
        if "feature_extractor" in name:
            assert torch.equal(t, before[name]), name


def _tiny_model(seed=0):
    cfg = pw.small_wav2vec_config(hidden_size=32, num_layers=1)
    return pw.init_wav2vec(pw.Wav2VecIntent(cfg, 3), seed)


def _fit(tmp_path, paths, epochs, subdir):
    model = _tiny_model()
    for p in pw.feature_extractor_params(model):
        p.requires_grad_(False)
    trainer = pt.Wav2VecTrainer(model, pt.create_wav2vec_optimizer(
        model.parameters(), lr=1e-3), 3, max_length=L)
    labels = [i % 3 for i in range(len(paths))]
    result = trainer.fit(paths[:8], labels[:8], paths[8:], labels[8:],
                         epochs=epochs, batch_size=4, seed=0,
                         early_stop_patience=100,
                         checkpointer=Checkpointer(str(tmp_path / subdir)),
                         log=lambda m: None)
    return model, result


def test_resumed_run_matches_uninterrupted(tmp_path):
    """Two epochs equal one epoch plus a resumed one (dropout and LayerDrop
    on, drawn from the per-epoch generator), to 1e-6: the last epoch's
    losses and every weight; the best model reloaded on resume."""
    paths = _wavs(tmp_path / "wavs", 12)
    full_model, full = _fit(tmp_path, paths, 2, "full")
    _fit(tmp_path, paths, 1, "split")
    resumed_model, resumed = _fit(tmp_path, paths, 2, "split")
    assert [h["epoch"] for h in resumed["history"]] == [2]
    for key in ("train_loss", "val_loss", "val_acc"):
        assert abs(full["history"][-1][key]
                   - resumed["history"][-1][key]) <= 1e-6, key
    for (name, a), b in zip(full_model.state_dict().items(),
                            resumed_model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    assert resumed["best_state"] is not None
    assert resumed["best_val_acc"] == full["best_val_acc"]


def test_mesh_raises():
    """``mesh=`` runs: a mesh of one device in this process is the
    one-device trainer, bit for bit (dropout and LayerDrop on); a mesh of
    several devices in one process raises and names the one-process-per-
    device launch.  The multi-process mesh: tests/test_torch_distributed.py."""
    from speech_intent_recognizer_tpu_torch.parallel import create_mesh

    rng = np.random.default_rng(3)
    x = torch.from_numpy((0.1 * rng.standard_normal((4, L)))
                         .astype(np.float32))
    mask = torch.ones((4, L), dtype=torch.int32)
    y = torch.tensor([0, 1, 2, 1])
    runs = []
    for mesh in (None, create_mesh(devices=["cpu"])):
        model = _tiny_model()
        trainer = pt.Wav2VecTrainer(model, pt.create_wav2vec_optimizer(
            model.parameters(), lr=1e-3), 3, max_length=L, mesh=mesh)
        loss, _ = trainer.train_step(x, mask, y,
                                     torch.Generator().manual_seed(5))
        runs.append((float(loss), model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for name, t in runs[0][1].items():
        assert torch.equal(t, runs[1][1][name]), name
    with pytest.raises(ValueError, match="one process per device"):
        pt.Wav2VecTrainer(_tiny_model(), None, 3,
                          mesh=create_mesh(devices=["cpu", "cpu"]))


# -------------------------------------------------------------------- CLIs


def test_model_name_fallback_is_the_small_config(caplog):
    """A ``--model_name`` with no local checkpoint gives the small config
    (hidden 64, 2 layers), not wav2vec2-base, in both packages, with a
    warning that names it (ROADMAP Queue 3, noted in the reference)."""
    with caplog.at_level(logging.WARNING):
        model, pretrained = pw.create_wav2vec_intent(
            5, model_name="facebook/wav2vec2-base")
    assert pretrained is None
    assert model.config == pw.small_wav2vec_config()
    assert "small_wav2vec_config" in caplog.text
    jmodel, _ = jw.create_wav2vec_intent(5,
                                         model_name="facebook/wav2vec2-base")
    assert pw.Wav2Vec2Config.from_dict(jmodel.config.to_dict()) \
        == model.config


def test_cli_train_then_test_model_and_evaluate(tmp_path):
    """``cli.train_wav2vec --small --device cpu`` (6 WAVs, B=2, 1 epoch,
    ``max_duration`` 1.0), then ``cli.test_model`` and ``cli.evaluate``
    with ``--model_type wav2vec`` on what it saved."""
    from speech_intent_recognizer_tpu_torch.cli import evaluate as cli_eval
    from speech_intent_recognizer_tpu_torch.cli import test_model
    from speech_intent_recognizer_tpu_torch.cli.train_wav2vec import main

    paths = _wavs(tmp_path / "wavs", 6, lengths=(8000, 20000))
    names = ["up", "down", "left"]
    csv = tmp_path / "m.csv"
    csv.write_text("path,label\n" + "".join(
        f"{p},{names[i % 3]}\n" for i, p in enumerate(paths)))
    lm = tmp_path / "lm.json"
    lm.write_text(json.dumps({n: i for i, n in enumerate(names)}))
    cfg = tmp_path / "cfg.yaml"
    save = tmp_path / "ckpt"
    cfg.write_text(f"num_labels: 3\nmax_duration: 1.0\nsave_path: {save}\n")
    result = main(["--config", str(cfg), "--train_csv", str(csv),
                   "--val_csv", str(csv), "--label_map", str(lm), "--small",
                   "--epochs", "1", "--batch_size", "2", "--device", "cpu"])
    assert len(result["history"]) == 1
    assert np.isfinite(result["history"][0]["train_loss"])
    ckpt = save / "wav2vec_intent.pt"
    meta = json.loads((save / "wav2vec_intent.json").read_text())
    assert meta["model"] == "wav2vec" and meta["num_classes"] == 3
    assert pw.Wav2Vec2Config.from_dict(meta["wav2vec_config"]) \
        == pw.small_wav2vec_config()
    r = test_model.main(["--model_type", "wav2vec", "--model", str(ckpt),
                         "--label_map", str(lm), "--audio", paths[0],
                         "--config", str(cfg), "--device", "cpu"])
    assert r["predicted_label"] in names
    ev = cli_eval.main(["--model_type", "wav2vec", "--model_path", str(ckpt),
                        "--test_csv", str(csv), "--label_map", str(lm),
                        "--config", str(cfg), "--device", "cpu"])
    assert 0.0 <= ev["accuracy"] <= 1.0
    report = save / "evaluation_results_wav2vec" / "classification_report.txt"
    assert report.read_text().startswith(
        f"Test Accuracy: {ev['accuracy']:.4f}")


def test_fully_masked_row_overflows_gradients_as_the_reference():
    """A batch row of feature length <= 0 (shorter than the receptive
    field, or a failed decode's 1-sample mask) through a deep post-LN
    encoder at zero biases: the row stays exactly constant, each layer norm
    multiplies its gradient by ~1 / sqrt(eps), and it overflows fp32 (at
    wav2vec2-base's eps 1e-5 after 8 of its 12 layers; here eps 1e-12 and 3
    layers, 7 norms, keep the JAX compile short).  The JAX package's
    gradients are non-finite there, and so are the port's (ROADMAP Queue 3,
    noted in the reference)."""
    jcfg = jw.small_wav2vec_base_config(hidden_size=32, num_layers=3)
    for k, v in dict(ZERO_DROPOUT, layer_norm_eps=1e-12).items():
        setattr(jcfg, k, v)
    jmodel = jw.Wav2VecIntent(config=jcfg, num_classes=3)
    params = jax.jit(lambda k: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, L)),
        jnp.ones((1, L), jnp.int32)))(jax.random.key(0))["params"]
    x = np.zeros((2, L), np.float32)
    x[0] = 0.1 * np.random.default_rng(0).standard_normal(L)
    x[1, :30] = 0.1
    mask = (np.arange(L)[None] < np.array([[L], [30]])).astype(np.int32)
    y = np.array([0, 1])

    def loss(p):
        return optax.softmax_cross_entropy(
            jmodel.apply({"params": p}, x, mask, train=False),
            jax.nn.one_hot(y, 3)).mean()

    _, grads = jax.jit(jax.value_and_grad(loss))(params)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(grads))
    model = pw.Wav2VecIntent(pw.Wav2Vec2Config.from_dict(jcfg.to_dict()), 3)
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    torch.nn.functional.cross_entropy(
        model(torch.from_numpy(x), torch.from_numpy(mask)),
        torch.from_numpy(y)).backward()
    assert not all(torch.isfinite(p.grad).all() for p in model.parameters()
                   if p.grad is not None)
