"""Tensor parallelism (the ``model`` axis) of the port, on the CPU.

* The rules: every leaf's part on a model axis of 2, 4 and 8 has the
  shape of JAX's ``NamedSharding.shard_shape`` for it, for the CNN-GRU
  and the wav2vec family at several widths (a width that does not divide
  stays whole in both), the JAX trees taken through ``jax.eval_shape``.
* One spawn of four gloo processes (one thread each,
  ``parallel.dryrun.dryrun_multichip(4, "cpu", model_axis=(2, 4))``): the
  dp2 x tp2 grid, then dp1 x tp4 in the same processes.  At hidden 32 the
  small wav2vec has two heads, so tp4 cuts inside a head.  Each step is
  held to the one-process step on the global batch within the dry run's
  ``BARS["cpu"]`` (1e-5 of scale; 1e-4 for the waveform step's conv
  stack); every process holds 1/model of each split leaf and of its Adam
  moments; the checkpoint round trip is bit-equal, in the one-process
  format; the deterministic step matches the JAX trainer on a dp2 x tp2
  mesh of four of conftest's CPU devices.
* ``cli.train`` over two processes at ``model_axis: 2`` and
  ``cli.evaluate --data_parallel`` on 2 x 2 CPU entries give the meshless
  runs' reports.
"""

import inspect
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")

from speech_intent_recognizer_tpu.config.schema import (  # noqa: E402
    Config as RefConfig)
from speech_intent_recognizer_tpu.convert.torch_import import (  # noqa
    convert_torch_state_dict)
from speech_intent_recognizer_tpu.models import cnn_gru as ref_model  # noqa
from speech_intent_recognizer_tpu.parallel.mesh import (  # noqa: E402
    create_mesh as ref_create_mesh)
from speech_intent_recognizer_tpu.parallel.sharding import (  # noqa: E402
    param_shardings as ref_param_shardings, place_params as ref_place)
from speech_intent_recognizer_tpu.train import loop as ref_loop  # noqa
from speech_intent_recognizer_tpu.train import state as ref_state  # noqa
from speech_intent_recognizer_tpu_torch.config import Config  # noqa: E402
from speech_intent_recognizer_tpu_torch.convert.jax_bridge import (  # noqa
    from_jax_variables)
from speech_intent_recognizer_tpu_torch.convert.wav2vec_import import (  # noqa
    from_jax_params)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import (  # noqa
    CNNAudioGRU)
from speech_intent_recognizer_tpu_torch.models import wav2vec as pw  # noqa
from speech_intent_recognizer_tpu_torch.parallel import dryrun  # noqa
from speech_intent_recognizer_tpu_torch.parallel.sharding import (  # noqa
    shard_shape)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the dry run's bars on the CPU, stated here
BARS = dict(loss=1e-5, stats=1e-5, grad=1e-5, conv_grad=1e-5,
            conv_grad_l2=1e-5, waveform_conv_grad=1e-4,
            waveform_conv_grad_l2=1e-4, serving=1e-5)
MESHES = {"dp2xtp2": 2, "dp1xtp4": 4}


# --------------------------------------------------------------- the rules

def _shard_tree(tree, model):
    """numpy zeros of each leaf's part under JAX's rules on a model axis of
    ``model`` (zeros: the converters read values)."""
    mesh = ref_create_mesh(model_axis=model, devices=jax.devices()[:8])
    shardings = ref_param_shardings(mesh, tree)
    return jax.tree.map(
        lambda leaf, s: np.zeros(s.shard_shape(leaf.shape), np.float32),
        tree, shardings)


def _check(port_module, converted, model):
    full = {k: tuple(v.shape) for k, v in port_module.state_dict().items()}
    assert set(converted) == set(full)
    for key, t in converted.items():
        assert tuple(t.shape) == shard_shape(key, full[key], model), key


CNN_WIDTHS = {"narrow": dict(conv_channels=(8, 16, 16), gru_hidden=32),
              "odd": dict(conv_channels=(4, 8, 4), gru_hidden=20),
              "full": dict(conv_channels=(32, 64, 128), gru_hidden=256)}


@pytest.mark.parametrize("model", [2, 4, 8])
@pytest.mark.parametrize("width", sorted(CNN_WIDTHS))
def test_cnn_gru_shard_shapes_match_jax(width, model):
    """Every leaf of the CNN-GRU (narrow, the reference widths, and GRU 20,
    whose 3H = 60 does not divide by 8 and stays whole): the part's shape
    is JAX's ``shard_shape``."""
    kw = CNN_WIDTHS[width]
    jmodel = ref_model.CNNAudioGRU(num_classes=31, **kw)
    tree = jax.eval_shape(lambda k: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 64, 48)), train=False),
        jax.random.key(0))
    parts = {name: _shard_tree(tree[name], model)
             for name in ("params", "batch_stats")}
    converted = from_jax_variables(parts["params"], parts["batch_stats"])
    with torch.device("meta"):
        port = CNNAudioGRU(num_classes=31, **kw)
    _check(port, converted, model)


def _wav2vec_configs():
    import transformers

    from speech_intent_recognizer_tpu.models import wav2vec as jw

    return {"small32": jw.small_wav2vec_config(hidden_size=32),
            "small36": jw.small_wav2vec_config(hidden_size=36),
            "base": transformers.Wav2Vec2Config()}


@pytest.mark.parametrize("model", [2, 4, 8])
@pytest.mark.parametrize("name", ["small32", "small36", "base"])
def test_wav2vec_shard_shapes_match_jax(name, model):
    """Every leaf of ``Wav2VecIntent``: the small config at hidden 32 (two
    heads of 16) and 36 (36 does not divide by 8: whole), and
    wav2vec2-base (94 M parameters, shapes only)."""
    pytest.importorskip("transformers")
    from speech_intent_recognizer_tpu.models import wav2vec as jw

    jcfg = _wav2vec_configs()[name]
    jmodel, _ = jw.create_wav2vec_intent(num_classes=31, config=jcfg)
    length = 4000
    tree = jax.eval_shape(lambda k: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, length)),
        jnp.ones((1, length), jnp.int32), train=False), jax.random.key(0))
    converted = from_jax_params(_shard_tree(tree["params"], model))
    with torch.device("meta"):
        port = pw.Wav2VecIntent(pw.Wav2Vec2Config.from_dict(jcfg.to_dict()),
                                31)
    _check(port, converted, model)


# ------------------------------------------------- four processes, two grids

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_dryrun")
    result = dryrun.dryrun_multichip(4, "cpu", out_dir=str(out),
                                     timeout_s=240.0, group_timeout_s=60.0,
                                     model_axis=(2, 4))
    return result, out


def _every_rank(result, mesh, part):
    return [next(p for p in r["parts"]
                 if p["part"] == part and p["mesh"] == mesh)
            for r in result["ranks"]]


@pytest.mark.parametrize("part", ["feature", "waveform", "wav2vec"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_step_matches_one_process_step(run, mesh, part):
    """SpecAugment, mixup and dropout (feature); the waveform augmentation
    too (waveform); train noise, dropout and LayerDrop (wav2vec; at tp4
    its columns cut inside a head): the loss and BatchNorm's running
    statistics within 1e-5, each gradient (a split leaf's parts gathered)
    within the part's bar of its own leaf's scale, the parameters equal on
    every process, the loss the same on all four."""
    result, _ = run
    got = result["meshes"][mesh][part]
    assert got["train_loss_err"] <= BARS["loss"], got
    assert got["stats_err"] <= BARS["stats"], got
    assert got["grad_err"] <= BARS["grad"], got
    if part != "wav2vec":
        for key in ("conv_grad", "conv_grad_l2"):
            bar = BARS.get(f"{part}_{key}", BARS[key])
            assert got[f"{key}_err"] <= bar, (key, got)
    ranks = _every_rank(result, mesh, part)
    assert all(p["replicas_equal"] for p in ranks)
    assert len({p["train_loss"] for p in ranks}) == 1


@pytest.mark.parametrize("part", ["feature", "waveform"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_evaluate_totals_are_the_global_batchs(run, mesh, part):
    result, _ = run
    got = result["meshes"][mesh][part]
    assert got["eval_loss_err"] <= BARS["loss"], got
    assert got["eval_acc_err"] == 0.0, got
    ranks = _every_rank(result, mesh, part)
    assert len({(p["eval_loss"], p["eval_acc"]) for p in ranks}) == 1


@pytest.mark.parametrize("part", ["feature", "wav2vec", "checkpoint"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_each_process_holds_its_part(run, mesh, part):
    """Every process holds 1/model of the bytes of the split leaves and of
    their Adam moments, and the replicated rest whole."""
    result, _ = run
    model = MESHES[mesh]
    for p in _every_rank(result, mesh, part):
        by = p["bytes"]
        assert by["split"] > 0 and by["split"] * model == by["split_full"]
        assert by["adam_split"] * model == by["adam_split_full"]
        assert by["adam_split"] == 2 * by["split"]  # two moments
        assert (by["params_full"] - by["params"]
                == by["split_full"] - by["split"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_checkpoint_round_trip_is_bit_equal(run, mesh):
    result, out = run
    assert all(p["bit_equal"] for p in _every_rank(result, mesh,
                                                   "checkpoint"))
    assert (out / mesh / "checkpoint" / "state" / "epoch_000001.pt").exists()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_checkpoint_loads_without_a_mesh(run, mesh, tmp_path):
    """The file process 0 wrote holds whole leaves and whole Adam moments
    (the one-process format): a meshless model and ``Trainer`` restore it
    (the model equal to the gathered weights after the step), and
    ``Predictor.from_checkpoint`` serves its model."""
    from speech_intent_recognizer_tpu_torch.data.labelmap import (
        save_label_map)
    from speech_intent_recognizer_tpu_torch.infer.predict import Predictor
    from speech_intent_recognizer_tpu_torch.train.checkpoint import (
        Checkpointer)
    from speech_intent_recognizer_tpu_torch.train.loop import Trainer

    _, out = run
    saved = torch.load(out / mesh / "deterministic_step.pt",
                       weights_only=True)
    size = dryrun.SIZES["cpu"]
    widths = dict(conv_channels=size["conv_channels"],
                  gru_hidden=size["gru_hidden"])
    model = CNNAudioGRU(num_classes=dryrun.CLASSES, dropout=0.0, **widths)
    trainer = Trainer(model, Config.from_dict(saved["config"]),
                      num_classes=dryrun.CLASSES)
    book = Checkpointer(str(out / mesh / "checkpoint")).restore_state(
        model, trainer.optimizer)
    assert book["epoch"] == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["after_step"][k]), k
    for p in trainer.optimizer.params:
        assert all(m.shape == p.shape
                   for m in trainer.optimizer.moments(p))
    path = tmp_path / "model.pt"
    torch.save(model.state_dict(), path)
    lm = tmp_path / "lm.json"
    save_label_map({f"c{i}": i for i in range(dryrun.CLASSES)}, str(lm))
    pred = Predictor.from_checkpoint(str(path), str(lm), device="cpu")
    rng = np.random.default_rng(0)
    probs = pred.predict_waveform_batch(
        (0.1 * rng.standard_normal((2, pred._buffer_width())))
        .astype(np.float32), np.array([16000, 9000], np.int32))
    assert probs.shape == (2, dryrun.CLASSES)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_serving_mesh_with_a_model_axis(run, mesh):
    """``Predictor(mesh=)`` over four CPU entries with the model axis
    replicated: its data shards serve the meshless rows."""
    got = run[0]["meshes"][mesh]["serving"]
    assert got["rows"] == 4 // MESHES[mesh] + 3
    assert got["prob_err"] <= BARS["serving"]


def test_deterministic_step_matches_jax_dp_tp_mesh(run):
    """The checkpoint part's first step on dp2 x tp2 (dropout 0, no
    augmentation, lr 5e-5, clip 1.0) against the JAX ``Trainer`` on a
    dp2 x tp2 mesh of four CPU devices from the same weights and batch:
    the loss, and the evaluation logits after the step, within
    tests/test_torch_distributed.py's 1e-4."""
    _, out = run
    saved = torch.load(out / "dp2xtp2" / "deterministic_step.pt",
                       weights_only=True)
    raw = saved["config"]
    size = dryrun.SIZES["cpu"]
    widths = dict(conv_channels=size["conv_channels"],
                  gru_hidden=size["gru_hidden"])
    params, stats = convert_torch_state_dict(
        {k: v.numpy() for k, v in saved["init"].items()})
    mesh = ref_create_mesh(model_axis=2, devices=jax.devices()[:4])
    assert dict(mesh.shape) == {"data": 2, "model": 2}
    model = ref_model.CNNAudioGRU(num_classes=dryrun.CLASSES, dropout=0.0,
                                  **widths)
    tx = ref_state.create_optimizer(lr=raw["lr"],
                                    weight_decay=raw["weight_decay"],
                                    grad_clip=raw["grad_clip"])
    placed = ref_place(mesh, params)
    state = ref_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=placed,
        batch_stats=ref_place(mesh, stats), opt_state=tx.init(placed),
        tx=tx)
    trainer = ref_loop.Trainer(model, RefConfig.from_dict(raw), mesh=mesh,
                               tx=tx, num_classes=dryrun.CLASSES)
    feats = saved["features"].numpy()
    state, m = trainer._build_epoch_fn()(
        state, jnp.asarray(feats), jnp.asarray(saved["labels"].numpy(),
                                               jnp.int32),
        jnp.asarray(saved["perm"].numpy(), jnp.int32),
        jnp.asarray(saved["weights"].numpy()), jax.random.key(0))
    np.testing.assert_allclose(saved["train_loss"], float(m["loss"]),
                               rtol=1e-4, atol=1e-4)
    held = feats[:4]
    want = np.asarray(model.apply({"params": state.params,
                                   "batch_stats": state.batch_stats},
                                  jnp.asarray(held), train=False))
    port = CNNAudioGRU(num_classes=dryrun.CLASSES, dropout=0.0, **widths)
    port.load_state_dict(saved["after_step"])
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(held)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ the CLIs

def _corpus(tmp_path):
    from speech_intent_recognizer_tpu_torch.data.audio_io import save_wav

    rng = np.random.default_rng(5)
    csvs = {}
    for split, n in (("train", 16), ("valid", 8)):
        rows = []
        for i in range(n):
            t = np.arange(int(rng.integers(8000, 16000))) / 16000
            x = 0.3 * np.sin(2 * np.pi * 300 * (i % 2 + 1) * t)
            path = tmp_path / split / f"{i:03d}.wav"
            save_wav(str(path), x.astype(np.float32), 16000)
            rows.append(f"{path},tone_{i % 2}\n")
        csvs[split] = tmp_path / f"{split}.csv"
        csvs[split].write_text("path,label\n" + "".join(rows))
    label_map = tmp_path / "label_map.json"
    label_map.write_text(json.dumps({"tone_0": 0, "tone_1": 1}))
    return csvs, label_map


def _config(tmp_path, name, parallel="", save=None):
    cfg = tmp_path / f"{name}.yaml"
    cfg.write_text(
        f"data:\n  cache_dir: {tmp_path / 'cache'}\n"
        f"  precompute_batch_size: 8\n"
        f"model:\n  num_labels: 2\n  conv_channels: [8, 16, 16]\n"
        f"  gru_hidden: 32\ntrain:\n  epochs: 2\n  batch_size: 8\n"
        f"  early_stop_patience: 5\n  bf16: false\n"
        f"  save_path: {tmp_path / (save or name)}\n" + parallel)
    return cfg


def _train(cfgs, csvs, label_map):
    procs = [subprocess.Popen(
        [sys.executable, "-m", "speech_intent_recognizer_tpu_torch.cli."
         "train", "--config", str(cfg), "--train_csv", str(csvs["train"]),
         "--val_csv", str(csvs["valid"]), "--label_map", str(label_map),
         "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cfg in cfgs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_cli_train_and_evaluate_with_a_model_axis(tmp_path):
    """``cli.train`` over two processes with ``model_axis: 2`` (dp1 x tp2: the
    GRU, attention and fc leaves split, the same rows on both) trains the
    run one process trains: each epoch's losses and accuracies within
    1e-5, the best model within 1e-5 of its weights.  ``cli.evaluate
    --data_parallel`` at ``data_axis: 2, model_axis: 2`` (four CPU entries,
    two data shards) gives the meshless evaluation's report."""
    from speech_intent_recognizer_tpu_torch.cli.evaluate import (
        evaluate_from_config)
    from speech_intent_recognizer_tpu_torch.config.loader import (
        load_config)

    csvs, label_map = _corpus(tmp_path)
    one = _config(tmp_path, "one")
    _train([one], csvs, label_map)  # writes the feature caches
    cfgs = [_config(
        tmp_path, f"tp{rank}",
        f"parallel:\n  coordinator_address: file://{tmp_path / 'store'}\n"
        f"  num_processes: 2\n  process_id: {rank}\n  data_axis: 1\n"
        f"  model_axis: 2\n", save="tp") for rank in range(2)]
    outs = _train(cfgs, csvs, label_map)
    assert "process 0 of 2" in outs[0] and "process 1 of 2" in outs[1]
    assert "'model': 2" in outs[0]
    want = json.loads((tmp_path / "one" / "training_history.json")
                      .read_text())
    got = json.loads((tmp_path / "tp" / "training_history.json")
                     .read_text())
    assert got["epochs_run"] == want["epochs_run"] == 2
    for g, w in zip(got["history"], want["history"]):
        for key in ("train_loss", "train_acc", "val_loss", "val_acc"):
            assert abs(g[key] - w[key]) <= 1e-5 * max(1.0, abs(w[key])), key
    a = torch.load(tmp_path / "tp" / "best_model.pt", weights_only=True)
    b = torch.load(tmp_path / "one" / "best_model.pt", weights_only=True)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        scale = max(float(b[k].abs().max()), 1e-3)
        assert float((a[k] - b[k]).abs().max()) <= 1e-5 * scale, k

    cfg = load_config(str(one))
    model_path = str(tmp_path / "one" / "best_model.pt")
    plain = evaluate_from_config(cfg, str(csvs["valid"]), str(label_map),
                                 model_path, results_dir=str(
                                     tmp_path / "eval_one"), device="cpu")
    cfg.parallel.data_axis, cfg.parallel.model_axis = 2, 2
    grid = evaluate_from_config(cfg, str(csvs["valid"]), str(label_map),
                                model_path, results_dir=str(
                                    tmp_path / "eval_grid"), device="cpu",
                                data_parallel=True)
    assert np.array_equal(grid["confusion_matrix"],
                          plain["confusion_matrix"])
    assert grid["accuracy"] == plain["accuracy"]
    assert ((tmp_path / "eval_grid" / "classification_report.txt")
            .read_text() == (tmp_path / "eval_one"
                             / "classification_report.txt").read_text())


# ------------------------------------------- the wav2vec trainer; a timeout

_WORKER = """
import os, sys, time
import numpy as np, torch
from speech_intent_recognizer_tpu_torch.parallel.distributed import (
    initialize_distributed)
from speech_intent_recognizer_tpu_torch.parallel.mesh import create_mesh
# _wav2vec_fit
torch.set_num_threads(1)
rank, n, store, d, what = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4], sys.argv[5])
timeout = 4.0 if what == "skip" else 60.0
initialize_distributed(store, n, rank, device="cpu", timeout_s=timeout)
mesh = create_mesh(model_axis=n)
done = os.path.join(d, "skip_done")
if what == "skip":  # process 0 never joins the model group's all-reduce
    if rank == 0:
        t0 = time.perf_counter()
        while not os.path.exists(done) and time.perf_counter() - t0 < 60:
            time.sleep(0.1)
        sys.exit(0)
    t0 = time.perf_counter()
    try:
        torch.distributed.all_reduce(torch.ones(3), group=mesh.model_group)
    except RuntimeError:
        print(f"raised after {time.perf_counter() - t0:.1f} s")
        sys.exit(0)
    finally:
        open(done, "w").close()
    sys.exit(1)
print("losses", _wav2vec_fit(d, mesh, rank))
"""


def _spawn(tmp_path, what, n=2):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.replace("# _wav2vec_fit\n", inspect.getsource(
        _wav2vec_fit)))
    store = f"file://{tmp_path / ('store_' + what)}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(n), store, str(tmp_path),
         what], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _wav2vec_fit(d, mesh, rank=0):
    """Two epochs of ``Wav2VecTrainer.fit`` (small config, 8 WAVs, batch 4)
    with a checkpointer, then a fresh trainer resumed from it for a third;
    -> the train losses of each epoch."""
    from speech_intent_recognizer_tpu_torch.data.audio_io import save_wav
    from speech_intent_recognizer_tpu_torch.models.wav2vec import (
        Wav2VecIntent, init_wav2vec, small_wav2vec_config)
    from speech_intent_recognizer_tpu_torch.train.checkpoint import (
        Checkpointer)
    from speech_intent_recognizer_tpu_torch.train.wav2vec_trainer import (
        Wav2VecTrainer, create_wav2vec_optimizer)

    paths = [os.path.join(d, f"w{i}.wav") for i in range(8)]
    if rank == 0:
        for i, p in enumerate(paths):
            t = np.arange(3000 + 100 * i) / 16000
            save_wav(p, (0.3 * np.sin(2 * np.pi * 300 * (1 + i % 2) * t))
                     .astype(np.float32), 16000)
    if mesh is not None:
        torch.distributed.barrier()
    labels = [i % 2 for i in range(8)]
    ckpt = Checkpointer(os.path.join(d, "w2v_" + (
        "one" if mesh is None
        else f"dp{mesh.spec.data}xtp{mesh.spec.model}")))
    losses = []
    for epochs in (2, 3):
        model = init_wav2vec(Wav2VecIntent(small_wav2vec_config(32, 1), 2), 0)
        trainer = Wav2VecTrainer(model, create_wav2vec_optimizer(
            model.parameters(), lr=1e-3), 2, max_length=4000, mesh=mesh)
        got = trainer.fit(paths, labels, paths, labels, epochs=epochs,
                          batch_size=4, checkpointer=ckpt,
                          resume=epochs == 3)
        losses += [h["train_loss"] for h in got["history"]]
    return losses


def test_wav2vec_fit_and_resume_with_a_model_axis(tmp_path):
    """``Wav2VecTrainer.fit`` over two processes at dp1 x tp2 (the encoder
    Megatron-split, the clip over the model group) with a checkpointer,
    then resumed from its file in fresh trainers: each epoch's train loss
    is the one-process run's within 1e-5, and the file holds whole
    leaves."""
    outs = _spawn(tmp_path, "fit")
    got = [json.loads(out.split("losses", 1)[1].strip().replace("'", '"'))
           for out in outs]
    want = _wav2vec_fit(str(tmp_path), None)
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-6)
    saved = torch.load(tmp_path / "w2v_dp1xtp2" / "state" /
                       "epoch_000003.pt", weights_only=True)
    assert saved["model"][
        "wav2vec.encoder.layers.0.attention.q_proj.weight"].shape == (32, 32)


def test_a_skipped_collective_raises_after_the_group_timeout(tmp_path):
    """A process that waits in a model group's all-reduce that another
    process never joins (as a LayerDrop draw that differed would make it)
    raises after the group timeout that ``initialize_distributed`` set,
    instead of hanging."""
    outs = _spawn(tmp_path, "skip")
    seconds = float(outs[1].split("raised after", 1)[1].split()[0])
    assert 3.0 <= seconds <= 30.0, outs[1]
