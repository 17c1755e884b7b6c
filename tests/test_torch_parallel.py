"""The port's ``parallel/`` in one process: ``host_shard`` / ``shard_list``
and the mesh checks against the JAX package's, the global-batch draws,
batch sharding, the serving mesh of ``Predictor`` and
``Wav2VecPredictor`` and the data-parallel ``evaluate_dataset`` over two
CPU entries against their meshless results, and BatchNorm without a
process group against the one-device arithmetic it always had.  The
multi-process path: tests/test_torch_distributed.py."""

import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speech_intent_recognizer_tpu.parallel import distributed as ref_dist
from speech_intent_recognizer_tpu.parallel import mesh as ref_mesh
from speech_intent_recognizer_tpu_torch.config import Config
from speech_intent_recognizer_tpu_torch.evaluation.evaluate import (
    evaluate_dataset)
from speech_intent_recognizer_tpu_torch.infer.predict import (
    Predictor, Wav2VecPredictor)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
    BatchNorm2d, CNNAudioGRU)
from speech_intent_recognizer_tpu_torch.models.wav2vec import (
    Wav2VecIntent, small_wav2vec_config)
from speech_intent_recognizer_tpu_torch.ops.augment import (
    draw_augment, mixup)
from speech_intent_recognizer_tpu_torch.ops.global_batch import (
    rand_rows, randn_rows)
from speech_intent_recognizer_tpu_torch.ops.specaugment import spec_augment
from speech_intent_recognizer_tpu_torch.parallel import (
    ShardedGenerator, batch_sharding, create_mesh, host_shard,
    local_batch_size, shard_batch, shard_list)
from speech_intent_recognizer_tpu_torch.parallel import dryrun
from speech_intent_recognizer_tpu_torch.parallel.sharding import (
    run_sharded)
from speech_intent_recognizer_tpu_torch.train.loop import Trainer

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MODEL = os.path.join(DATA, "narrow_model.pt")
LABELS = os.path.join(DATA, "narrow_label_map.json")


def test_host_shard_and_shard_list_match_jax():
    for n in range(41):
        items = list(range(100, 100 + n))
        for count in range(1, 9):
            for index in range(count):
                assert (host_shard(n, index, count)
                        == ref_dist.host_shard(n, index, count))
                assert (shard_list(items, index, count)
                        == ref_dist.shard_list(items, index, count))


def test_host_shard_defaults_to_one_process():
    assert host_shard(7) == range(0, 7)


def test_initialize_distributed_without_a_coordinator():
    """No address: a no-op (the JAX contract); several processes asked for
    without one raise instead of running as one."""
    from speech_intent_recognizer_tpu_torch.parallel import (
        initialize_distributed)

    assert initialize_distributed(None) is None
    assert initialize_distributed(None, 1, 0) is None
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_distributed(None, 2, 0)


def _raises(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e)
    return None


def test_create_mesh_and_local_batch_size_raise_where_jax_raises():
    """Every (devices, data_axis, model_axis) of up to 8 devices: where the
    JAX package raises ValueError the port does; where it builds a mesh,
    ``model_axis > 1`` included, the port builds the same shape, whose
    data shards run on every ``model``-th entry (the model axis
    replicated in one process).  ``local_batch_size`` raises on the same
    batches."""
    for n in range(1, 9):
        for data in (-1, None, 1, 2, 3, 4, 8):
            for model in (1, 2, 3, 4):
                want = _raises(lambda: ref_mesh.create_mesh(
                    data, model, jax.devices()[:n]))
                got = _raises(lambda: create_mesh(data, model, ["cpu"] * n))
                if want is not None:
                    assert got is ValueError, (n, data, model)
                    continue
                assert got is None, (n, data, model)
                jm = ref_mesh.create_mesh(data, model, jax.devices()[:n])
                devices = [torch.device("cpu", i) for i in range(n)]
                tm = create_mesh(data, model, devices)
                assert tm.shape == dict(jm.shape)
                assert tm.data_devices == tuple(devices[::model])
                assert len(tm.data_devices) == jm.shape["data"]
                for batch in range(0, 20):
                    assert (_raises(lambda: local_batch_size(batch, tm))
                            == _raises(lambda: ref_mesh.local_batch_size(
                                batch, jm)))
                    if batch % jm.shape["data"] == 0:
                        assert (local_batch_size(batch, tm)
                                == ref_mesh.local_batch_size(batch, jm))


def test_batch_sharding_and_shard_batch():
    mesh = create_mesh(devices=["cpu", "cpu", "cpu"])
    assert batch_sharding(mesh, 6) == [slice(0, 2), slice(2, 4),
                                       slice(4, 6)]
    x = torch.arange(12).reshape(6, 2)
    parts = shard_batch(mesh, (x, x[:, 0]))
    assert [p[1].tolist() for p in parts] == [[0, 2], [4, 6], [8, 10]]
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, x[:5])
    # ragged: padded with the last row, the pad stripped
    got = run_sharded(lambda i, t: t * 10 + i, mesh, x[:4])
    assert got.tolist() == [[0, 10], [20, 30], [41, 51], [61, 71]]


@pytest.mark.parametrize("world", [2, 3])
def test_row_draws_are_the_global_batchs(world):
    """With a ``ShardedGenerator`` each process's draws are its rows of the
    global batch's: dropout masks, SpecAugment's and the waveform
    augmentation's draws, equal to the one-process draws bit for bit."""
    b, n = 2, 50
    for rank in range(world):
        def gen():
            return torch.Generator().manual_seed(4)

        def sharded():
            return ShardedGenerator(gen(), rank, world)

        rows = slice(rank * b, (rank + 1) * b)
        assert torch.equal(rand_rows((b, 3, 5), sharded(), "cpu"),
                           torch.rand((world * b, 3, 5),
                                      generator=gen())[rows])
        assert torch.equal(randn_rows((b, n), sharded(), "cpu"),
                           torch.randn((world * b, n), generator=gen())[rows])
        mels = torch.randn(world * b, 16, 40, generator=gen())
        assert torch.equal(
            spec_augment(mels[rows], sharded()),
            spec_augment(mels, gen())[rows])
        got = draw_augment(b, n, sharded(), "cpu")
        want = draw_augment(world * b, n, gen(), "cpu")
        assert torch.equal(got.gates, want.gates[:, rows])
        for field in ("outer", "shift_frac", "semitones", "speed", "level",
                      "noise"):
            assert torch.equal(getattr(got, field),
                               getattr(want, field)[rows]), field


def test_mixup_of_a_part_of_the_batch_needs_the_group():
    """mixup's partners live on the other processes: with a sharded
    generator and no process group it raises, never mixing within the
    local rows alone."""
    mels, labels = torch.randn(2, 16, 40), torch.eye(4)[:2]
    sharded = ShardedGenerator(torch.Generator().manual_seed(0), 0, 2)
    with pytest.raises(ValueError, match="process group"):
        mixup(mels, labels, sharded)
    got = mixup(mels, labels, ShardedGenerator(
        torch.Generator().manual_seed(0), 0, 1))
    want = mixup(mels, labels, torch.Generator().manual_seed(0))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_set_sync_group_reaches_every_batchnorm():
    """The trainer hands the model its group once; None takes it away."""
    model = CNNAudioGRU(num_classes=3, conv_channels=(4, 8, 4),
                        gru_hidden=8)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert len(bns) == 3 and all(m.sync_group is None for m in bns)
    group = object()
    model.set_sync_group(group)
    assert all(m.sync_group is group for m in bns)
    model.set_sync_group(None)
    assert all(m.sync_group is None for m in bns)


def test_dryrun_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """``dryrun_multichip`` runs on the card unless the caller asks for the
    CPU; with no card it raises before it starts a process."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--n", "2"])


def test_trainer_refuses_a_mesh_of_devices_in_one_process():
    model = CNNAudioGRU(num_classes=3, conv_channels=(4, 8, 4),
                        gru_hidden=8)
    with pytest.raises(ValueError, match="one process per device"):
        Trainer(model, Config.from_dict({}),
                mesh=create_mesh(devices=["cpu", "cpu"]))
    assert Trainer(model, Config.from_dict({}),
                   mesh=create_mesh(devices=["cpu"])).mesh is None


def _ragged(pred, rows, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, pred.audio_cfg.max_samples + 1, rows)
    buf = np.zeros((rows, pred._buffer_width()), np.float32)
    for i, k in enumerate(lengths):
        buf[i, :k] = 0.1 * rng.standard_normal(k)
    return buf, lengths.astype(np.int32)


def test_predictor_mesh_matches_meshless_rows():
    """The serving mesh over two CPU entries on 5 rows (padded to 6): the
    meshless predictor's probabilities within 1e-6."""
    mesh = create_mesh(devices=["cpu", "cpu"])
    pred = Predictor.from_checkpoint(MODEL, LABELS, device="cpu", mesh=mesh)
    plain = Predictor.from_checkpoint(MODEL, LABELS, device="cpu")
    buf, ln = _ragged(plain, 5, 0)
    got = pred.predict_waveform_batch(buf, ln)
    want = plain.predict_waveform_batch(buf, ln)
    assert got.shape == want.shape == (5, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="mesh over processes"):
        from speech_intent_recognizer_tpu_torch.parallel.mesh import (
            Mesh, MeshSpec)

        Predictor.from_checkpoint(MODEL, LABELS, device="cpu",
                                  mesh=Mesh(MeshSpec(2), group=object()))


def test_wav2vec_predictor_mesh_matches_meshless_rows(tmp_path):
    model = Wav2VecIntent(small_wav2vec_config(32, 1), 3)
    model.reset_parameters(torch.Generator().manual_seed(0))
    path = str(tmp_path / "w2v.pt")
    torch.save(model.state_dict(), path)
    lm = tmp_path / "lm.json"
    lm.write_text(json.dumps({"a": 0, "b": 1, "c": 2}))
    cfg = Config.from_dict({"max_duration": 0.5}).audio
    mesh = create_mesh(devices=["cpu", "cpu"])
    pred = Wav2VecPredictor.from_checkpoint(path, str(lm), cfg,
                                            device="cpu", mesh=mesh)
    plain = Wav2VecPredictor.from_checkpoint(path, str(lm), cfg,
                                             device="cpu")
    buf, ln = _ragged(plain, 3, 1)
    np.testing.assert_allclose(pred.predict_waveform_batch(buf, ln),
                               plain.predict_waveform_batch(buf, ln),
                               rtol=0, atol=1e-6)


def test_evaluate_dataset_mesh_matches_meshless():
    """``evaluate_dataset(mesh=)`` over two CPU entries, 11 rows in batches
    of 4 (the last ragged): predictions and the report equal to the
    meshless evaluation's, probabilities within 1e-6."""
    model = CNNAudioGRU(num_classes=4, conv_channels=(4, 8, 4),
                        gru_hidden=8)
    model.reset_parameters(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.standard_normal((11, 64, 48))
                             .astype(np.float32))
    labels = rng.integers(0, 4, 11)
    lm = {f"c{i}": i for i in range(4)}
    want = evaluate_dataset(model, feats, labels, lm, batch_size=4)
    got = evaluate_dataset(model, feats, labels, lm, batch_size=4,
                           mesh=create_mesh(devices=["cpu", "cpu"]))
    assert np.array_equal(got["predictions"], want["predictions"])
    assert got["report"] == want["report"]
    np.testing.assert_allclose(got["probabilities"], want["probabilities"],
                               rtol=0, atol=1e-6)


def test_batchnorm_without_a_group_is_the_one_device_arithmetic():
    """No process group: train mode is ``torch.native_batch_norm`` on the
    batch and the Flax running-stat update with the biased variance, bit
    for bit, forward and backward, as before the synchronized path."""
    torch.manual_seed(0)
    bn = BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    x = (torch.randn(5, 6, 7, 9) * 2 + 0.3).requires_grad_()
    dy = torch.randn(5, 6, 7, 9)
    y = bn(x)
    y.backward(dy)
    x2 = x.detach().clone().requires_grad_()
    w2 = bn.weight.detach().clone().requires_grad_()
    b2 = bn.bias.detach().clone().requires_grad_()
    want = torch.native_batch_norm(x2, w2, b2, None, None, True, 0.0,
                                   bn.eps)[0]
    want.backward(dy)
    assert torch.equal(y, want)
    assert torch.equal(x.grad, x2.grad)
    assert torch.equal(bn.weight.grad, w2.grad)
    var, mean = torch.var_mean(x.detach(), (0, 2, 3), correction=0)
    assert torch.equal(bn.running_mean, 0.1 * mean)
    assert torch.equal(bn.running_var,
                       torch.ones(6).mul_(0.9).add_(var, alpha=0.1))
    assert int(bn.num_batches_tracked) == 1
    bn.eval()
    assert torch.equal(bn(x.detach()), F.batch_norm(
        x.detach(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
        training=False, eps=bn.eps))
