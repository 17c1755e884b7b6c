"""The librosa front-end mode of the port (plain PyTorch by design: the JAX
package runs it in XLA only, ``ops/frontend_jax.py:448-456`` and
``:552-553``) against JAX's ``log_mel_frontend`` in that mode and the fp64
golden (``tests/test_frontend.py:232-246``: rtol 2e-3 / atol 3e-3); a
narrow librosa-mode ``Predictor`` against JAX's; and the gates that keep
the mode off the kernels: the fused conv1 path (K1) is not enabled, and a
batch path or front-end routed as on the card reaches none of the K1,
K3 and K4 wrappers, where the torchaudio mode reaches one, and each
wrapper refuses the mode on a (fake) CUDA tensor; the launch counters stay
0; streaming refuses the mode and an export records it."""

import collections
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from speech_intent_recognizer_tpu.config.schema import (
    AudioConfig as JaxAudioConfig)
from speech_intent_recognizer_tpu.infer.predict import (
    Predictor as JaxPredictor)
from speech_intent_recognizer_tpu.models.cnn_gru import (
    CNNAudioGRU as FlaxCNNAudioGRU, fold_batchnorm as flax_fold_batchnorm)
from speech_intent_recognizer_tpu.ops.frontend_jax import (
    log_mel_frontend as jax_log_mel_frontend,
    make_frontend_params as jax_make_frontend_params)
from speech_intent_recognizer_tpu.train.checkpoint import (
    load_model_checkpoint as jax_load_checkpoint)
from speech_intent_recognizer_tpu_torch.config import AudioConfig
from speech_intent_recognizer_tpu_torch.infer.predict import Predictor
from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
from speech_intent_recognizer_tpu_torch.ops import frontend_kernels as fk
from speech_intent_recognizer_tpu_torch.ops import frontend_numpy as golden
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    log_mel_frontend, log_mel_frontend_plain, make_frontend_params)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
RTOL, ATOL = 2e-3, 3e-3
LIBROSA = AudioConfig(frontend="librosa")
COUNTED = (fk.frontend_conv1, fk.frontend, fk.mel_db)


def _wave(rng, n):
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 300 * t) * np.exp(-t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _batch(lengths, width, seed):
    rng = np.random.default_rng(seed)
    buf = np.zeros((len(lengths), width), np.float32)
    for i, n in enumerate(lengths):
        buf[i, :n] = _wave(rng, n)
    return buf, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("lengths", [[1], [1, 700, 9000], [80000, 30000]],
                         ids=["one_sample", "short", "full"])
def test_frontend_matches_jax_and_golden(lengths, normalize):
    buf, ln = _batch(lengths, LIBROSA.max_samples, seed=len(lengths))
    p = make_frontend_params(LIBROSA)
    assert (p.frontend, p.global_mean, p.global_std) == \
        ("librosa", -30.1, 12.7)
    got = log_mel_frontend(torch.from_numpy(buf), torch.from_numpy(ln), p,
                           normalize=normalize).numpy()
    want = np.asarray(jax_log_mel_frontend(
        jnp.asarray(buf), jnp.asarray(ln),
        jax_make_frontend_params(JaxAudioConfig(frontend="librosa")),
        normalize=normalize))
    assert got.shape == want.shape == (len(lengths), 64, 200)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for i, n in enumerate(lengths):
        ref = golden.pad_or_trim_np(golden.log_mel_spectrogram_np(
            buf[i, :n], frontend="librosa", normalize=normalize), 200)
        np.testing.assert_allclose(got[i], ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"row {i}")


def _narrow_jax_predictor(fold_bn: bool):
    variables = jax_load_checkpoint(os.path.join(DATA,
                                                 "narrow_model.msgpack"))
    with open(os.path.join(DATA, "narrow_label_map.json")) as f:
        label_map = json.load(f)
    widths = dict(num_classes=4, conv_channels=(4, 8, 4), gru_hidden=32)
    if fold_bn:
        variables = {"params": flax_fold_batchnorm(
            variables["params"], variables["batch_stats"]),
            "batch_stats": {}}
    return JaxPredictor(FlaxCNNAudioGRU(fold_bn=fold_bn, **widths),
                        variables, label_map,
                        JaxAudioConfig(frontend="librosa"))


@pytest.mark.parametrize("fold_bn", [False, True])
def test_narrow_predictor_matches_jax(fold_bn):
    for fn in COUNTED:
        fn.launches = 0
    port = Predictor.from_checkpoint(
        os.path.join(DATA, "narrow_model.pt"),
        os.path.join(DATA, "narrow_label_map.json"), audio_cfg=LIBROSA,
        fold_bn=fold_bn, device="cpu")
    want_pred = _narrow_jax_predictor(fold_bn)
    buf, ln = _batch([30000, 7000, 1, 80000], port._buffer_width(), seed=4)
    got = port.predict_waveform_batch(buf, ln)
    want = want_pred.predict_waveform_batch(buf, ln)
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert all(fn.launches == 0 for fn in COUNTED)


@pytest.fixture(scope="module")
def k1_checkpoint(tmp_path_factory):
    """A checkpoint whose conv1 is K1's (32 channels)."""
    d = tmp_path_factory.mktemp("k1_ckpt")
    model = CNNAudioGRU(4, gru_hidden=32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), d / "model.pt")
    (d / "label_map.json").write_text(json.dumps(
        {f"i{i}": i for i in range(4)}))
    return str(d / "model.pt"), str(d / "label_map.json")


@pytest.fixture
def wrapper_calls(monkeypatch):
    """The K1, K3 and K4 wrappers replaced by spies that count each call
    and return the plain version's result (on any device, the meta device
    too)."""
    calls = collections.Counter()

    def spy(name, plain):
        def call(*args, **kwargs):
            calls[name] += 1
            return plain(*args, **kwargs)
        return call

    monkeypatch.setattr(fk, "frontend_conv1",
                        spy("K1", fk._frontend_conv1_plain))
    monkeypatch.setattr(fk, "frontend", spy("K3", log_mel_frontend_plain))
    monkeypatch.setattr(fk, "mel_db", spy("K4", fk._mel_db_plain))
    return calls


@pytest.mark.parametrize("mode", ["torchaudio", "librosa"])
def test_predictor_gate(k1_checkpoint, wrapper_calls, mode):
    """Only the torchaudio mode enables the fused K1 path; the librosa
    predictor's batch path reaches none of the front-end kernels'
    wrappers, and no kernel launches."""
    for fn in COUNTED:
        fn.launches = 0
    pred = Predictor.from_checkpoint(*k1_checkpoint, device="cpu",
                                     audio_cfg=AudioConfig(frontend=mode))
    buf, ln = _batch([16000, 4000], pred._buffer_width(), seed=5)
    probs = pred.predict_waveform_batch(buf, ln)
    assert probs.shape == (2, 4) and np.isfinite(probs).all()
    if mode == "torchaudio":
        assert pred._conv1 is not None
        assert wrapper_calls == {"K1": 1}
    else:
        assert pred._conv1 is None
        assert wrapper_calls == {}
        with pytest.raises(ValueError, match="reference geometry"):
            pred.enable_conv23_kernel()
    assert all(fn.launches == 0 for fn in COUNTED)


@pytest.mark.parametrize("mode,hop,want", [
    ("torchaudio", 512, {"K3": 1}),
    ("torchaudio", 256, {"K4": 1}),
    ("librosa", 512, {}),
    ("librosa", 256, {})])
def test_frontend_gate(wrapper_calls, mode, hop, want):
    """``log_mel_frontend`` (what the predictor's unfused path, the
    precompute of ``data/cache.py`` and the waveform trainer call) on a
    device other than the CPU (here the meta device, routed as the card
    is): K3 at the reference geometry, K4 off it, neither in librosa
    mode."""
    cfg = AudioConfig(frontend=mode, hop_length=hop,
                      mel_spec_length=200 * 512 // hop)
    p = make_frontend_params(cfg, "meta")
    wf = torch.zeros((3, cfg.max_samples + 512 * 3), device="meta")
    ln = torch.full((3,), 40000, dtype=torch.int32, device="meta")
    out = log_mel_frontend(wf, ln, p)
    assert out.shape == (3, 64, cfg.mel_spec_length)
    assert wrapper_calls == want
    assert fk.is_reference_geometry(p) == (mode == "torchaudio"
                                           and hop == 512)


def test_kernel_wrappers_refuse_librosa_on_cuda():
    p = make_frontend_params(LIBROSA)
    with FakeTensorMode(allow_non_fake_inputs=True):
        wf = torch.zeros((2, 8192), device="cuda")
        pc = p._replace(**{n: torch.zeros(getattr(p, n).shape,
                                          dtype=getattr(p, n).dtype,
                                          device=wf.device)
                           for n in p._fields[:6]})
        ln = torch.full((2,), 8000, dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="torchaudio mode"):
            fk.frontend(wf, ln, pc)
        with pytest.raises(ValueError, match="torchaudio mode"):
            fk.frontend_conv1(wf, ln, pc, torch.zeros((32, 1, 3, 3)),
                              torch.zeros(32))
        with pytest.raises(ValueError, match="torchaudio mode"):
            fk.mel_db(torch.zeros((3, 1024), device="cuda"), pc)


def test_waveform_trainer_and_precompute_take_the_plain_path(tmp_path):
    """The waveform trainer's featurization and the feature precompute in
    librosa mode equal the plain front-end (and the golden)."""
    from speech_intent_recognizer_tpu_torch.config import Config
    from speech_intent_recognizer_tpu_torch.data.audio_io import save_wav
    from speech_intent_recognizer_tpu_torch.data.cache import (
        precompute_features)
    from speech_intent_recognizer_tpu_torch.data.manifest import Manifest
    from speech_intent_recognizer_tpu_torch.train.loop import Trainer

    cfg = Config.from_dict({"frontend": "librosa", "num_labels": 4})
    model = CNNAudioGRU(4, conv_channels=(4, 8, 4), gru_hidden=32)
    trainer = Trainer(model, cfg, from_waveforms=True)
    buf, ln = _batch([20000, 900], LIBROSA.max_samples, seed=9)
    x, lt = torch.from_numpy(buf), torch.from_numpy(ln)
    plain = log_mel_frontend_plain(x, lt, make_frontend_params(LIBROSA))
    torch.testing.assert_close(trainer._featurize(x, lt), plain, rtol=0,
                               atol=0)

    paths = []
    for i, n in enumerate(ln):
        paths.append(str(tmp_path / f"{i}.wav"))
        save_wav(paths[-1], buf[i, :n], 16000)
    feats, _labels, ok = precompute_features(
        Manifest(paths=paths, labels=["a", "b"]), {"a": 0, "b": 1},
        LIBROSA, device="cpu", progress=False)[:3]
    assert ok.all()
    for i, path in enumerate(paths):
        from speech_intent_recognizer_tpu_torch.data.audio_io import (
            load_audio)

        x_i, _ = load_audio(path)
        ref = golden.pad_or_trim_np(golden.log_mel_spectrogram_np(
            x_i, frontend="librosa"), 200)
        np.testing.assert_allclose(feats[i], ref, rtol=RTOL, atol=ATOL)


def test_streaming_refuses_librosa():
    from speech_intent_recognizer_tpu_torch.infer.streaming import (
        StreamingFeaturizer)

    with pytest.raises(ValueError, match="torchaudio"):
        StreamingFeaturizer(audio_cfg=LIBROSA)


def test_export_records_the_mode(tmp_path):
    """A portable artifact of a librosa predictor names the mode in its
    manifest and serves what the live predictor does (a short geometry
    keeps the trace quick)."""
    from speech_intent_recognizer_tpu_torch.infer.export import (
        ServingModel, export_predictor)

    cfg = AudioConfig(frontend="librosa", mel_spec_length=48,
                      max_duration=1.5)
    pred = Predictor.from_checkpoint(
        os.path.join(DATA, "narrow_model.pt"),
        os.path.join(DATA, "narrow_label_map.json"), audio_cfg=cfg,
        device="cpu")
    out = export_predictor(pred, str(tmp_path / "art"), flavor="portable")
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["audio"]["frontend"] == "librosa"
    assert manifest["ops"] == {}
    srv = ServingModel.load(out, device="cpu")
    buf, ln = _batch([20000, 5000], pred._buffer_width(), seed=12)
    np.testing.assert_allclose(srv.predict_waveform_batch(buf, ln),
                               pred.predict_waveform_batch(buf, ln),
                               atol=1e-5)
