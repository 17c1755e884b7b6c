"""Serving export of the port against the JAX package's, on the CPU.

A narrow model on both sides (conv 8/16/16, GRU hidden 32, 5 classes,
BatchNorm statistics non-trivial; weights carried by ``jax_bridge``) and a
short geometry (``mel_spec_length`` 48, 1.5 s buffers: six GRU steps),
which keeps a traced plain program small enough to export and load in a
few seconds here:

* the six kernel ops: ``torch.library.opcheck`` on CPU inputs (schema,
  fake implementation, dispatch), and each fake output on fake CUDA
  tensors against the plain version's shape and type;
* the portable artifact against the JAX ``export_predictor`` artifact at
  B = 1, 3, 16 (rtol 2e-4, atol 2e-5: JAX's own bars,
  tests/test_export_serving.py) and against the live port (1e-6), and the
  JAX file's other cases: files, label map, swapped weights, unknown
  formats (a JAX artifact among them), short buffers, batch routing and
  chunking over programs pinned at 4 and 16;
* the streaming artifact on JAX's replayed tone stream: the live
  recognizer's label, confidence within rtol 2e-4 / atol 2e-5;
* a CPU-traced program moved to ``meta`` by ``move_to_device_pass``;
* the production graphs of the four serving configurations, traced on
  fake CUDA tensors: which kernel ops each holds;
* loading a portable artifact imports none of the port's model,
  predictor, training or data modules; ``cli.export_model --device cpu``.
"""

import copy
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from speech_intent_recognizer_tpu.config.schema import (
    AudioConfig as JaxAudioConfig)
from speech_intent_recognizer_tpu.infer import export as jax_export
from speech_intent_recognizer_tpu.infer import streaming as jax_streaming
from speech_intent_recognizer_tpu.infer.predict import (
    Predictor as JaxPredictor)
from speech_intent_recognizer_tpu.models.cnn_gru import (
    CNNAudioGRU as FlaxCNNAudioGRU, init_model)
from speech_intent_recognizer_tpu_torch.config import AudioConfig
from speech_intent_recognizer_tpu_torch.convert.jax_bridge import (
    from_jax_variables)
from speech_intent_recognizer_tpu_torch.infer.export import (
    ServingModel, StreamingArtifactPredictor, export_predictor,
    export_streaming, kernel_ops, trace_production)
from speech_intent_recognizer_tpu_torch.infer.predict import Predictor
from speech_intent_recognizer_tpu_torch.infer.streaming import (
    StreamingRecognizer)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
from speech_intent_recognizer_tpu_torch.ops import library
from speech_intent_recognizer_tpu_torch.ops.conv23 import conv23_operands
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    make_frontend_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(conv_channels=(8, 16, 16), gru_hidden=32)
LABELS = {f"intent_{i}": i for i in range(5)}
SHORT = dict(mel_spec_length=48, max_duration=1.5)
RTOL, ATOL = 2e-4, 2e-5  # JAX's bars, tests/test_export_serving.py
SAME = 1e-6  # the port's artifact against the port's live path


def _stats(raw, seed):
    r = np.random.default_rng(seed)
    stats = {}
    for name, s in raw.items():
        c = s["mean"].shape[0]
        stats[name] = {"mean": (0.1 * r.standard_normal(c)).astype(np.float32),
                       "var": r.uniform(0.5, 2.0, c).astype(np.float32)}
    return stats


def _variables(seed):
    raw = init_model(FlaxCNNAudioGRU(num_classes=5, **NARROW),
                     jax.random.key(seed))
    return (jax.tree.map(np.array, raw["params"]),
            _stats(jax.tree.map(np.array, raw["batch_stats"]), seed + 3))


def _port_model(params, stats):
    model = CNNAudioGRU(5, **NARROW)
    model.load_state_dict(from_jax_variables(params, stats))
    return model


@pytest.fixture(scope="module")
def pair():
    """(JAX predictor, port predictor on the CPU): the same narrow
    train-form weights at the short geometry."""
    params, stats = _variables(0)
    want = JaxPredictor(FlaxCNNAudioGRU(num_classes=5, **NARROW),
                        {"params": params, "batch_stats": stats}, LABELS,
                        audio_cfg=JaxAudioConfig(**SHORT))
    return want, Predictor(_port_model(params, stats), LABELS,
                           audio_cfg=AudioConfig(**SHORT), device="cpu")


@pytest.fixture(scope="module")
def artifacts(pair, tmp_path_factory):
    """(JAX artifact, port artifact, the port artifact loaded)."""
    want, port = pair
    d = tmp_path_factory.mktemp("serving")
    jax_dir, port_dir = str(d / "jax"), str(d / "port")
    jax_export.export_predictor(want, jax_dir, platforms=["cpu"])
    export_predictor(port, port_dir)
    return jax_dir, port_dir, ServingModel.load(port_dir, device="cpu")


def _batch(port, b, seed):
    """Noise rows zero past each length, the callers' contract: past it
    the JAX front-end adds its reflection onto what a row holds and the
    port's writes it (ROADMAP Queue 3), so JAX's own test rows, noise
    across the whole buffer, differ between the packages in the front-end,
    not in the export (:func:`test_portable_ignores_samples_past_each_length`)."""
    rng = np.random.default_rng(seed)
    width = port._buffer_width()
    ln = rng.integers(4000, port.audio_cfg.max_samples, b).astype(np.int32)
    wf = (rng.standard_normal((b, width)) * 0.1).astype(np.float32)
    wf[np.arange(width)[None, :] >= ln[:, None]] = 0.0
    return wf, ln


# ----------------------------------------------------------------- the ops


def _op_cases():
    """Small CPU operands of each op, in its schema's order."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    fe = tuple(make_frontend_params())
    wf = torch.zeros((2, 4096))
    wf[:, :3000] = t(2, 3000)
    ln = torch.tensor([3000, 1000], dtype=torch.int32)
    return {
        "frontend_conv1": (wf, ln, t(32, 1, 3, 3), t(32), *fe),
        "frontend": (wf, ln, True, True, *fe),
        "mel_db": (t(3, 1024), *fe),
        "gru_layer": (t(2, 3, 4, 96), t(2, 32, 96), t(2, 1, 32), "", 0),
        "gru_layer_btc": (t(4, 3, 192), t(2, 32, 96), t(2, 1, 32)),
        "conv23": (t(2, 8, 1024).to(torch.bfloat16), *conv23_operands(
            t(64, 32, 3, 3), t(64), t(128, 64, 3, 3), t(128)), 0),
        "bias_relu_pool2": (t(2, 32, 4, 4).contiguous(
            memory_format=torch.channels_last), t(32)),
    }


OPS = sorted(_op_cases())


@pytest.mark.parametrize("name", OPS)
def test_op_passes_opcheck(name):
    """Schema, fake implementation against the CPU (plain) one, dispatch
    and autograd registration of each op on CPU inputs."""
    library.load()
    torch.library.opcheck(getattr(torch.ops.sir, name).default,
                          _op_cases()[name])


@pytest.mark.parametrize("name", OPS)
def test_op_fake_output_on_fake_cuda_tensors(name):
    """Each op's fake output on fake CUDA inputs has the shape and type
    of its plain version's output on the same shapes, and the fake
    implementation launches nothing."""
    library.load()
    op = getattr(torch.ops.sir, name).default
    args = _op_cases()[name]
    want = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                    device="cuda")
                if isinstance(a, torch.Tensor) else a for a in args]
        got = op(*fake)
    assert got.device.type == "cuda"
    assert got.shape == want.shape and got.dtype == want.dtype


# ------------------------------------------------------------ the portable


def test_artifact_files_and_manifest(artifacts):
    _, port_dir, _ = artifacts
    for name in ("program.pt2", "variables.pt", "label_map.json",
                 "manifest.json"):
        assert os.path.getsize(os.path.join(port_dir, name)) > 0
    with open(os.path.join(port_dir, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format"] == "sir_tpu_torch.serving_export.v1"
    assert manifest["flavor"] == "portable" and manifest["ops"] == {}
    assert manifest["platforms"] == ["cpu", "cuda"]
    assert manifest["num_classes"] == 5


@pytest.mark.parametrize("b", [1, 3, 16])
def test_portable_parity_with_jax_and_live(pair, artifacts, b):
    """The port's artifact against the JAX package's on the same weights
    (rtol 2e-4, atol 2e-5) and against the port's live predictor
    (1e-6)."""
    want, port = pair
    jax_dir, _, srv = artifacts
    wf, ln = _batch(port, b, seed=b)
    got = srv.predict_waveform_batch(wf, ln)
    assert got.shape == (b, 5)
    expect = jax_export.ServingModel.load(jax_dir).predict_waveform_batch(
        wf, ln)
    np.testing.assert_allclose(got, expect, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, port.predict_waveform_batch(wf, ln),
                               rtol=0, atol=SAME)


def test_portable_ignores_samples_past_each_length(pair, artifacts):
    """JAX's own test rows (noise across the whole buffer, lengths above
    the left reflection's 512 samples): the port's artifact reads nothing
    past each length, so it gives the zero-padded rows' bits."""
    port = pair[1]
    srv = artifacts[2]
    wf, ln = _batch(port, 16, seed=16)
    noisy = wf.copy()
    past = np.arange(wf.shape[1])[None, :] >= ln[:, None]
    noisy[past] = np.random.default_rng(1).standard_normal(
        int(past.sum())).astype(np.float32) * 0.1
    assert np.array_equal(srv.predict_waveform_batch(noisy, ln),
                          srv.predict_waveform_batch(wf, ln))


def test_label_map_survives(pair, artifacts):
    _, port = pair
    srv = artifacts[2]
    assert srv.label_map == port.label_map
    assert srv.inv_label_map[3] == "intent_3"


def test_swapped_weights_take_effect(pair, artifacts, tmp_path):
    """Another checkpoint's state dict dropped into ``variables.pt``: the
    program serves the new weights (they are loaded, not baked in), as a
    live predictor of those weights does (1e-6)."""
    _, port = pair
    _, port_dir, srv = artifacts
    other = Predictor(_port_model(*_variables(7)), LABELS,
                      audio_cfg=AudioConfig(**SHORT), device="cpu")
    clone = str(tmp_path / "artifact2")
    shutil.copytree(port_dir, clone)
    torch.save(other._fused_body().state_dict(),
               os.path.join(clone, "variables.pt"))
    wf, ln = _batch(port, 2, seed=11)
    swapped = ServingModel.load(clone, device="cpu").predict_waveform_batch(
        wf, ln)
    assert np.abs(srv.predict_waveform_batch(wf, ln) - swapped).max() > 1e-4
    np.testing.assert_allclose(swapped, other.predict_waveform_batch(wf, ln),
                               rtol=0, atol=SAME)


def test_rejects_unknown_formats(artifacts, tmp_path):
    """An unknown format, a JAX artifact, and a serving artifact given to
    the streaming loader are all refused."""
    jax_dir, port_dir, _ = artifacts
    clone = str(tmp_path / "bad")
    shutil.copytree(port_dir, clone)
    with open(os.path.join(clone, "manifest.json"), "w") as f:
        json.dump({"format": "something_else"}, f)
    for path in (clone, jax_dir):
        with pytest.raises(ValueError, match="unrecognized artifact"):
            ServingModel.load(path, device="cpu")
    with pytest.raises(ValueError, match="unrecognized artifact"):
        StreamingArtifactPredictor.load(port_dir, device="cpu")


def test_short_buffer_padded(artifacts):
    srv = artifacts[2]
    rng = np.random.default_rng(5)
    wf = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    out = srv.predict_waveform_batch(wf, np.array([16000, 9000]))
    assert out.shape == (2, 5)
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="exceeds"):
        srv.predict_waveform_batch(np.zeros((1, srv.buffer_width + 1),
                                            np.float32), np.array([10]))


@pytest.mark.parametrize("rows_input", [False, True])
def test_batch_routing_and_chunking(pair, rows_input):
    """The production flavour's routing over programs pinned at 4 and 16
    (smallest adequate program, rows of length 1 filling it, chunks above
    16), with the live batch path pinned at each size in place of the
    traced programs: B = 1, 4, 9, 16, 21, 37 against the live port
    (1e-6)."""
    port = pair[1]
    body = port._fused_body()
    width = port._buffer_width()
    hop = port.audio_cfg.hop_length

    class Pinned:
        def __init__(self, bs):
            self.bs = bs

        def __call__(self, wf, ln):
            assert wf.shape[0] == ln.shape[0] == self.bs
            assert wf.dim() == (3 if rows_input else 2)
            return body(wf, ln)

    manifest = {"buffer_width": width, "flavor": "production"}
    if rows_input:
        manifest["rows_input"] = [width // hop, hop]
    srv = ServingModel({16: Pinned(16), 4: Pinned(4)}, LABELS, manifest,
                       device="cpu")
    for b in (1, 4, 9, 16, 21, 37):
        wf, ln = _batch(port, b, seed=100 + b)
        got = srv.predict_waveform_batch(wf, ln)
        assert got.shape == (b, 5)
        np.testing.assert_allclose(got, port.predict_waveform_batch(wf, ln),
                                   rtol=0, atol=SAME)


def test_production_flavor_needs_the_card(pair, tmp_path):
    with pytest.raises(ValueError, match="CUDA"):
        export_predictor(pair[1], str(tmp_path / "p"), flavor="production")


def test_moved_to_meta_names_no_cpu(artifacts):
    """A program traced on the CPU bakes the CPU into its graph
    (``torch.arange(device=...)``); ``move_to_device_pass`` takes it
    out, and the moved program runs on meta tensors."""
    from torch.export.passes import move_to_device_pass

    _, port_dir, srv = artifacts
    ep = torch.export.load(os.path.join(port_dir, "program.pt2"))
    assert "cpu" in ep.module().code
    module = move_to_device_pass(ep, "meta").module()
    assert "cpu" not in module.code
    assert {t.device.type for t in module.state_dict().values()} == {"meta"}
    out = module(torch.zeros((5, srv.buffer_width), device="meta"),
                 torch.ones(5, dtype=torch.int32, device="meta"))
    assert out.shape == (5, 5) and out.device.type == "meta"


# -------------------------------------------------------------- streaming


def test_streaming_artifact_matches_live_recognizer(pair, tmp_path):
    """JAX's replayed tone stream (tests/test_export_serving.py) through
    the live port recognizer, the port's exported streaming artifact and
    the JAX recognizer: the same label, confidence within rtol 2e-4 /
    atol 2e-5 of the live port's and of JAX's."""
    want, port = pair
    out = str(tmp_path / "stream_artifact")
    export_streaming(port, out)
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format"] == "sir_tpu_torch.streaming_export.v1"
    assert manifest["ops"] == {} and manifest["tail_max"] == 4
    sp = StreamingArtifactPredictor.load(out, device="cpu")
    assert sp.audio_cfg == port.audio_cfg

    rng = np.random.default_rng(3)
    sr, chunk = 16000, 1024
    t = np.arange(int(1.2 * sr)) / sr
    stream = np.concatenate([
        (0.3 * np.sin(2 * np.pi * 250 * t)
         + 0.02 * rng.standard_normal(t.size)).astype(np.float32),
        np.zeros(int(0.8 * sr), np.float32)])

    results = []
    for rec in (StreamingRecognizer(port, chunk_size=chunk, threshold=0.01,
                                    silence_limit=0.5,
                                    featurizer_mode="host"),
                StreamingRecognizer(sp, chunk_size=chunk, threshold=0.01,
                                    silence_limit=0.5,
                                    featurizer_mode="host"),
                jax_streaming.StreamingRecognizer(
                    want, chunk_size=chunk, threshold=0.01,
                    silence_limit=0.5, featurizer_mode="host")):
        r = None
        for i in range(0, len(stream) - chunk, chunk):
            r = r or rec.feed(stream[i : i + chunk])
        results.append(r or rec.flush())
    live, aot, jax_live = results
    assert live is not None and aot is not None and jax_live is not None
    for ref in (live, jax_live):
        assert aot["predicted_label"] == ref["predicted_label"]
        np.testing.assert_allclose(aot["confidence"], ref["confidence"],
                                   rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------- production


@pytest.fixture(scope="module")
def kernel_checkpoint(tmp_path_factory):
    """A train-form checkpoint with the kernels' channels (32, 64, 128)
    and a narrow GRU, at the reference geometry."""
    d = tmp_path_factory.mktemp("kernel_ckpt")
    model = CNNAudioGRU(4, gru_hidden=32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), d / "model.pt")
    (d / "label_map.json").write_text(json.dumps(
        {f"i{i}": i for i in range(4)}))
    return str(d / "model.pt"), str(d / "label_map.json")


@pytest.mark.parametrize("config,want", [
    ("default", {"sir.conv23": 1, "sir.frontend_conv1": 1,
                 "sir.gru_layer_btc": 2}),
    ("pool_torch", {"sir.frontend_conv1": 1, "sir.gru_layer_btc": 2}),
    ("conv23", {"sir.conv23": 1, "sir.frontend_conv1": 1,
                "sir.gru_layer_btc": 2}),
    ("pool_kernel", {"sir.bias_relu_pool2": 2, "sir.frontend_conv1": 1,
                     "sir.gru_layer_btc": 2}),
    ("unfused", {"sir.frontend": 1, "sir.gru_layer_btc": 2}),
])
def test_production_graph_census(kernel_checkpoint, config, want):
    """Each configuration's batch path traced on fake CUDA tensors (what
    ``export_predictor(flavor="production")`` traces on the card): one
    node per kernel launch of the live path, and no convolution where a
    kernel took it (conv1 inside K1; conv2 and conv3 inside K5, by default
    at this geometry and after ``enable_conv23_kernel()``).  The epilogue
    forms go through the predictor's K1 seam (``_serve_k1``).  The GRU
    takes K2 on the GEMM's layout (``sir.gru_layer_btc``, no grad in a
    trace), with no flip, stack or concatenation on what the waveforms
    feed: the program builds the GRU's operands from the weights it loads
    (``TorchGRU.inference_operands`` keeps none in a trace), so a swapped
    ``variables.pt`` takes effect."""
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
        conv1_external_params)

    pred = Predictor.from_checkpoint(
        *kernel_checkpoint, device="cpu", fold_bn=config != "unfused")
    if config in ("pool_torch", "pool_kernel"):
        pred._serve_k1(*conv1_external_params(pred.model.state_dict()),
                       pool_impl=config.removeprefix("pool_"))
    if config == "conv23":
        pred.enable_conv23_kernel()
    body = copy.deepcopy(pred._fused_body())
    width = pred._buffer_width()
    with FakeTensorMode(allow_non_fake_inputs=True):
        body._apply(lambda t: torch.empty_strided(
            t.shape, t.stride(), dtype=t.dtype, device="cuda"))
        ep = trace_production(body, 8, (width // 512, 512), "cuda")
    assert kernel_ops(ep) == want
    fed = set(ep.graph_signature.user_inputs)
    for n in ep.graph.nodes:
        if any(a.name in fed for a in n.all_input_nodes):
            fed.add(n.name)
    glue = [str(n.target) for n in ep.graph.nodes
            if n.name in fed and n.op == "call_function" and any(
                op in str(n.target) for op in ("flip", "stack", "cat."))]
    assert glue == []
    assert not any(".gru." in name for name in ep.constants)
    convs = sum(1 for n in ep.graph.nodes if n.op == "call_function"
                and "conv2d" in str(n.target))
    assert convs == {"default": 0, "conv23": 0, "unfused": 3}.get(config, 2)
    assert all("cpu" not in str(n.kwargs.get("device", ""))
               for n in ep.graph.nodes)


# ------------------------------------------------------------ the loaders


def test_loading_imports_only_what_it_needs(artifacts):
    """A fresh process loads the portable artifact and predicts; it has
    imported no JAX and none of the port's model, predictor, training or
    data modules, nor the kernels' ops."""
    _, port_dir, srv = artifacts
    code = f"""
import sys
import numpy as np
from speech_intent_recognizer_tpu_torch.infer.export import ServingModel
srv = ServingModel.load({port_dir!r}, device="cpu")
out = srv.predict_waveform_batch(np.zeros((2, 8000), np.float32),
                                 np.array([8000, 4000]))
assert out.shape == (2, 5), out.shape
pkg = "speech_intent_recognizer_tpu_torch"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax")
             or m.startswith((pkg + ".models", pkg + ".infer.predict",
                              pkg + ".train", pkg + ".data",
                              pkg + ".ops")))
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_export_model(tmp_path):
    """``cli.export_model --device cpu`` on the narrow ``.pt`` fixture:
    ``ServingModel`` serves it within 1e-6 of ``Predictor``; and with
    ``--model_type wav2vec`` on a tiny ``Wav2VecIntent`` checkpoint, served
    within 1e-6 of ``Wav2VecPredictor``."""
    from speech_intent_recognizer_tpu_torch.cli.export_model import main

    data = os.path.join(REPO, "tests", "data")
    cfg = tmp_path / "short.yaml"
    cfg.write_text("mel_spec_length: 48\nmax_duration: 1.5\n")
    args = ["--model", os.path.join(data, "narrow_model.pt"),
            "--label_map", os.path.join(data, "narrow_label_map.json"),
            "--config", str(cfg), "--device", "cpu"]
    out = str(tmp_path / "artifact")
    assert main(args + ["--out", out]) == 0
    pred = Predictor.from_checkpoint(
        os.path.join(data, "narrow_model.pt"),
        os.path.join(data, "narrow_label_map.json"),
        audio_cfg=AudioConfig(**SHORT), device="cpu")
    wf, ln = _batch(pred, 3, seed=21)
    np.testing.assert_allclose(
        ServingModel.load(out, device="cpu").predict_waveform_batch(wf, ln),
        pred.predict_waveform_batch(wf, ln), rtol=0, atol=SAME)
    from speech_intent_recognizer_tpu_torch.infer.predict import (
        Wav2VecPredictor)
    from speech_intent_recognizer_tpu_torch.models.wav2vec import (
        Wav2VecIntent, small_wav2vec_config)

    model = Wav2VecIntent(small_wav2vec_config(32, 1), 5)
    model.reset_parameters(torch.Generator().manual_seed(1))
    torch.save(model.state_dict(), tmp_path / "w2v.pt")
    w2v_args = ["--model", str(tmp_path / "w2v.pt"),
                "--label_map", os.path.join(data, "narrow_label_map.json"),
                "--config", str(cfg), "--device", "cpu",
                "--model_type", "wav2vec"]
    w2v_out = str(tmp_path / "w2v")
    assert main(w2v_args + ["--out", w2v_out]) == 0
    live = Wav2VecPredictor.from_checkpoint(
        str(tmp_path / "w2v.pt"), os.path.join(data, "narrow_label_map.json"),
        audio_cfg=AudioConfig(**SHORT), device="cpu")
    rng = np.random.default_rng(22)
    wf = (0.1 * rng.standard_normal((3, live._buffer_width()))).astype(
        np.float32)
    ln = np.array([24000, 9000, 20], np.int32)
    np.testing.assert_allclose(
        ServingModel.load(w2v_out, device="cpu").predict_waveform_batch(
            wf, ln), live.predict_waveform_batch(wf, ln), rtol=0, atol=SAME)


def test_export_module_imports_nothing_else():
    """``infer.export`` alone (what a serving host imports) pulls in no
    other module of the port."""
    code = """
import sys
import speech_intent_recognizer_tpu_torch.infer.export
mods = sorted(m for m in sys.modules
              if m.startswith("speech_intent_recognizer_tpu_torch."))
assert mods == ["speech_intent_recognizer_tpu_torch.infer",
                "speech_intent_recognizer_tpu_torch.infer.export"], mods
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
