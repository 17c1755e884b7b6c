"""The wav2vec family of the torch port against the JAX package: the
backbone (base and stable variants) and ``Wav2VecIntent``, the checkpoint
converters, ``Wav2VecPredictor``, manifest evaluation and the serving
export, at tiny configs on the CPU.  Weights are made by the JAX package
and carried to the port through ``convert.wav2vec_import.from_jax_params``;
inputs are seeded numpy."""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# transformers imports TensorFlow when it finds it (~10 s here), which
# neither package's wav2vec code uses
os.environ.setdefault("USE_TF", "0")

transformers = pytest.importorskip("transformers")

from speech_intent_recognizer_tpu.models import wav2vec as jw  # noqa: E402

from speech_intent_recognizer_tpu_torch.config import AudioConfig  # noqa
from speech_intent_recognizer_tpu_torch.convert import (  # noqa: E402
    wav2vec_import as wi)
from speech_intent_recognizer_tpu_torch.data.audio_io import (  # noqa: E402
    save_wav)
from speech_intent_recognizer_tpu_torch.infer.export import (  # noqa: E402
    ServingModel, export_predictor, kernel_ops, trace_production)
from speech_intent_recognizer_tpu_torch.infer.predict import (  # noqa: E402
    Wav2VecPredictor)
from speech_intent_recognizer_tpu_torch.models import wav2vec as pw  # noqa
from speech_intent_recognizer_tpu_torch.models.wav2vec_backbone import (  # noqa
    Wav2Vec2Backbone, feat_extract_output_lengths)

L = 4000
LENGTHS = (4000, 2000, 30)  # full, half, under the 40-sample receptive
# field of the tiny configs: feature length <= 0
BAR = 1e-4  # the JAX package's own bar against transformers
# (tests/test_wav2vec_parity.py:56); differences come from the norms'
# variance formula (Flax E[x^2] - E[x]^2, torch two-pass) and summation order
LABELS = {f"intent_{i}": i for i in range(4)}
SHORT = AudioConfig(max_duration=0.5)  # 8000-sample buffers


def _configs(variant, **changes):
    """(JAX transformers config, port config) of the tiny model."""
    make = {"base": "small_wav2vec_base_config",
            "stable": "small_wav2vec_config"}[variant]
    jcfg = getattr(jw, make)(hidden_size=32, num_layers=2)
    for k, v in changes.items():
        setattr(jcfg, k, v)
    return jcfg, pw.Wav2Vec2Config.from_dict(jcfg.to_dict())


def _batch(lengths=LENGTHS, width=L, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), width), np.float32)
    for i, n in enumerate(lengths):
        x[i, :n] = 0.1 * rng.standard_normal(n)
    mask = (np.arange(width)[None] < np.asarray(lengths)[:, None])
    return x, mask.astype(np.int32)


def _applier(jmodel, train=False):
    """``jmodel.apply`` under ``jax.jit`` (Flax run op by op compiles each
    operation on the CPU: ~10x slower here) -> (logits, backbone hidden)."""
    def run(params, x, mask, mti, key):
        logits, state = jmodel.apply(
            {"params": params}, x, mask, train=train, mask_time_indices=mti,
            rngs={"dropout": key}, capture_intermediates=True,
            mutable=["intermediates"])
        return logits, state["intermediates"]["wav2vec2"]["__call__"][0]

    jitted = jax.jit(run)
    return lambda params, x, mask, mti=None: jax.tree.map(
        np.asarray, jitted(params, x, mask, mti, jax.random.key(5)))


def _jax_params(jmodel, seed):
    """Initialised params with every bias, norm scale and the mask embedding
    moved off its initial value, so that no term is zero or one."""
    init = jax.jit(lambda k: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, L)),
        jnp.ones((1, L), jnp.int32), train=False))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   .astype(np.float32)) if a.ndim == 1 else np.asarray(a),
        init(jax.random.key(seed))["params"])


def _port(pcfg, params, dtype=torch.float32):
    port = pw.Wav2VecIntent(pcfg, 4, dtype)
    port.load_state_dict(wi.from_jax_params(params))
    return port.eval()


@pytest.fixture(scope="module")
def models():
    """Per variant: the JAX model, its params, the port's model with those
    weights, the jitted JAX forward."""
    out = {}
    for i, variant in enumerate(("base", "stable")):
        jcfg, pcfg = _configs(variant)
        jmodel = jw.Wav2VecIntent(config=jcfg, num_classes=4)
        params = _jax_params(jmodel, i)
        out[variant] = (jmodel, params, _port(pcfg, params),
                        _applier(jmodel))
    return out


@pytest.fixture(scope="module")
def hf_models():
    """Per variant, a seeded ``transformers.Wav2Vec2Model``."""
    out = {}
    with torch.random.fork_rng():
        for variant in ("base", "stable"):
            torch.manual_seed(0)
            out[variant] = transformers.Wav2Vec2Model(
                _configs(variant)[0]).eval()
    return out


VARIANTS = ["base", "stable"]

# ------------------------------------------------------------------ config


def test_config_defaults_and_dict_round_trip():
    """The port's defaults are transformers' (wav2vec2-base) on every field
    it keeps; ``from_dict`` reads a full ``to_dict()`` (~100 keys)."""
    ref = transformers.Wav2Vec2Config()
    mine = pw.Wav2Vec2Config()
    for name, value in mine.to_dict().items():
        got = getattr(ref, name)
        assert (list(got) if isinstance(got, (list, tuple)) else got) \
            == value, name
    assert pw.Wav2Vec2Config.from_dict(ref.to_dict()) == mine
    assert pw.Wav2Vec2Config.from_dict(mine.to_dict()) == mine
    for make in ("small_wav2vec_config", "small_wav2vec_base_config"):
        assert getattr(pw, make)(48, 3) == pw.Wav2Vec2Config.from_dict(
            getattr(jw, make)(48, 3).to_dict())


# ---------------------------------------------------------------- backbone


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_backbone_and_intent_match_jax(models, variant, masked):
    """Eval mode, fp32, a padded batch with a row of feature length <= 0,
    with and without the same ``mask_time_indices``: the backbone's hidden
    states and ``Wav2VecIntent``'s logits (unmasked pooling head) within
    rtol / atol 1e-4."""
    jmodel, params, port, apply = models[variant]
    x, mask = _batch()
    t_out = int(feat_extract_output_lengths(port.config, torch.tensor(L)))
    assert int(feat_extract_output_lengths(
        port.config, torch.tensor(LENGTHS[2]))) <= 0
    mti = None
    if masked:
        mti = np.random.default_rng(3).random((3, t_out)) < 0.3
    want, want_hidden = apply(params, x, mask, mti)
    with torch.no_grad():
        tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
        tmti = None if mti is None else torch.from_numpy(mti)
        hidden = port.wav2vec(tx, tm, tmti)
        got = port(tx, tm, tmti)
    assert hidden.shape == want_hidden.shape == (3, t_out, 32)
    assert float(np.abs(want_hidden[2]).max()) > 0.1  # the masked row
    np.testing.assert_allclose(hidden.numpy(), want_hidden, rtol=BAR,
                               atol=BAR)
    np.testing.assert_allclose(got.numpy(), want, rtol=BAR, atol=BAR)


@pytest.mark.parametrize("layerdrop", [0.0, 1.0])
def test_train_mode_matches_jax(models, layerdrop):
    """Train mode with every dropout at 0 and LayerDrop 0 or 1 is
    deterministic in both packages: logits within rtol / atol 1e-4."""
    zero = dict(hidden_dropout=0.0, attention_dropout=0.0,
                activation_dropout=0.0, feat_proj_dropout=0.0,
                layerdrop=layerdrop)
    jcfg, pcfg = _configs("base", **zero)
    params = models["base"][1]
    want, _ = _applier(jw.Wav2VecIntent(config=jcfg, num_classes=4),
                       train=True)(params, *_batch(seed=2))
    port = _port(pcfg, params).train()
    x, mask = _batch(seed=2)
    got = port(torch.from_numpy(x), torch.from_numpy(mask),
               generator=torch.Generator().manual_seed(5))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=BAR,
                               atol=BAR)


def test_bf16_matches_jax_bf16(models):
    """bf16 compute (per-module casts as Flax does them): logits within
    2e-2 of the largest magnitude of JAX's bf16 logits."""
    jcfg, pcfg = _configs("base")
    params = models["base"][1]
    jmodel = jw.Wav2VecIntent(config=jcfg, num_classes=4,
                              compute_dtype=jnp.bfloat16)
    x, mask = _batch(seed=3)
    want, _ = _applier(jmodel)(params, x, mask)
    with torch.no_grad():
        got = _port(pcfg, params, torch.bfloat16)(torch.from_numpy(x),
                                                  torch.from_numpy(mask))
    assert got.dtype == torch.float32
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 2e-2 * float(np.abs(want).max()), err


# -------------------------------------------------------------- converters


def _old_weight_norm_keys(state):
    """The ``weight_g`` / ``weight_v`` form older transformers wrote."""
    rename = {"parametrizations.weight.original0": "weight_g",
              "parametrizations.weight.original1": "weight_v"}
    out = {}
    for k, v in state.items():
        for new, old in rename.items():
            k = k.replace(new, old)
        out[k] = v
    return out


@pytest.mark.parametrize("form", ["parametrizations", "weight_g"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_transformers_state_dict_converts(hf_models, variant, form):
    """A seeded ``transformers.Wav2Vec2Model``'s state dict, in either
    weight-norm key form, through the port's converter: hidden states on
    each row's valid frames within rtol / atol 1e-4 of transformers' own
    (transformers leaves padded frames unspecified)."""
    hf = hf_models[variant]
    state = hf.state_dict()
    if form == "weight_g":
        state = _old_weight_norm_keys(state)
    port = Wav2Vec2Backbone(pw.Wav2Vec2Config.from_dict(
        hf.config.to_dict())).eval()
    port.load_state_dict(wi.convert_wav2vec_state_dict(state))
    x, mask = _batch(seed=4)
    with torch.no_grad():
        want = hf(torch.from_numpy(x),
                  attention_mask=torch.from_numpy(mask)).last_hidden_state
        got = port(torch.from_numpy(x), torch.from_numpy(mask))
    valid = feat_extract_output_lengths(port.config, torch.tensor(LENGTHS))
    for i, n in enumerate(valid.tolist()):
        np.testing.assert_allclose(got[i, :max(n, 0)].numpy(),
                                   want[i, :max(n, 0)].numpy(), rtol=BAR,
                                   atol=BAR)


@pytest.mark.parametrize("prefix", ["wav2vec.", "wav2vec2."])
@pytest.mark.parametrize("variant", VARIANTS)
def test_reference_intent_state_dict(models, hf_models, variant, prefix):
    """A reference-layout ``Wav2VecIntent`` state dict (weight-norm pair
    unfolded, backbone under either prefix): the port's converter and the
    JAX package's read it into models whose logits agree within rtol /
    atol 1e-4."""
    from speech_intent_recognizer_tpu.convert.wav2vec_import import (
        convert_wav2vec_intent_state_dict as jax_convert)

    _, _, port, apply = models[variant]
    rng = np.random.default_rng(11)
    state = {f"{prefix}{k}": v
             for k, v in hf_models[variant].state_dict().items()}
    for name, shape in (("attention.weight", (1, 32)),
                        ("attention.bias", (1,)), ("fc.weight", (4, 32)),
                        ("fc.bias", (4,))):
        state[name] = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))
    mine, n = wi.convert_wav2vec_intent_state_dict(state)
    assert n == 4 and all(k.startswith(("wav2vec.", "attention.", "fc."))
                          for k in mine)
    model = pw.Wav2VecIntent(port.config, 4)
    model.load_state_dict(mine)
    jparams, _ = jax_convert({k: v.numpy() for k, v in state.items()})
    x, mask = _batch(seed=5)
    want, _ = apply(jparams, x, mask)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=BAR, atol=BAR)


@pytest.mark.parametrize("variant", VARIANTS)
def test_infer_config_matches_jax(hf_models, variant):
    from speech_intent_recognizer_tpu.convert.wav2vec_import import (
        infer_wav2vec_config as jax_infer)

    state = hf_models[variant].state_dict()
    mine = wi.infer_wav2vec_config(state)
    ref = jax_infer({k: v.numpy() for k, v in state.items()})
    assert mine == pw.Wav2Vec2Config.from_dict(ref.to_dict())


@pytest.mark.parametrize("variant", VARIANTS)
def test_jax_params_round_trip(models, variant):
    """JAX params -> the port's state dict -> the JAX converter's layout:
    every leaf back exactly."""
    from speech_intent_recognizer_tpu.convert.wav2vec_import import (
        convert_wav2vec_intent_state_dict as jax_convert)

    _, params, port, _ = models[variant]
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    back, n = jax_convert(state)
    assert n == 4
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("safe", [True, False])
def test_save_pretrained_dir_through_cli(hf_models, tmp_path, safe):
    """A ``save_pretrained`` directory (safetensors or ``.bin``) through
    ``cli.convert_wav2vec --device cpu``: the backbone's hidden states
    within rtol / atol 1e-4 of transformers', a fresh head, the config
    beside the ``.pt``; the safetensors reader equals
    ``safetensors.torch.load_file`` on the same file, bit for bit."""
    from speech_intent_recognizer_tpu_torch.cli.convert_wav2vec import main
    from speech_intent_recognizer_tpu_torch.convert.safetensors import (
        load_file)

    hf = hf_models["base"]
    d = tmp_path / "w2v"
    hf.save_pretrained(str(d), safe_serialization=safe)
    if safe:
        ref = pytest.importorskip("safetensors.torch").load_file(
            str(d / "model.safetensors"))
        mine = load_file(str(d / "model.safetensors"))
        assert sorted(mine) == sorted(ref)
        for k in ref:
            assert mine[k].dtype == ref[k].dtype
            assert torch.equal(mine[k], ref[k]), k
    out = tmp_path / "w2v.pt"
    assert main(["--checkpoint", str(d), "--num_classes", "4", "--output",
                 str(out), "--device", "cpu"]) == 0
    meta = json.loads((tmp_path / "w2v.json").read_text())
    assert meta["num_classes"] == 4
    pred = Wav2VecPredictor.from_checkpoint(str(out), _label_map(tmp_path),
                                            audio_cfg=SHORT, device="cpu")
    x, _ = _batch(seed=6)
    with torch.no_grad():
        want = hf(torch.from_numpy(x)).last_hidden_state
        got = pred.model.wav2vec(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=BAR,
                               atol=BAR)


# --------------------------------------------------------------- predictor


def _label_map(d):
    path = os.path.join(str(d), "label_map.json")
    with open(path, "w") as f:
        json.dump(LABELS, f)
    return path


def _wavs(d, n=6, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        m = int(rng.integers(2000, 9000))  # some longer than the buffer
        t = np.arange(m) / 16000
        x = (0.3 * np.sin(2 * np.pi * (300 + 150 * i) * t)
             + 0.05 * rng.standard_normal(m)).astype(np.float32)
        p = os.path.join(str(d), f"{i:02d}.wav")
        save_wav(p, x, 16000)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def checkpoint(models, tmp_path_factory):
    """The JAX trainer's ``.msgpack`` + ``.json`` sidecar (``save_model``),
    a label map, a JAX predictor on it, and WAVs."""
    from speech_intent_recognizer_tpu.config.schema import (
        AudioConfig as JaxAudio)
    from speech_intent_recognizer_tpu.infer.predict import (
        Wav2VecPredictor as JaxPredictor)
    from speech_intent_recognizer_tpu.train.checkpoint import save_model

    d = tmp_path_factory.mktemp("w2v_ckpt")
    jmodel, params, _, _ = models["base"]
    path = str(d / "wav2vec_intent.msgpack")
    save_model(path, {"params": params},
               meta={"num_classes": 4, "model": "wav2vec",
                     "wav2vec_config": jmodel.config.to_dict()})
    lm = _label_map(d)
    jpred = JaxPredictor.from_checkpoint(path, lm,
                                         audio_cfg=JaxAudio(max_duration=0.5))
    return path, lm, jpred, _wavs(d), str(d)


@pytest.fixture(scope="module")
def predictor(checkpoint):
    return Wav2VecPredictor.from_checkpoint(checkpoint[0], checkpoint[1],
                                            audio_cfg=SHORT, device="cpu")


@pytest.mark.parametrize("b", [1, 3])
def test_predictor_matches_jax(checkpoint, predictor, b):
    """``predict_waveform_batch`` from the same ``.msgpack`` + sidecar:
    rtol 1e-4 / atol 1e-5 of the JAX predictor's probabilities."""
    jpred = checkpoint[2]
    x, _ = _batch(LENGTHS[:b], width=8000, seed=8)
    ln = np.asarray([8000, 4000, 30][:b], np.int32)
    np.testing.assert_allclose(predictor.predict_waveform_batch(x, ln),
                               jpred.predict_waveform_batch(x, ln),
                               rtol=1e-4, atol=1e-5)
    assert predictor._buffer_width() == 8000


def test_predict_file_directory_and_bare_pt(checkpoint, predictor,
                                            tmp_path):
    """``predict_file`` and ``predict_directory`` as the JAX predictor's
    (confidence 1e-5); a bare reference ``.pt`` with no sidecar infers its
    config and serves the same probabilities (1e-6)."""
    path, lm, jpred, wavs, d = checkpoint
    for w in wavs[:2]:
        got, want = predictor.predict_file(w), jpred.predict_file(w)
        assert got["predicted_label"] == want["predicted_label"]
        assert abs(got["confidence"] - want["confidence"]) <= 1e-5
    results = predictor.predict_directory(d)
    assert [r["file"] for r in results] == [os.path.basename(w)
                                            for w in wavs]
    bare = str(tmp_path / "ref.pt")
    torch.save({("wav2vec2." + k[len("wav2vec."):]
                 if k.startswith("wav2vec.") else k): v
                for k, v in predictor.model.state_dict().items()}, bare)
    other = Wav2VecPredictor.from_checkpoint(bare, lm, audio_cfg=SHORT,
                                             device="cpu")
    assert other.model.config == predictor.model.config.replace(
        num_attention_heads=1)  # the config inferred: hidden // 64 heads
    x, _ = _batch((8000,), width=8000, seed=9)
    assert other.predict_waveform_batch(x, [8000]).shape == (1, 4)
    if not torch.cuda.is_available():  # the card is the default
        with pytest.raises((RuntimeError, AssertionError)):
            Wav2VecPredictor.from_checkpoint(path, lm)


def test_evaluate_manifest_matches_jax(checkpoint, predictor, tmp_path):
    """A 6-file manifest with one label outside the map: accuracy, report
    and confusion matrix equal to the JAX function's; the report files
    written."""
    from speech_intent_recognizer_tpu.data.manifest import (
        read_manifest as jax_read)
    from speech_intent_recognizer_tpu.evaluation.evaluate import (
        evaluate_manifest_with_predictor as jax_eval)
    from speech_intent_recognizer_tpu_torch.data.manifest import (
        read_manifest)
    from speech_intent_recognizer_tpu_torch.evaluation.evaluate import (
        evaluate_manifest_with_predictor)

    wavs, jpred = checkpoint[3], checkpoint[2]
    csv = tmp_path / "m.csv"
    names = list(LABELS) + ["not_in_map", "intent_0"]
    csv.write_text("path,label\n" + "".join(
        f"{w},{names[i]}\n" for i, w in enumerate(wavs)))
    got = evaluate_manifest_with_predictor(predictor, read_manifest(str(csv)),
                                           str(tmp_path / "out"))
    want = jax_eval(jpred, jax_read(str(csv)), None)
    assert got["accuracy"] == want["accuracy"]
    assert got["report"] == want["report"]
    np.testing.assert_array_equal(got["confusion_matrix"],
                                  want["confusion_matrix"])
    assert got["confusion_matrix"].shape == (5, 5)
    assert (tmp_path / "out" / "classification_report.txt").exists()


# ------------------------------------------------------------------ export


def test_portable_artifact(predictor, checkpoint, tmp_path):
    """The portable artifact serves within 1e-6 of the live port at B = 1
    and 3, holds no kernel op, says ``Wav2VecIntent``, and its loader
    refuses a JAX artifact."""
    out = export_predictor(predictor, str(tmp_path / "art"))
    manifest = json.loads((tmp_path / "art" / "manifest.json").read_text())
    assert manifest["model"] == "Wav2VecIntent" and manifest["ops"] == {}
    assert manifest["buffer_width"] == 8000 and "rows_input" not in manifest
    srv = ServingModel.load(out, device="cpu")
    for b in (1, 3):
        x, _ = _batch(LENGTHS[:b], width=8000, seed=10 + b)
        ln = np.asarray([8000, 4000, 30][:b], np.int32)
        np.testing.assert_allclose(srv.predict_waveform_batch(x, ln),
                                   predictor.predict_waveform_batch(x, ln),
                                   rtol=0, atol=1e-6)
    jax_dir = tmp_path / "jax_art"
    shutil.copytree(out, jax_dir)
    (jax_dir / "manifest.json").write_text(json.dumps(
        {**manifest, "format": "sir_tpu.serving_export.v1"}))
    with pytest.raises(ValueError, match="unrecognized artifact"):
        ServingModel.load(str(jax_dir), device="cpu")


def test_production_trace_has_no_kernel_op(predictor):
    """``Wav2VecPredictor._fused_body()`` traced on fake CUDA tensors (what
    the production flavour traces on the card): no ``sir`` node."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    body = copy.deepcopy(predictor._fused_body())
    with FakeTensorMode(allow_non_fake_inputs=True):
        # fake CPU tensors: a CPU-only torch cannot trace the masks'
        # torch.arange(device="cuda"), and nothing in the path dispatches
        # on the device (no kernel wrapper), so this is the card's graph
        body._apply(lambda t: torch.empty_strided(
            t.shape, t.stride(), dtype=t.dtype))
        ep = trace_production(body, 8, (8000,), "cpu")
    assert kernel_ops(ep) == {}
    assert any("conv1d" in str(n.target) for n in ep.graph.nodes)
