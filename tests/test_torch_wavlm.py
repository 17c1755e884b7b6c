"""WavLM on the port's wav2vec path (``model_type="wavlm"``), on the CPU at
a small size: the bucket table against transformers', ``Wav2VecIntent``
against the benchmark's plain reference (``perfbench/reference/
wavlm_large.py``, loaded by path) and the backbone against a seeded
``transformers.WavLMModel`` through the importer, the four faults of the
gated bias past the cell's limit, train-mode gradients of the bias's
leaves against the reference's autograd, the model-group refusal, the
spans and the table cache, and ``save_pretrained`` checkpoints through
the importer and ``Wav2VecPredictor.from_checkpoint``.

The small config (hidden 64, 2 layers, 4 heads, 3 convs, 16 buckets out
to 24 frames) gives rows of ~40 frames, so the exact, the log-spaced and
the clamped buckets are all used.  Only the reference side uses
``transformers``."""

import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

# transformers imports TensorFlow when it finds it (~10 s here), which
# neither side uses
os.environ.setdefault("USE_TF", "0")

transformers = pytest.importorskip("transformers")

from speech_intent_recognizer_tpu_torch.convert import (  # noqa: E402
    wav2vec_import as wi)
from speech_intent_recognizer_tpu_torch.infer.predict import (  # noqa: E402
    Wav2VecPredictor)
from speech_intent_recognizer_tpu_torch.models import wav2vec as pw  # noqa
from speech_intent_recognizer_tpu_torch.models import (  # noqa: E402
    wav2vec_backbone as wb)
from speech_intent_recognizer_tpu_torch.utils import profiling  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, conv_dim=[32, 32, 32],
             conv_kernel=[10, 3, 3], conv_stride=[5, 2, 2],
             num_feat_extract_layers=3, conv_bias=False,
             feat_extract_norm="layer", do_stable_layer_norm=True,
             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
             num_buckets=16, max_bucket_distance=24, layer_norm_eps=1e-5)
WIDTH = 820  # 40 frames
LENGTHS = (820, 500, 300)  # 40, 24 and 14 valid frames
CLASSES = 5
LIMIT = 1.5e-4  # the cell's logp_gap limit (perfbench/traffic/infer.b64.json)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load(os.path.join(REPO, "perfbench", "reference", "wavlm_large.py"),
            "wavlm_large_reference")
FAULTS = _load(os.path.join(REPO, "perfbench", "tests", "wavlm_faults.py"),
               "wavlm_faults").FAULTS


def _cfg():
    return dict(SMALL, num_classes=CLASSES)


def _state(seed=0):
    """The reference's state dict, drawn from its ``weight_spec``."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind, a, b in REF.weight_spec(_cfg()):
        if kind == "uniform":
            out[name] = a + (b - a) * torch.rand(shape, generator=g)
        else:
            out[name] = a + b * torch.randn(shape, generator=g)
    return out


def _batch(seed=0, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), WIDTH), np.float32)
    for i, n in enumerate(lengths):
        x[i, :n] = 0.1 * rng.standard_normal(n)
    return torch.from_numpy(x), torch.tensor(lengths)


def _port(state, **changes):
    model = pw.Wav2VecIntent(pw.Wav2Vec2Config.from_dict(
        dict(SMALL, model_type="wavlm", **changes)), CLASSES)
    model.load_state_dict(state)
    return model.eval()


def _mask(x, lengths):
    return torch.arange(x.shape[1])[None, :] < lengths[:, None]


def _gap(got, want):
    """The widest log-probability gap of two sets of logits."""
    return float((torch.log_softmax(got.double(), -1)
                  - torch.log_softmax(want.double(), -1)).abs().max())


def _hf_model(seed=0):
    """A seeded ``transformers.WavLMModel`` at the small size, the gate's
    leaves drawn off their initial values (its 0.02-wide dense weights
    leave every gate near one value, and its constant is 1), so that a
    port that mishandled either would differ."""
    cfg = transformers.WavLMConfig(**SMALL)
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        hf = transformers.WavLMModel(cfg).eval()
        with torch.no_grad():
            for name, p in hf.named_parameters():
                if "gru_rel_pos_const" in name:
                    p.uniform_(0.5, 1.5)
                elif "gru_rel_pos_linear.weight" in name:
                    p.normal_(0.0, 1.0 / 8)
    return hf


# ------------------------------------------------------------------ table


@pytest.mark.parametrize("t", [1, 49, 249, 1500])
def test_bucket_table_is_transformers_at_the_published_sizes(t):
    """Bit for bit at (320, 800) buckets and distance, WavLM-Large's."""
    attn = transformers.models.wavlm.modeling_wavlm.WavLMAttention(
        1024, 16, num_buckets=320, max_distance=800)
    pos = torch.arange(t)
    want = attn._relative_positions_bucket(pos[None, :] - pos[:, None])
    got = wb.relative_position_buckets(t, 320, 800)
    assert got.dtype == torch.long and torch.equal(got, want)
    assert torch.equal(REF.buckets(t, 320, 800), want)


def test_config_reads_and_writes_transformers_wavlm_keys():
    hf = transformers.WavLMConfig()
    mine = pw.Wav2Vec2Config.from_dict(hf.to_dict())
    assert (mine.model_type, mine.num_buckets, mine.max_bucket_distance,
            mine.do_stable_layer_norm) == ("wavlm", 320, 800, False)
    assert pw.Wav2Vec2Config.from_dict(mine.to_dict()) == mine
    base = pw.Wav2Vec2Config().to_dict()
    assert base["model_type"] == "wav2vec2" and "num_buckets" not in base
    with pytest.raises(ValueError, match="model_type"):
        pw.Wav2Vec2Config(model_type="hubert")


# -------------------------------------------------------------- reference


def test_intent_matches_the_plain_reference():
    """fp32 on both sides, other summation orders: within 1e-5 in
    log-probability (the benchmark's own bar for the base model), on rows
    of 40, 24 and 14 valid frames."""
    state = _state(1)
    x, n = _batch(1)
    with torch.no_grad():
        got = _port(state)(x, _mask(x, n))
        want = REF.logits(state, _cfg(), x, n, lambda a: a.float())
    assert _gap(got, want) < 1e-5
    # the bias moves the answer: the same model with E zeroed is far off
    off = dict(state)
    off[REF.REL] = torch.zeros_like(state[REF.REL])
    with torch.no_grad():
        assert _gap(_port(off)(x, _mask(x, n)), want) > 100 * LIMIT


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_of_the_bias_reads_past_the_limit(fault):
    state = _state(2)
    x, n = _batch(2)
    with torch.no_grad():
        want = REF.logits(state, _cfg(), x, n, lambda a: a.float())
        with FAULTS[fault]():
            got = _port(state)(x, _mask(x, n))
    assert _gap(got, want) > 10 * LIMIT


def test_train_mode_gradients_of_the_bias_leaves_match_the_reference():
    """Train mode with every dropout at 0 (so the two sides compute the
    same function): the gradients of the mean cross-entropy with respect
    to E, every gate's dense weight and bias and every gate constant
    within 1e-4 of each leaf's norm (fp32, other summation orders)."""
    state = _state(3)
    x, n = _batch(3)
    labels = torch.tensor([0, 3, 1])
    model = _port(state, hidden_dropout=0.0, attention_dropout=0.0,
                  activation_dropout=0.0, layerdrop=0.0).train()
    torch.nn.functional.cross_entropy(model(x, _mask(x, n)),
                                      labels).backward()
    ref_state = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    torch.nn.functional.cross_entropy(
        REF.logits(ref_state, _cfg(), x, n, lambda a: a.float()),
        labels).backward()
    grads = dict(model.named_parameters())
    leaves = [k for k in state if "rel_attn_embed" in k or "gru_rel_pos" in k]
    assert len(leaves) == 1 + 3 * SMALL["num_hidden_layers"]
    for k in leaves:
        got, want = grads[k].grad, ref_state[k].grad
        assert float(want.norm()) > 0, k
        assert float((got - want).norm()) < 1e-4 * float(want.norm()), k


def test_training_with_dropout_runs_through_the_same_code():
    model = _port(_state(4)).train()
    x, n = _batch(4)
    g = torch.Generator().manual_seed(0)
    model(x, _mask(x, n), generator=g).sum().backward()
    attn = model.wav2vec.encoder.layers[0].attention
    for p in (attn.rel_attn_embed.weight, attn.gru_rel_pos_const,
              attn.gru_rel_pos_linear.weight):
        assert p.grad is not None and torch.isfinite(p.grad).all()
        assert float(p.grad.abs().max()) > 0


def test_init_draws_the_new_leaves():
    model = pw.Wav2VecIntent(pw.Wav2Vec2Config.from_dict(
        dict(SMALL, model_type="wavlm")), CLASSES)
    model.reset_parameters(torch.Generator().manual_seed(0))
    enc = model.wav2vec.encoder
    e = enc.layers[0].attention.rel_attn_embed.weight.detach()
    assert e.shape == (16, 4) and 0.5 < float(e.std()) < 1.5
    for layer in enc.layers:
        a = layer.attention
        assert torch.equal(a.gru_rel_pos_const, torch.ones(1, 4, 1, 1))
        w = a.gru_rel_pos_linear.weight.detach()
        assert float(w.std()) == pytest.approx(1 / math.sqrt(16), rel=0.5)
    assert not hasattr(enc.layers[1].attention, "rel_attn_embed")


def test_a_model_group_is_refused():
    model = _port(_state(5))
    with pytest.raises(ValueError, match="WavLM"):
        model.set_model_group(object())
    assert model.model_group is None
    model.set_model_group(None)
    base = pw.Wav2VecIntent(pw.Wav2Vec2Config.from_dict(
        dict(SMALL, num_buckets=7)), CLASSES)
    group = object()
    base.set_model_group(group)
    assert base.wav2vec.encoder.layers[0].attention.model_group is group


# ----------------------------------------------------------- transformers


def test_backbone_matches_transformers_through_the_importer():
    """Hidden states on each row's valid frames within 1e-5 (fp32, other
    summation orders; transformers leaves padded frames unspecified)."""
    hf = _hf_model()
    port = wb.Wav2Vec2Backbone(pw.Wav2Vec2Config.from_dict(
        hf.config.to_dict())).eval()
    port.load_state_dict(wi.convert_wav2vec_state_dict(hf.state_dict()))
    x, n = _batch(6)
    mask = _mask(x, n)
    with torch.no_grad():
        want = hf(x, attention_mask=mask.int()).last_hidden_state
        got = port(x, mask)
    valid = wb.feat_extract_output_lengths(port.config, n)
    for i, m in enumerate(valid.tolist()):
        np.testing.assert_allclose(got[i, :m].numpy(), want[i, :m].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_save_pretrained_dirs_through_the_importer_and_predictor(tmp_path):
    """A ``WavLMModel`` directory through ``cli.convert_wav2vec`` and
    ``Wav2VecPredictor.from_checkpoint`` (hidden states within 1e-5 of
    transformers'); its config inferred from the weights alone; and a
    ``WavLMFor...`` directory's ``wavlm.`` backbone read whole."""
    from speech_intent_recognizer_tpu_torch.cli.convert_wav2vec import main

    hf = _hf_model(1)
    d = tmp_path / "wavlm"
    hf.save_pretrained(str(d))
    config, backbone = wi.load_pretrained_dir(str(d))
    assert (config.model_type, config.num_buckets,
            config.max_bucket_distance) == ("wavlm", 16, 24)
    inferred = wi.infer_wav2vec_config(backbone)
    assert (inferred.model_type, inferred.num_buckets,
            inferred.num_attention_heads, inferred.max_bucket_distance,
            inferred.do_stable_layer_norm) == ("wavlm", 16, 4, 800, True)
    out = tmp_path / "wavlm.pt"
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps({f"intent_{i}": i for i in range(4)}))
    assert main(["--checkpoint", str(d), "--num_classes", "4", "--output",
                 str(out), "--device", "cpu"]) == 0
    pred = Wav2VecPredictor.from_checkpoint(str(out), str(labels),
                                            device="cpu")
    assert pred.model.config == config
    x, _ = _batch(7, lengths=(WIDTH,) * 3)
    with torch.no_grad():
        want = hf(x).last_hidden_state
        got = pred.model.wav2vec(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    cls = transformers.WavLMForSequenceClassification(hf.config)
    cls.wavlm.load_state_dict(hf.state_dict())
    d2 = tmp_path / "wavlm_cls"
    cls.save_pretrained(str(d2))
    config2, backbone2 = wi.load_pretrained_dir(str(d2))
    assert config2 == config and sorted(backbone2) == sorted(backbone)
    for k in backbone:
        assert torch.equal(backbone2[k], backbone[k]), k


# ---------------------------------------------------------------- tracing


def test_spans_and_one_table_for_two_calls(tmp_path):
    """Two predictor calls at one width build one bucket table (one
    ``relpos_table`` record); each call opens ``sir.w2v.relpos`` once for
    the table's gather and once a layer, ``sir.w2v.attention`` once a
    layer; a training step on the cached table after the calls runs."""
    model = _port(_state(8))
    pred = Wav2VecPredictor(model, {f"intent_{i}": i for i in range(CLASSES)},
                            device="cpu")
    x, n = _batch(8)
    profiling.clear_records()
    try:
        with profiling.trace(str(tmp_path / "t")):
            for _ in range(2):
                pred.predict_waveform_batch(x.numpy(), n.numpy())
        (name,) = os.listdir(tmp_path / "t")
        with open(tmp_path / "t" / name) as f:
            events = json.load(f)["traceEvents"]
        spans = [e["name"] for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
        layers = SMALL["num_hidden_layers"]
        assert spans.count("sir.w2v.relpos") == 2 * (1 + layers)
        assert spans.count("sir.w2v.attention") == 2 * layers
        assert profiling.records("relpos_table") == [(40, "cpu")]
    finally:
        profiling.clear_records()
    model.train()
    model(x, _mask(x, n)).sum().backward()
    assert model.wav2vec.encoder.layers[0].attention.rel_attn_embed \
        .weight.grad is not None
