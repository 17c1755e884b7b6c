"""The port's feature precompute against the JAX package on the same
inputs: the plain K3 (``log_mel_frontend_plain``) against the JAX fused
front-end (its Pallas kernel in interpret mode on the CPU, as the JAX
package's own tests run it), ``precompute_features`` end to end for every
wire and fetch format, cache files across the two packages, and the
host-code copies (manifest, int16 decode, metrics, the background loader)
pinned to their originals."""

import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu.config.schema import AudioConfig
from speech_intent_recognizer_tpu.data import audio_io as ref_io
from speech_intent_recognizer_tpu.data import cache as ref_cache
from speech_intent_recognizer_tpu.data import manifest as ref_manifest
from speech_intent_recognizer_tpu.data import prefetch as ref_prefetch
from speech_intent_recognizer_tpu.evaluation import metrics as ref_metrics
from speech_intent_recognizer_tpu.ops import frontend_jax
from speech_intent_recognizer_tpu_torch.config import Config
from speech_intent_recognizer_tpu_torch.data import audio_io
from speech_intent_recognizer_tpu_torch.data import cache
from speech_intent_recognizer_tpu_torch.data import manifest
from speech_intent_recognizer_tpu_torch.data.pipeline import build_dataset
from speech_intent_recognizer_tpu_torch.data.prefetch import BackgroundLoader
from speech_intent_recognizer_tpu_torch.evaluation import metrics
from speech_intent_recognizer_tpu_torch.ops import frontend_kernels as fk
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    log_mel_frontend, log_mel_frontend_plain, make_frontend_params)

CFG = AudioConfig()
WIDTH = CFG.max_samples  # precompute's buffers: max_samples wide
LENGTHS = [16000, 39999, 80000, 2, 512]
# the bar JAX holds K3 to against XLA (tests/test_pallas_frontend.py:62)
BAR = 2e-3


def _wave(rng, n):
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.2 * np.sin(2 * np.pi * 1330 * t + 0.5)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def buffer():
    rng = np.random.default_rng(3)
    buf = np.zeros((len(LENGTHS), WIDTH), np.float32)
    for i, n in enumerate(LENGTHS):
        buf[i, :n] = _wave(rng, n)
    return buf, np.asarray(LENGTHS, np.int32)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k3_matches_jax_pallas(buffer, normalize, dtype):
    """f32 out within 2e-3; bf16 out within one bf16 rounding step (2**-7
    relative: the two sides round values up to 2e-3 apart) plus 2e-3."""
    buf, ln = buffer
    want = np.asarray(frontend_jax.log_mel_frontend(
        jnp.asarray(buf), jnp.asarray(ln), frontend_jax.make_frontend_params(
            CFG), normalize=normalize, backend="pallas",
        out_dtype=getattr(jnp, dtype)).astype(jnp.float32))
    got = log_mel_frontend(torch.from_numpy(buf), torch.from_numpy(ln),
                           make_frontend_params(CFG), normalize,
                           getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (5, 64, 200)
    got = got.float().numpy()
    tol = BAR if dtype == "float32" else 2.0 ** -7 * np.abs(want) + BAR
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    t_valid = 1 + ln // CFG.hop_length
    for i, tv in enumerate(t_valid):  # frames past the valid count are 0
        assert (got[i, :, tv:] == 0).all()


def test_frontend_wrapper_on_cpu_launches_nothing(buffer):
    buf, ln = buffer
    fk.frontend.launches = 0
    fe = make_frontend_params(CFG)
    got = fk.frontend(torch.from_numpy(buf), torch.from_numpy(ln), fe)
    want = log_mel_frontend_plain(torch.from_numpy(buf),
                                  torch.from_numpy(ln), fe)
    assert torch.equal(got, want) and fk.frontend.launches == 0
    with pytest.raises(ValueError, match="out_dtype"):
        fk.frontend(torch.from_numpy(buf), torch.from_numpy(ln), fe,
                    out_dtype=torch.float16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 WAVs (one 16-bit PCM at 22.05 kHz, resampled on decode) + one
    unreadable file, a manifest with the reference's column aliases, and a
    label map."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(11)
    rows = []
    for i, n in enumerate([16000, 24000, 39999, 8000, 80000, 90000, 700,
                           30000]):
        path = root / f"u{i}.wav"
        rate = 22050 if i == 3 else 16000
        audio_io.save_wav(str(path), _wave(rng, n), rate)
        rows.append((str(path), f"intent_{i % 3}"))
    bad = root / "bad.wav"
    bad.write_bytes(b"RIFF0000WAVEnot audio")
    rows.append((str(bad), "intent_0"))
    csv = root / "manifest.csv"
    csv.write_text("file_path,intent,speaker\n" + "".join(
        f"{p},{l},s{k}\n" for k, (p, l) in enumerate(rows)))
    label_map = {f"intent_{k}": k for k in range(3)}
    return root, csv, label_map


@pytest.mark.parametrize("wire", ["int16_packed", "int16", "float32"])
@pytest.mark.parametrize("fetch", ["int16", "float32"])
def test_precompute_matches_jax(corpus, wire, fetch):
    """The port's precompute (plain K3 on the CPU) against the JAX
    package's (its fused Pallas front-end in interpret mode) for every
    wire x fetch format: features within 2e-3, labels and the
    failed-decode mask equal."""
    _root, csv, label_map = corpus
    m = manifest.read_manifest(str(csv))
    want = ref_cache.precompute_features(
        ref_manifest.read_manifest(str(csv)), label_map, CFG, batch_size=4,
        progress=False, wire_dtype=wire, fetch_dtype=fetch)
    timings = {}
    got = cache.precompute_features(m, label_map, CFG, batch_size=4,
                                    progress=False, wire_dtype=wire,
                                    fetch_dtype=fetch, timings=timings,
                                    device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=BAR)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]
    assert not got[2][-1] and (got[0][-1] == 0).all()
    assert timings["batches"] == 3


def test_wire_formats_agree_exactly(corpus):
    """int16_packed and int16 stage identical values; for 16-bit PCM
    sources at the target rate both equal float32 staging bit for bit (the
    resampled file, row 3, is quantized to int16 after resampling)."""
    _root, csv, label_map = corpus
    m = manifest.read_manifest(str(csv))
    out = {w: cache.precompute_features(
        m, label_map, CFG, batch_size=3, progress=False, wire_dtype=w,
        fetch_dtype="float32", device="cpu")[0]
        for w in ("int16_packed", "int16", "float32")}
    np.testing.assert_array_equal(out["int16_packed"], out["int16"])
    pcm = np.arange(len(m)) != 3
    np.testing.assert_array_equal(out["int16"][pcm], out["float32"][pcm])
    np.testing.assert_allclose(out["int16"][3], out["float32"][3], rtol=0,
                               atol=BAR)


def test_caches_load_across_packages(corpus, tmp_path):
    """A cache the JAX package writes loads in the port and the other way
    round, from an array and from the streamed memmap alike."""
    _root, csv, label_map = corpus
    m = manifest.read_manifest(str(csv))
    npy = tmp_path / "feats.npy"
    feats, labels, _ok, paths = cache.precompute_features(
        m, label_map, CFG, batch_size=4, progress=False, device="cpu",
        features_out=str(npy))
    assert isinstance(feats, np.memmap)
    ours = tmp_path / "ours_features.npz"
    cache.save_cache(str(ours), feats, labels, paths, label_map, CFG)
    theirs = tmp_path / "theirs_features.npz"
    ref_cache.save_cache(str(theirs), np.asarray(feats), labels, paths,
                         label_map, CFG)
    for path in (ours, theirs):
        a = cache.load_cache(str(path))
        b = ref_cache.load_cache(str(path))
        np.testing.assert_array_equal(a[0], np.asarray(feats))
        np.testing.assert_array_equal(b[0], np.asarray(feats))
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2] and a[2]["paths"] == paths
    assert json.loads((tmp_path / "ours_features.meta.json").read_text()) \
        == json.loads((tmp_path / "theirs_features.meta.json").read_text())
    assert cache.cache_path_for("/x/train_data.csv", "c") == \
        ref_cache.cache_path_for("/x/train_data.csv", "c")


def test_build_dataset_hit_migration_and_miss(corpus, tmp_path):
    """build_dataset: a miss precomputes and stores; the stored cache hits;
    a reference-format .pt cache migrates as the JAX package reads it."""
    _root, csv, label_map = corpus
    cfg = Config.from_dict({"cache_dir": str(tmp_path / "c"),
                            "precompute_batch_size": 4})
    miss = build_dataset(str(csv), label_map, cfg, device="cpu")
    stored = cache.cache_path_for(str(csv), cfg.data.cache_dir)
    hit = build_dataset(str(csv), label_map, cfg, device="cpu")
    assert miss.num_items == hit.num_items == 9
    assert torch.equal(miss.features, hit.features)
    assert torch.equal(miss.labels, hit.labels)

    rng = np.random.default_rng(0)
    blob = {f"/a/{i}.wav": {"features": torch.from_numpy(
        rng.standard_normal((64, 150 + 20 * i)).astype(np.float32)),
        "label": f"intent_{i}"} for i in range(3)}
    legacy_cfg = Config.from_dict({"cache_dir": str(tmp_path / "legacy")})
    legacy = cache.cache_path_for("legacy.csv", legacy_cfg.data.cache_dir)
    legacy = legacy[:-len(".npz")] + ".pt"
    (tmp_path / "legacy").mkdir()
    torch.save(blob, legacy)
    ds = build_dataset("legacy.csv", label_map, legacy_cfg, device="cpu")
    want = ref_cache.load_torch_cache(legacy, label_map, 200)
    np.testing.assert_array_equal(ds.features.numpy(), want[0])
    np.testing.assert_array_equal(ds.labels.numpy(), want[1])
    assert stored.endswith("manifest_features.npz")


def test_manifest_copy_matches(corpus, tmp_path):
    _root, csv, _ = corpus
    a = manifest.read_manifest(str(csv))
    b = ref_manifest.read_manifest(str(csv))
    assert (a.paths, a.labels, a.extras, a.source) == \
        (b.paths, b.labels, b.extras, b.source)
    synth = tmp_path / "synth.csv"
    synth.write_text("wav_path,action,object\nx/1.wav,activate,lamp\n\n"
                     "y/2.wav,increase,volume\n")
    a = manifest.read_manifest(str(synth), base_path=str(tmp_path))
    b = ref_manifest.read_manifest(str(synth), base_path=str(tmp_path))
    assert (a.paths, a.labels) == (b.paths, b.labels)
    assert a.subset([1]).labels == ["increase_volume"]
    for path in ("rel/a.wav", "/abs/b.wav"):
        assert manifest.normalize_audio_path(path, str(tmp_path)) == \
            ref_manifest.normalize_audio_path(path, str(tmp_path))
    for bad in ("no_path_col", "empty"):
        p = tmp_path / f"{bad}.csv"
        p.write_text("label\nx\n" if bad == "no_path_col" else "path,label\n")
        with pytest.raises(ValueError):
            manifest.read_manifest(str(p))
        with pytest.raises(ValueError):
            ref_manifest.read_manifest(str(p))


def test_int16_decode_copy_matches(corpus):
    root, _, _ = corpus
    for name in ("u0.wav", "u3.wav"):  # PCM16 fast path; resampled path
        a = audio_io.load_audio_int16(str(root / name), 16000)
        b = ref_io.load_audio_int16(str(root / name), 16000)
        assert a[1] == b[1] and a[0].dtype == np.int16
        np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("n_classes", [2, 5, 31])
def test_metrics_copies_match(rng, n_classes):
    y_true = rng.integers(0, n_classes, 200)
    y_pred = np.where(rng.random(200) < 0.7, y_true,
                      rng.integers(0, n_classes, 200))
    names = [f"class_{i}" for i in range(n_classes)]
    assert metrics.accuracy_score(y_true, y_pred) == \
        ref_metrics.accuracy_score(y_true, y_pred)
    np.testing.assert_array_equal(
        metrics.confusion_matrix(y_true, y_pred, n_classes),
        ref_metrics.confusion_matrix(y_true, y_pred, n_classes))
    a = metrics.classification_report_dict(y_true, y_pred, names, n_classes)
    b = ref_metrics.classification_report_dict(y_true, y_pred, names,
                                               n_classes)
    assert a == b
    assert metrics.format_classification_report(a) == \
        ref_metrics.format_classification_report(b)
    assert metrics.accuracy_score([], []) == ref_metrics.accuracy_score([], [])


def test_background_loader_order_and_errors():
    """Items arrive in order, as from the original; a producer exception
    reaches the consumer (the original would wait forever) and the worker
    thread is joined."""
    items = list(BackgroundLoader(lambda: iter(range(50)), capacity=2))
    assert items == list(range(50)) == list(
        ref_prefetch.BackgroundLoader(lambda: iter(range(50)), capacity=2))

    def failing():
        yield 1
        raise OSError("disk gone")

    before = threading.active_count()
    got = []
    with pytest.raises(OSError, match="disk gone"):
        for item in BackgroundLoader(failing, capacity=2):
            got.append(item)
    assert got == [1] and threading.active_count() == before
