"""The port's data pipeline against the JAX package on the same files: the
int16 waveform cache, validation and preprocessing, the preprocess CLI, and
``cli.run_pipeline`` end to end on the CPU in feature and in waveform
mode."""

import json
import os

import numpy as np
import pytest

from speech_intent_recognizer_tpu.cli import run_pipeline as ref_pipeline
from speech_intent_recognizer_tpu.config.schema import (
    AudioConfig as RefAudioConfig)
from speech_intent_recognizer_tpu.data import audio_io as ref_audio
from speech_intent_recognizer_tpu.data import cache as ref_cache
from speech_intent_recognizer_tpu.data import preprocess as ref_pre
from speech_intent_recognizer_tpu.data.manifest import (
    read_manifest as ref_read_manifest)
from speech_intent_recognizer_tpu_torch.cli import preprocess as cli_pre
from speech_intent_recognizer_tpu_torch.cli import run_pipeline
from speech_intent_recognizer_tpu_torch.config import AudioConfig
from speech_intent_recognizer_tpu_torch.data import audio_io, cache, preprocess
from speech_intent_recognizer_tpu_torch.data.audio_io import save_wav
from speech_intent_recognizer_tpu_torch.data.manifest import read_manifest
from speech_intent_recognizer_tpu_torch.data.pipeline import (
    build_waveform_dataset)

# test-split features of the port's pipeline vs the JAX package's (float32
# fetch on both sides): the bar JAX holds its K3 kernel to against XLA
# (tests/test_pallas_frontend.py:62)
K3_BAR = 2e-3
CLASSES = ("down", "left", "up")


def corpus(root, counts=(("train", 9), ("valid", 6), ("test", 6)),
           bad=True):
    """Three tone classes in 16 kHz PCM WAVs of 0.4-1.2 s (one of 85,000
    samples, past max_samples); with ``bad``, the train split also lists a
    WAV of 60 samples (< 100) and a corrupt file."""
    rng = np.random.default_rng(11)
    csvs = {}
    for split, n in counts:
        rows = []
        for i in range(n):
            k = i % len(CLASSES)
            m = 85000 if (split, i) == ("train", 0) else int(
                rng.integers(6400, 19200))
            t = np.arange(m) / 16000
            x = 0.3 * np.sin(2 * np.pi * 400 * (k + 1) * t) \
                + 0.03 * rng.standard_normal(m)
            path = os.path.join(root, split, f"{i:03d}.wav")
            save_wav(path, x.astype(np.float32), 16000)
            rows.append(f"{path},{CLASSES[k]}\n")
        if bad and split == "train":
            short = os.path.join(root, split, "short.wav")
            save_wav(short, np.zeros(60, np.float32), 16000)
            corrupt = os.path.join(root, split, "corrupt.wav")
            with open(corrupt, "wb") as f:
                f.write(b"RIFF\x00\x00\x00\x00WAVEjunk" + bytes(40))
            rows += [f"{short},up\n", f"{corrupt},left\n"]
        csvs[split] = os.path.join(root, f"{split}.csv")
        with open(csvs[split], "w") as f:
            f.write("path,label\n" + "".join(rows))
    return csvs


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_validate_and_preprocess_match_jax(tmp_path):
    """validate_audio per file and preprocess_dataset (port function and
    CLI) against the JAX package: the same verdicts, and the processed CSVs
    and the label map byte-equal."""
    csvs = corpus(str(tmp_path / "wav"))
    for p in read_manifest(csvs["train"]).paths:
        assert audio_io.validate_audio(p) == ref_audio.validate_audio(p), p
    assert not audio_io.validate_audio(str(tmp_path / "wav/train/short.wav"))
    assert not audio_io.validate_audio(str(tmp_path / "missing.wav"))
    args = (csvs["train"], csvs["valid"], csvs["test"])
    want = ref_pre.preprocess_dataset(*args, str(tmp_path / "jax"))
    got = preprocess.preprocess_dataset(*args, str(tmp_path / "port"))
    cli = cli_pre.main(["--train_csv", csvs["train"], "--valid_csv",
                        csvs["valid"], "--test_csv", csvs["test"],
                        "--output_dir", str(tmp_path / "cli")])
    assert got.keys() == want.keys() == cli.keys()
    for key in want:
        assert _read(got[key]) == _read(want[key]) == _read(cli[key]), key
    assert len(read_manifest(got["train_csv"])) == 9  # both bad rows gone
    fast = preprocess.preprocess_dataset(*args, str(tmp_path / "fast"),
                                         validate=False)
    fast_ref = ref_pre.preprocess_dataset(*args, str(tmp_path / "fast_ref"),
                                          validate=False)
    assert _read(fast["train_csv"]) == _read(fast_ref["train_csv"])


@pytest.mark.parametrize("memmap", [False, True])
def test_waveform_cache_matches_jax(tmp_path, memmap):
    """precompute_waveforms -> save_waveform_cache -> load_waveform_cache in
    both packages on the same WAVs (a corrupt one and one past max_samples
    among them): equal arrays, ok masks and meta, in the in-RAM branch and
    the memmap one (zip-stored ``.npy``)."""
    csvs = corpus(str(tmp_path / "wav"), counts=(("train", 4),))
    label_map = {c: i for i, c in enumerate(CLASSES)}
    out = {}
    for name, mod, manifest, audio_cfg in (
            ("jax", ref_cache, ref_read_manifest(csvs["train"]),
             RefAudioConfig()),
            ("port", cache, read_manifest(csvs["train"]), AudioConfig())):
        waves_out = str(tmp_path / name / "w.npy") if memmap else None
        waves, lengths, labels, ok, paths = mod.precompute_waveforms(
            manifest, label_map, audio_cfg, progress=False,
            waves_out=waves_out)
        assert isinstance(waves, np.memmap) == memmap
        path = str(tmp_path / name / "train_waveforms.npz")
        mod.save_waveform_cache(path, waves, lengths, labels, paths,
                                label_map, audio_cfg)
        out[name] = (mod.load_waveform_cache(path), ok)
    (w_j, l_j, y_j, meta_j), ok_j = out["jax"]
    (w_p, l_p, y_p, meta_p), ok_p = out["port"]
    assert w_p.dtype == np.int16 and w_p.shape == (6, 80000)
    for a, b in ((w_p, w_j), (l_p, l_j), (y_p, y_j), (ok_p, ok_j)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert meta_p == meta_j and meta_p["kind"] == "waveforms_int16"
    assert l_p[0] == 80000 and not ok_p[-1] and ok_p[:-2].all()
    assert cache.waveform_cache_path_for("a/b/train.csv", "c") == \
        ref_cache.waveform_cache_path_for("a/b/train.csv", "c")


def test_build_waveform_dataset_places_int16(tmp_path):
    """build_waveform_dataset: a miss decodes and stores the cache, a hit
    loads it; int16 waveforms, int32 lengths, int64 labels."""
    from speech_intent_recognizer_tpu_torch.config import Config

    csvs = corpus(str(tmp_path / "wav"), counts=(("train", 3),), bad=False)
    cfg = Config.from_dict({"cache_dir": str(tmp_path / "cache")})
    label_map = {c: i for i, c in enumerate(CLASSES)}
    first = build_waveform_dataset(csvs["train"], label_map, cfg, "cpu")
    assert os.path.exists(tmp_path / "cache" / "train_waveforms.npz")
    again = build_waveform_dataset(csvs["train"], label_map, cfg, "cpu")
    for ds in (first, again):
        assert ds.features.dtype.is_floating_point is False
        assert str(ds.features.dtype) == "torch.int16"
        assert str(ds.lengths.dtype) == "torch.int32"
        assert str(ds.labels.dtype) == "torch.int64"
        assert ds.num_items == 3
    assert (first.features == again.features).all()


def _config(root, name, waveforms):
    out = os.path.join(root, name)
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(
            f"data:\n  train_csv: {root}/train.csv\n"
            f"  valid_csv: {root}/valid.csv\n  test_csv: {root}/test.csv\n"
            f"  output_dir: {out}/processed\n"
            f"  label_map_path: {out}/processed/label_map.json\n"
            f"  cache_dir: {out}/cache\n  precompute_batch_size: 8\n"
            f"  precompute_fetch_dtype: float32\n"
            f"  train_on_waveforms: {str(waveforms).lower()}\n"
            f"  use_waveform_augment: {str(waveforms).lower()}\n"
            f"model:\n  num_labels: 3\n  conv_channels: [8, 16, 16]\n"
            f"  gru_hidden: 32\n"
            f"train:\n  epochs: 2\n  batch_size: 8\n  lr: 0.003\n"
            f"  bf16: false\n  save_path: {out}/ckpt\n")
    return path, out


@pytest.mark.parametrize("mode", ["features", "waveforms"])
def test_run_pipeline_matches_jax_stages(tmp_path, monkeypatch, mode):
    """cli.run_pipeline on a WAV corpus on the CPU: exit 0, the training
    history and the evaluation report written.  The JAX package's
    run_pipeline on the same corpus, stopped after step 2: the processed
    CSVs and label map byte-equal, the waveform caches (waveform mode)
    equal, the test split's feature cache within K3_BAR."""
    root = str(tmp_path)
    corpus(os.path.join(root, "wav"))
    for split in ("train", "valid", "test"):
        os.replace(os.path.join(root, "wav", f"{split}.csv"),
                   os.path.join(root, f"{split}.csv"))
    waveforms = mode == "waveforms"
    port_cfg, port_out = _config(root, "port", waveforms)
    jax_cfg, jax_out = _config(root, "jax", waveforms)
    with pytest.raises(SystemExit) as done:
        run_pipeline.main(["--config_path", port_cfg, "--device", "cpu"])
    assert done.value.code == 0

    from speech_intent_recognizer_tpu.cli import train as ref_train

    def stop(*_a, **_k):
        raise RuntimeError("stopped after step 2")

    monkeypatch.setattr(ref_train, "train_from_config", stop)
    stages = {}
    assert not ref_pipeline.run_pipeline(jax_cfg, stage_times=stages)
    assert set(stages) == {"preprocess", "precompute"}

    for name in ("train_data.csv", "valid_data.csv", "test_data.csv",
                 "label_map.json"):
        assert _read(f"{port_out}/processed/{name}") == \
            _read(f"{jax_out}/processed/{name}"), name
    if waveforms:
        for split in ("train", "valid"):
            got = cache.load_waveform_cache(
                f"{port_out}/cache/{split}_data_waveforms.npz")
            want = ref_cache.load_waveform_cache(
                f"{jax_out}/cache/{split}_data_waveforms.npz")
            for a, b in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(a, b)
            assert got[3] == want[3]
        assert not os.path.exists(f"{port_out}/cache/train_data_features.npz")
    got, labels, _ = cache.load_cache(f"{port_out}/cache/test_data_features.npz")
    want, ref_labels, _ = ref_cache.load_cache(
        f"{jax_out}/cache/test_data_features.npz")
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(got, want, rtol=0, atol=K3_BAR)

    with open(f"{port_out}/ckpt/training_history.json") as f:
        history = json.load(f)
    assert history["epochs_run"] == 2 and len(history["history"]) == 2
    assert all(np.isfinite(h["train_loss"]) for h in history["history"])
    report = f"{port_out}/ckpt/evaluation_results/classification_report.txt"
    with open(report) as f:
        assert f.readline().startswith("Test Accuracy: ")
    assert os.path.exists(f"{port_out}/ckpt/best_model.pt")
