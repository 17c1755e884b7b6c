"""The port's hermetic TTS and synthetic A/B corpus against the JAX
package's: the ``synthetic`` engine's WAVs and ``details.csv`` byte-equal
to ``tts/generate.generate_audio_files`` for a short sheet and the full
38-row sheet; the ``auto`` engine order reaching ``synthetic`` with
``gtts`` / ``pyttsx3`` unimportable (neither engine is ever called); the
generation CLI; ``examples/make_ab_corpus`` at ``--variants 1`` in
every profile: WAVs byte-equal to the JAX script's and ``features.npz``
arrays equal; and ``examples/synthetic_e2e``'s corpus and split, equal to
the JAX script's.  The corpus is read back through ``load_audio``, so both
sides decode with the Python decoder (ROADMAP constraint)."""

import filecmp
import importlib.util
import os
import sys

import numpy as np
import pytest

from speech_intent_recognizer_tpu.data import audio_io as jax_audio_io
from speech_intent_recognizer_tpu.tts.generate import (
    generate_audio_files as jax_generate)
from speech_intent_recognizer_tpu_torch.data import audio_io
from speech_intent_recognizer_tpu_torch.examples import make_ab_corpus
from speech_intent_recognizer_tpu_torch.tts import generate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHEET = os.path.join(REPO, "configs", "custom_intents_sentences.csv")


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n
    return names


@pytest.fixture
def python_decoder(monkeypatch):
    """Both packages decode WAVs with their Python decoder."""
    monkeypatch.setattr(audio_io, "_try_native", lambda: None)
    monkeypatch.setattr(jax_audio_io, "_try_native", lambda: None)


@pytest.mark.parametrize("rows", [3, None], ids=["three_rows", "full_sheet"])
def test_synthetic_corpus_byte_equal_to_jax(tmp_path, rows):
    sheet = SHEET
    if rows is not None:
        sheet = str(tmp_path / "sheet.csv")
        with open(SHEET) as f:
            lines = f.read().splitlines()
        with open(sheet, "w") as f:
            f.write("\n".join(lines[:rows + 1]) + "\n")
    mine = generate.generate_audio_files(sheet, str(tmp_path / "port"),
                                         engine="synthetic")
    theirs = jax_generate(sheet, str(tmp_path / "jax"), engine="synthetic")
    assert os.path.basename(mine) == os.path.basename(theirs)
    names = _same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(names) == (rows or 38) + 1  # the WAVs and details.csv
    assert names[0].startswith("001_") and "details.csv" in names


def test_auto_falls_through_to_synthetic(tmp_path, monkeypatch):
    """Offline, with neither optional engine importable, ``auto`` tries
    gtts, then pyttsx3, then renders with ``synthetic``."""
    monkeypatch.setitem(sys.modules, "gtts", None)
    monkeypatch.setitem(sys.modules, "pyttsx3", None)
    tried = []
    for name in ("_synthesize_gtts", "_synthesize_pyttsx3"):
        real = getattr(generate, name)

        def spy(*a, _real=real, _name=name, **k):
            tried.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(generate, name, spy)
    path = str(tmp_path / "a.wav")
    assert generate.synthesize_text("turn the lamp on", path) == "synthetic"
    assert tried == ["_synthesize_gtts", "_synthesize_pyttsx3"]
    generate._synthesize_synthetic("turn the lamp on",
                                   str(tmp_path / "b.wav"))
    assert filecmp.cmp(path, str(tmp_path / "b.wav"), shallow=False)
    with pytest.raises(RuntimeError, match="all TTS engines failed"):
        generate.synthesize_text("x", path, engine="gtts")


def test_sanitize_and_sheet_parsing(tmp_path):
    assert generate.sanitize_filename("Turn  the lamp, on!") == \
        "Turn the lamp on"
    assert len(generate.sanitize_filename("a" * 80)) == 50
    sheet = tmp_path / "s.csv"
    sheet.write_text("Text,Action,Object\nhello there,greet,user\n")
    assert generate._read_sentence_sheet(str(sheet)) == [
        ("hello there", "greet_user")]
    (tmp_path / "empty.csv").write_text("text,label\n")
    with pytest.raises(ValueError, match="no transcriptions"):
        generate._read_sentence_sheet(str(tmp_path / "empty.csv"))


def test_generate_cli(tmp_path):
    from speech_intent_recognizer_tpu_torch.cli.generate_tts_samples import (
        main)

    out = tmp_path / "tts"
    details = main(["--csv", SHEET, "--output_dir", str(out),
                    "--engine", "synthetic"])
    assert details == str(out / "details.csv")
    wavs = sorted(f for f in os.listdir(out) if f.endswith(".wav"))
    assert len(wavs) == 38
    x, sr = audio_io.load_audio(str(out / wavs[0]), prefer_native=False)
    assert sr == 16000 and x.dtype == np.float32 and len(x) > 16000


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("profile", sorted(make_ab_corpus.PROFILES))
def test_ab_corpus_equal_to_jax_script(tmp_path, python_decoder, profile):
    args = ["--variants", "1", "--profile", profile, "--seed", "3"]
    assert make_ab_corpus.main(args + ["--out", str(tmp_path / "port")]) == 0
    assert _jax_example("make_ab_corpus").main(
        args + ["--out", str(tmp_path / "jax")]) == 0
    names = _same_tree(tmp_path / "port" / "audio", tmp_path / "jax" / "audio")
    assert len(names) == 38 and names[0] == "utt_0000_00.wav"
    mine = np.load(tmp_path / "port" / "features.npz")
    theirs = np.load(tmp_path / "jax" / "features.npz")
    assert sorted(mine.files) == sorted(theirs.files)
    for k in theirs.files:
        assert mine[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    assert mine["features"].shape == (38, 64, 200)
    assert len(mine["classes"]) == 19


def test_synthetic_e2e_corpus_equal_to_jax_script(tmp_path, python_decoder):
    """The JAX script draws its split from the generator that drew the
    jitter; the port's ``write_splits`` continues it the same way."""
    from speech_intent_recognizer_tpu_torch.examples import synthetic_e2e

    jax_script = _jax_example("synthetic_e2e")
    rng_port, rng_jax = np.random.default_rng(0), np.random.default_rng(0)
    mine = synthetic_e2e.synthesize_corpus(SHEET, str(tmp_path / "port"), 1,
                                           rng_port)
    theirs = jax_script.synthesize_corpus(SHEET, str(tmp_path / "jax"), 1,
                                          rng_jax)
    assert [os.path.basename(p) for p, _ in mine] == \
        [os.path.basename(p) for p, _ in theirs]
    assert [lab for _, lab in mine] == [lab for _, lab in theirs]
    _same_tree(tmp_path / "port", tmp_path / "jax")
    splits = synthetic_e2e.write_splits(mine, str(tmp_path), rng_port)
    order = rng_jax.permutation(len(theirs))  # the JAX script's split
    with open(splits["test"]) as f:
        test = [line.split(",")[0] for line in f.read().splitlines()[1:]]
    assert [os.path.basename(p) for p in test] == \
        [os.path.basename(theirs[i][0]) for i in order[:len(theirs) // 5]]
