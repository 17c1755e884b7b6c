"""The torch port imports neither JAX nor anything of the JAX package, not
even a module there that imports no JAX (it keeps its own copy of what it
needs); on CPU tensors its kernel wrappers run their plain versions and
launch nothing; without a GPU the card-only entry points refuse to run."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, cwd, timeout=300):
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_and_chip_smoke_import_without_jax_package():
    """Importing every module of the port and chip_smoke imports no JAX,
    no module of the JAX package, with or without a submodule, neither
    ``transformers`` nor ``safetensors``, neither optional TTS engine
    (``gtts``, ``pyttsx3``) and no matplotlib."""
    code = """
import importlib, pkgutil, sys
import speech_intent_recognizer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))
assert not bad, bad
# the card's host may have neither (the wav2vec converters read
# config.json, safetensors and .bin files themselves)
hf = sorted(m for m in sys.modules
            if m.split('.')[0] in ('transformers', 'safetensors'))
assert not hf, hf
ref = sorted(m for m in sys.modules
             if m.split('.')[0] == 'speech_intent_recognizer_tpu')
assert ref == [], ref
# the optional TTS engines are imported inside their engines only, and
# matplotlib only where a report is written
opt = sorted(m for m in sys.modules
             if m.split('.')[0] in ('gtts', 'pyttsx3', 'matplotlib'))
assert not opt, opt
assert len(names) >= 30, names
print(len(names))
"""
    r = _run(code, REPO)
    assert r.returncode == 0, r.stdout + r.stderr


def test_parallel_and_dryrun_import_without_jax():
    """``parallel`` and ``parallel.dryrun`` (which the card's host runs to
    spawn its ranks) load no JAX module and no module of the JAX
    package."""
    code = """
import sys
import speech_intent_recognizer_tpu_torch.parallel
import speech_intent_recognizer_tpu_torch.parallel.dryrun
bad = sorted(m for m in sys.modules if m.split('.')[0] in (
    'jax', 'jaxlib', 'flax', 'optax')
    or m.split('.')[0] == 'speech_intent_recognizer_tpu')
assert not bad, bad
"""
    r = _run(code, REPO)
    assert r.returncode == 0, r.stdout + r.stderr


def test_streaming_and_serving_modules_import_without_jax_or_msgpack():
    """The streaming, serving and checkpoint-reading modules and their CLIs
    import no JAX, Flax, msgpack or Optax package and no module of the JAX
    package: the card's host has none of them."""
    code = """
import importlib, sys
for name in ('infer.streaming', 'infer.server', 'infer.mic', 'infer.vad',
             'cli.stream', 'cli.serve', 'convert.msgpack',
             'convert.checkpoint'):
    importlib.import_module('speech_intent_recognizer_tpu_torch.' + name)
bad = sorted(m for m in sys.modules if m.split('.')[0] in (
    'jax', 'jaxlib', 'flax', 'msgpack', 'optax', 'sounddevice', 'pyaudio')
    or m.split('.')[0].startswith('speech_intent_recognizer_tpu')
    and not m.startswith('speech_intent_recognizer_tpu_torch'))
assert not bad, bad
"""
    r = _run(code, REPO)
    assert r.returncode == 0, r.stdout + r.stderr


def test_tts_holdout_and_examples_import_only_the_port(tmp_path):
    """The TTS, TTS-holdout and diagnostics modules, their CLIs and the
    example scripts run without JAX, the JAX package, transformers,
    safetensors, gtts or pyttsx3: a synthetic corpus, its holdout report
    (matplotlib imported there, inside ``_write_artifacts``, and nowhere
    before) and the corpus script's module."""
    code = f"""
import importlib, sys
pkg = 'speech_intent_recognizer_tpu_torch'
for name in ('tts', 'tts.generate', 'evaluation.tts_holdout',
             'cli.generate_tts_samples', 'cli.test_tts_samples',
             'utils', 'utils.diagnostics', 'utils.profiling',
             'data.prefetch', 'ops.resample', 'examples.make_ab_corpus',
             'examples.synthetic_e2e', 'examples.convergence_ab',
             'examples.waveform_ab'):
    importlib.import_module(pkg + '.' + name)
assert 'matplotlib' not in sys.modules
from speech_intent_recognizer_tpu_torch.cli.generate_tts_samples import main
from speech_intent_recognizer_tpu_torch.evaluation import tts_holdout
main(['--csv', 'configs/custom_intents_sentences.csv',
      '--output_dir', {str(tmp_path / "tts")!r}])  # engine auto
class Stub:
    label_map = {{'activate_lamp': 0}}
    inv_label_map = {{0: 'activate_lamp'}}
    def predict_directory(self, d):
        return [{{'file': '001_x.wav', 'predicted_label': 'activate_lamp',
                  'confidence': 0.5}}]
seen = []
real_import = __builtins__.__import__
def spy(name, *a, **k):  # who imports matplotlib first
    if name.split('.')[0] == 'matplotlib' and 'matplotlib' not in sys.modules:
        seen.append(sys._getframe(1).f_code.co_name)
    return real_import(name, *a, **k)
__builtins__.__import__ = spy
tts_holdout.evaluate_tts_directory(Stub(), {str(tmp_path / "tts")!r},
                                   report_dir={str(tmp_path / "rep")!r})
__builtins__.__import__ = real_import
assert seen in ([], ['_write_artifacts']), seen  # [] without matplotlib
bad = sorted(m for m in sys.modules if m.split('.')[0] in (
    'jax', 'jaxlib', 'flax', 'optax', 'transformers', 'safetensors',
    'gtts', 'pyttsx3')
    or m.split('.')[0].startswith('speech_intent_recognizer_tpu')
    and not m.startswith(pkg))
assert not bad, bad
"""
    r = _run(code, REPO)
    assert r.returncode == 0, r.stdout + r.stderr


def test_require_cuda_raises_without_gpu():
    from speech_intent_recognizer_tpu_torch.utils.device import require_cuda

    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the host without one")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        require_cuda()


def test_chip_smoke_fails_without_gpu(tmp_path):
    """No result line and a non-zero exit, in the repo and alone."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the host without one")
    r = _run([os.path.join(REPO, "chip_smoke.py")], REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    env_free = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=alone, capture_output=True,
        text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert env_free.returncode != 0
    assert '"ok": true' not in env_free.stdout


def test_cpu_tensors_launch_no_kernel():
    from speech_intent_recognizer_tpu_torch.ops.frontend import (
        make_frontend_params)
    from speech_intent_recognizer_tpu_torch.ops.conv23 import (
        conv23, conv23_operands)
    from speech_intent_recognizer_tpu_torch.ops.frontend_kernels import (
        frontend_conv1, mel_db)
    from speech_intent_recognizer_tpu_torch.ops.gru import gru_layer
    from speech_intent_recognizer_tpu_torch.ops.pool_epilogue import (
        bias_relu_pool2)

    wrappers = (frontend_conv1, gru_layer, mel_db, conv23, bias_relu_pool2)
    for fn in wrappers:
        fn.launches = 0
    rng = np.random.default_rng(0)
    wf = torch.zeros((2, 4096))
    wf[:, :3000] = torch.from_numpy(
        rng.standard_normal((2, 3000)).astype(np.float32))
    out = frontend_conv1(wf, torch.tensor([3000, 1000], dtype=torch.int32),
                         make_frontend_params(),
                         torch.from_numpy(rng.standard_normal(
                             (32, 1, 3, 3)).astype(np.float32)),
                         torch.zeros(32))
    assert out.shape == (2, 100, 1024) and out.dtype == torch.bfloat16
    ys = gru_layer(torch.zeros((2, 3, 4, 96)), torch.zeros((2, 32, 96)),
                   torch.zeros((2, 1, 32)))
    assert ys.shape == (2, 3, 4, 32)
    db = mel_db(torch.zeros((3, 1024)), make_frontend_params())
    assert db.shape == (3, 64) and bool((db == -100.0).all())
    sheet = conv23(out[:, :8], *conv23_operands(
        torch.zeros((64, 32, 3, 3)), torch.zeros(64),
        torch.zeros((128, 64, 3, 3)), torch.ones(128)))
    assert sheet.shape == (2, 2, 1024) and bool((sheet == 1).all())
    pooled = bias_relu_pool2(
        torch.zeros((2, 32, 4, 4)).contiguous(
            memory_format=torch.channels_last), torch.ones(32))
    assert pooled.shape == (2, 32, 2, 2) and bool((pooled == 1).all())
    assert [fn.launches for fn in wrappers] == [0] * len(wrappers)


@pytest.mark.parametrize("case", ["gx_rank", "w_shape", "bn_shape"])
def test_gru_layer_rejects_bad_shapes(case):
    from speech_intent_recognizer_tpu_torch.ops.gru import gru_layer

    gx, w, bn = (torch.zeros((2, 3, 4, 96)), torch.zeros((2, 32, 96)),
                 torch.zeros((2, 1, 32)))
    if case == "gx_rank":
        gx = torch.zeros((1, 3, 4, 96))
    elif case == "w_shape":
        w = torch.zeros((2, 96, 32))
    else:
        bn = torch.zeros((2, 32))
    with pytest.raises(ValueError):
        gru_layer(gx, w, bn)


def test_frontend_conv1_rejects_other_geometry():
    from speech_intent_recognizer_tpu_torch.config import AudioConfig
    from speech_intent_recognizer_tpu_torch.ops.frontend import (
        make_frontend_params)
    from speech_intent_recognizer_tpu_torch.ops.frontend_kernels import (
        frontend_conv1)

    wf, ln = torch.zeros((1, 4096)), torch.tensor([100], dtype=torch.int32)
    w, b = torch.zeros((32, 1, 3, 3)), torch.zeros(32)
    with pytest.raises(ValueError, match="n_mels=64"):
        frontend_conv1(wf, ln, make_frontend_params(AudioConfig(n_mels=40)),
                       w, b)
    with pytest.raises(ValueError, match="frames"):
        frontend_conv1(torch.zeros((1, 200 * 512)), ln,
                       make_frontend_params(), w, b)
