"""The torch port imports neither JAX nor the JAX package; on CPU tensors
its kernel wrappers
run their plain versions and launch nothing; without a GPU the card-only
entry points refuse to run."""

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
    code = """
import importlib, pkgutil, sys
import speech_intent_recognizer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                    'speech_intent_recognizer_tpu'))
assert not bad, bad
assert len(names) >= 25, names
print(len(names))
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
    from speech_intent_recognizer_tpu_torch.ops.frontend_kernels import (
        frontend_conv1)
    from speech_intent_recognizer_tpu_torch.ops.gru import gru_layer

    frontend_conv1.launches = 0
    gru_layer.launches = 0
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
    assert frontend_conv1.launches == 0 and gru_layer.launches == 0


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
    from speech_intent_recognizer_tpu_torch.config.schema import AudioConfig
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
