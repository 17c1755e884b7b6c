"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
library is built at first use into ``_build/`` beside this file (listed in
``.gitignore``) under a name keyed on a hash of the sources and flags, so a
fresh checkout builds everything on its first kernel call and an edited
source always rebuilds.  Nothing is built or loaded at import time: the
package imports on hosts without CUDA, where the wrappers take their plain
PyTorch versions for CPU tensors.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes; every pointer and the stream as c_void_p
_SIGNATURES = {
    "sir_frontend_conv1": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                           ctypes.c_float, _P],
    "sir_gru_layer_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "sir_gru_layer_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libsir_kernels_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(ptxas_verbose: bool = False) -> str:
    """Compile the kernels unless the library for these sources exists.

    Returns the library path.  With ``ptxas_verbose`` the build always runs
    and returns after printing each kernel's registers, shared memory and
    spills (``-Xptxas -v``)."""
    out = library_path()
    if os.path.exists(out) and not ptxas_verbose:
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[
        p for p in _sources() if p.endswith(".cu")]]
    if ptxas_verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if ptxas_verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; argtypes set on every entry."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
