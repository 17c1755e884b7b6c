"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` for Hopper (``sm_90a``), all
at once, and the objects are linked into one shared library with a plain C
interface, loaded with :mod:`ctypes`.  The
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
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# the forward GRU kernels' addressing after their shape (gru_mma.cuh's
# Strides): gx's and ys's direction, step and row strides, and `reverse`
_K2 = [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _I, _P]
# entry point -> argtypes; every pointer and the stream as c_void_p
_SIGNATURES = {
    "sir_frontend_conv1": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                           ctypes.c_float, _P],
    "sir_gru_layer_bf16": _K2,
    "sir_gru_layer_f32": _K2,
    "sir_frontend_f32": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I,
                         ctypes.c_float, _P],
    "sir_frontend_bf16": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I,
                          ctypes.c_float, _P],
    "sir_gru_layer_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _P],
    "sir_gru_layer_bwd_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _P],
    # tensor-core GRU kernels (bf16, hidden 256); no transposed W
    "sir_gru_layer_mma": _K2,
    "sir_gru_layer_bwd_mma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the fp32 cluster kernels (hidden 256), forward and backward
    "sir_gru_layer_cluster": _K2,
    "sir_gru_layer_bwd_cluster": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _P],
    # their resources per tile height: out = int[7] on the host
    "sir_gru_layer_mma_info": [_I, _P],
    "sir_gru_layer_bwd_mma_info": [_I, _P],
    "sir_gru_layer_cluster_info": [_I, _P],
    "sir_gru_layer_bwd_cluster_info": [_I, _P],
    "sir_mel_db": [_P, ctypes.c_longlong, _I, _I, _P, _P, _P, _P, _P, _I, _P,
                   _P],
    # resources of the built front-end kernels: out = int[5] on the host
    "sir_frontend_conv1_info": [_P],
    "sir_frontend_info": [_I, _P],
    "sir_mel_db_info": [_I, _I, _I, _P],
    "sir_conv23": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "sir_conv23_info": [_P],
    "sir_pool_epilogue_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "sir_pool_epilogue_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
    # K7, the training conv epilogue: forward, backward, resources
    "sir_bn_pool_forward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, ctypes.c_float, _P],
    "sir_bn_pool_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _I, _P],
    "sir_bn_pool_info": [_I, _I, _P],
    "sir_bn_pool_scratch": [_I, _P],
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

    One ``nvcc`` per ``.cu`` file, all started together, then one link.
    Returns the library path.  With ``ptxas_verbose`` the build always runs
    and prints each kernel's registers, shared memory and spills
    (``-Xptxas -v``)."""
    out = library_path()
    if os.path.exists(out) and not ptxas_verbose:
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tag = f"{out}.{os.getpid()}"
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    units = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tag}.{os.path.basename(p)}.o" for p in units]
    procs = [subprocess.Popen([_nvcc(), *extra, *NVCC_FLAGS, "-c", "-o", o, p],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for p, o in zip(units, objs)]
    errs = [proc.communicate()[1] for proc in procs]  # waits for every nvcc
    try:
        for path, proc, err in zip(units, procs, errs):
            rc = proc.returncode
            if rc != 0:
                raise RuntimeError(
                    f"nvcc failed on {os.path.basename(path)} ({rc}):\n{err}")
            if ptxas_verbose:
                print(err, end="")
        tmp = f"{tag}.tmp"
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
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
