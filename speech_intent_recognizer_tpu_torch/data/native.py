"""ctypes shim for the native C++ DSP library's decoder (``libsirdsp.so``).

Uses ``native/build/libsirdsp.so`` at the repository root when it has been
built (``native/build.sh``); :mod:`.audio_io` decodes with its pure-Python
RIFF parser otherwise.  This is host decode, exactly as the reference
package does it (``speech_intent_recognizer_tpu/data/native.py``), reduced
to the decode entry point that batch inference needs.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

_LIB_NAME = "libsirdsp.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_checked = False


def _candidate_paths():
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    yield os.path.join(root, "native", "build", _LIB_NAME)
    yield os.path.join(root, "native", _LIB_NAME)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _checked
    with _lock:
        if _checked:
            return _lib
        _checked = True
        for path in _candidate_paths():
            try:
                lib = ctypes.CDLL(path)
                decode = lib.sirdsp_decode_file
                free = lib.sirdsp_free
            except (OSError, AttributeError):
                continue
            decode.restype = ctypes.c_int
            decode.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_longlong),  # num frames
                ctypes.POINTER(ctypes.c_int),  # channels
                ctypes.POINTER(ctypes.c_int),  # sample rate
            ]
            free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            _lib = lib
            break
        return _lib


def available() -> bool:
    return _load() is not None


def decode_file(path: str) -> Tuple[np.ndarray, int]:
    """Decode via the native library -> (float32 (frames, channels), rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native libsirdsp not built")
    data_ptr = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_longlong(0)
    channels = ctypes.c_int(0)
    rate = ctypes.c_int(0)
    ret = lib.sirdsp_decode_file(path.encode(), ctypes.byref(data_ptr),
                                 ctypes.byref(frames), ctypes.byref(channels),
                                 ctypes.byref(rate))
    if ret != 0:
        raise RuntimeError(f"sirdsp decode failed (code {ret}) for {path}")
    try:
        n = frames.value * channels.value
        x = np.ctypeslib.as_array(data_ptr, shape=(n,)).copy()
    finally:
        lib.sirdsp_free(data_ptr)
    return x.reshape(frames.value, channels.value), rate.value
