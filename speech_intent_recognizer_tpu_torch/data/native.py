"""ctypes bindings for the native C++ DSP library (``libsirdsp.so``).

Uses ``native/build/libsirdsp.so`` at the repository root when it has been
built (``native/build.sh``); :mod:`.audio_io` decodes with its pure-Python
RIFF parser otherwise, and the streaming featurizer and the VAD use their
NumPy versions.  This is host code, exactly as the reference package has
it (``speech_intent_recognizer_tpu/data/native.py``): the decoder, the
streaming featurizer's per-chunk loop (:class:`NativeStreamer`) and the
VAD's mean-absolute energy (:func:`mean_abs`).
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
                feed = lib.sirdsp_stream_feed
                finalize = lib.sirdsp_stream_finalize
                energy = lib.sirdsp_mean_abs
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
            # Raw c_void_p argtypes: the stream calls sit on the per-chunk
            # serving path, and ndpointer's per-call dtype / flags checks
            # cost more than the C compute.  NativeStreamer owns the fixed
            # buffers, checks them once and passes prebound pointers.
            vp = ctypes.c_void_p
            feed.restype = ctypes.c_longlong
            feed.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, vp, vp,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_longlong]
            finalize.restype = ctypes.c_longlong
            finalize.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_longlong]
            energy.restype = ctypes.c_double
            energy.argtypes = [vp, ctypes.c_longlong]
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


def _float32_contiguous(chunk) -> np.ndarray:
    if (not isinstance(chunk, np.ndarray) or chunk.dtype != np.float32
            or not chunk.flags.c_contiguous):
        chunk = np.ascontiguousarray(chunk, np.float32)
    return chunk


class NativeStreamer:
    """Thin stateful wrapper over the native streaming featurizer.

    Owns nothing but NumPy buffers: the C side
    (``native/sirdsp.cpp``: ``sirdsp_stream_feed`` / ``_finalize``) mutates
    them in place, so there are no handles to free and the caller can alias
    the prepared-signal buffer for its own views.
    """

    def __init__(self, prep_buf: np.ndarray, window: np.ndarray,
                 mel_fb: np.ndarray, n_fft: int, hop: int,
                 max_samples: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native libsirdsp not built")
        if n_fft & (n_fft - 1):
            raise ValueError("native streamer needs a power-of-two n_fft")
        self.prep_buf = prep_buf  # shared with the caller
        self.window = np.ascontiguousarray(window, np.float32)
        self.mel_fb = np.ascontiguousarray(mel_fb, np.float32)
        self.n_fft, self.hop = int(n_fft), int(hop)
        self.n_mels = int(self.mel_fb.shape[1])
        self.max_samples = int(max_samples)
        self.cap_frames = 1 + self.max_samples // self.hop
        self.mel = np.zeros((self.cap_frames, self.n_mels), np.float32)
        self.state = np.zeros(3, np.int64)  # n, left_filled, frames_done
        if (self.window.shape != (self.n_fft,)
                or self.mel_fb.shape[0] != self.n_fft // 2 + 1
                or self.prep_buf.shape != (self.n_fft // 2
                                           + self.max_samples,)):
            raise ValueError("window, filterbank or signal buffer does not "
                             "match n_fft and max_samples")
        if (self.prep_buf.dtype != np.float32
                or not self.prep_buf.flags.c_contiguous):
            raise ValueError("prep_buf must be C-contiguous float32")
        # prebound pointers and functions: per chunk only the chunk's
        # pointer is marshalled, every other operand is a fixed buffer
        self._feed_c = lib.sirdsp_stream_feed
        self._finalize_c = lib.sirdsp_stream_finalize
        self._p_state = self.state.ctypes.data
        self._p_prep = self.prep_buf.ctypes.data
        self._p_mel = self.mel.ctypes.data
        self._p_win = self.window.ctypes.data
        self._p_fb = self.mel_fb.ctypes.data

    def reset(self) -> None:
        self.state[:] = 0

    def feed(self, chunk: np.ndarray) -> int:
        """Append a chunk; returns the frames emitted so far."""
        chunk = _float32_contiguous(chunk)
        done = self._feed_c(
            self._p_state, self._p_prep, self._p_mel, chunk.ctypes.data,
            chunk.size, self._p_win, self._p_fb, self.n_fft, self.hop,
            self.n_mels, self.max_samples, self.cap_frames)
        if done < 0:
            raise RuntimeError(f"sirdsp_stream_feed failed ({done})")
        return done

    def finalize(self) -> int:
        """Tail reflect pad and the remaining frames; returns the total."""
        total = self._finalize_c(
            self._p_state, self._p_prep, self._p_mel, self._p_win,
            self._p_fb, self.n_fft, self.hop, self.n_mels, self.cap_frames)
        if total < 0:
            raise RuntimeError(f"sirdsp_stream_finalize failed ({total})")
        return total


def mean_abs(chunk: np.ndarray) -> float:
    """Native mean-absolute energy (the VAD's per-chunk operation)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native libsirdsp not built")
    chunk = _float32_contiguous(chunk)
    return lib.sirdsp_mean_abs(chunk.ctypes.data, chunk.size)
