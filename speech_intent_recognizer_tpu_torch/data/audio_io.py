"""Audio decode / encode without torchaudio (host side, no JAX).

Copy of ``speech_intent_recognizer_tpu/data/audio_io.py`` reduced to what
the port needs (``load_audio``, ``load_audio_int16``, ``save_wav``,
``validate_audio``); the
reference's ``data`` package imports JAX through ``ops``, so the port keeps
its own copy and ``tests/test_torch_host.py`` and
``tests/test_torch_precompute.py`` pin it to the original.

* native path: ``native/build/libsirdsp.so`` (C++; RIFF/WAVE parser,
  mpg123-backed MP3 decode) through :mod:`.native`;
* pure-Python path: the RIFF parser + ctypes mpg123 below, used when the
  native library has not been built.

Decode sniffs magic bytes, not file names (MP3 data in a ``.wav`` file
decodes as MP3).
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Optional, Tuple

import numpy as np

from speech_intent_recognizer_tpu_torch.data import native
from speech_intent_recognizer_tpu_torch.ops.resample import resample_np


class AudioDecodeError(RuntimeError):
    pass


# --------------------------------------------------------------------------
# WAV (RIFF) parsing — PCM 8/16/24/32, IEEE float32/64, WAVE_FORMAT_EXTENSIBLE
# --------------------------------------------------------------------------

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AudioDecodeError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            if chunk_size < 16:
                raise AudioDecodeError("malformed fmt chunk")
            (audio_format, channels, rate, _byte_rate, _block_align,
             bits) = struct.unpack_from("<HHIIHH", body, 0)
            if audio_format == _WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                (audio_format,) = struct.unpack_from("<H", body, 24)
            fmt = (audio_format, channels, rate, bits)
        elif chunk_id == b"data":
            samples = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned
    if fmt is None or samples is None:
        raise AudioDecodeError("missing fmt or data chunk")
    audio_format, channels, rate, bits = fmt
    if channels <= 0:
        raise AudioDecodeError("invalid channel count")

    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 8:
            x = (np.frombuffer(samples, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(samples, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(samples, np.uint8)
            raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
            vals = (raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(samples, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise AudioDecodeError(f"unsupported PCM bit depth {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(samples, "<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(samples, "<f8").astype(np.float32)
        else:
            raise AudioDecodeError(f"unsupported float bit depth {bits}")
    else:
        raise AudioDecodeError(f"unsupported WAVE format 0x{audio_format:04x}")

    x = x[: (len(x) // channels) * channels].reshape(-1, channels)
    return x, rate


# --------------------------------------------------------------------------
# MP3 via libmpg123 (ctypes; the native C++ path links the same library)
# --------------------------------------------------------------------------

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_FLOAT_32 = 0x200

_mpg123_lib: Optional[ctypes.CDLL] = None
_mpg123_checked = False


def _load_mpg123() -> Optional[ctypes.CDLL]:
    global _mpg123_lib, _mpg123_checked
    if _mpg123_checked:
        return _mpg123_lib
    _mpg123_checked = True
    for name in ("libmpg123.so.0", "libmpg123.so", "libmpg123.dylib"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.mpg123_init()
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                      ctypes.c_int, ctypes.c_int]
        lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_size_t)]
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        _mpg123_lib = lib
        break
    return _mpg123_lib


def _decode_mp3_file(path: str) -> Tuple[np.ndarray, int]:
    lib = _load_mpg123()
    if lib is None:
        raise AudioDecodeError("MP3 decode requires libmpg123 (not found)")
    err = ctypes.c_int(0)
    handle = lib.mpg123_new(None, ctypes.byref(err))
    if not handle:
        raise AudioDecodeError(f"mpg123_new failed (err={err.value})")
    try:
        # Force float32 output for every rate/channel count.  This must be
        # configured before mpg123_open — format changes don't apply to an
        # already-open stream.
        lib.mpg123_format_none(handle)
        for r in (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000):
            for ch in (1, 2):
                lib.mpg123_format(handle, r, ch, _MPG123_ENC_FLOAT_32)
        if lib.mpg123_open(handle, path.encode()) != _MPG123_OK:
            raise AudioDecodeError(f"mpg123 cannot open {path}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        if lib.mpg123_getformat(handle, ctypes.byref(rate),
                                ctypes.byref(channels),
                                ctypes.byref(encoding)) != _MPG123_OK:
            raise AudioDecodeError("mpg123_getformat failed")
        if encoding.value != _MPG123_ENC_FLOAT_32:
            raise AudioDecodeError(
                f"mpg123 refused float32 output (enc=0x{encoding.value:x})")
        chunks = []
        bufsize = 1 << 16
        buf = (ctypes.c_char * bufsize)()
        done = ctypes.c_size_t(0)
        while True:
            ret = lib.mpg123_read(handle, buf, bufsize, ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
            if ret == _MPG123_DONE:
                break
            if ret not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                if chunks:
                    break  # salvage what decoded so far
                raise AudioDecodeError(f"mpg123_read error {ret} for {path}")
        if not chunks:
            raise AudioDecodeError(f"no audio decoded from {path}")
        x = np.frombuffer(b"".join(chunks), np.float32)
        ch = max(channels.value, 1)
        x = x[: (len(x) // ch) * ch].reshape(-1, ch)
        return x, int(rate.value)
    finally:
        lib.mpg123_close(handle)
        lib.mpg123_delete(handle)


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------


def _try_native():
    return native if native.available() else None


def load_audio(
    path: str,
    target_sample_rate: Optional[int] = None,
    mono: bool = True,
    prefer_native: bool = True,
) -> Tuple[np.ndarray, int]:
    """Decode an audio file -> (float32 samples, sample_rate).

    Mirrors the reference load semantics (``precompute_features.py:47-56``):
    mono mixdown by channel mean, then sinc resample to the target rate.
    Returns (samples[, channels] float32 in [-1, 1], rate).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)

    native = _try_native() if prefer_native else None
    if native is not None:
        try:
            x, rate = native.decode_file(path)
        except Exception:  # whatever the native decoder refuses
            x, rate = _decode_any(path)
    else:
        x, rate = _decode_any(path)

    if mono and x.ndim == 2:
        x = x.mean(axis=1) if x.shape[1] > 1 else x[:, 0]
    if target_sample_rate is not None and rate != target_sample_rate:
        x = resample_np(x, rate, target_sample_rate).astype(np.float32)
        rate = target_sample_rate
    return np.ascontiguousarray(x, dtype=np.float32), rate


def load_audio_int16(
    path: str,
    target_sample_rate: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """Decode an audio file -> (int16 mono samples, sample_rate).

    The half-byte wire format for staging waveforms to the device: the
    device reconstructs ``x = i16 * (1/32768)``, so for 16-bit PCM mono
    sources already at the target rate (FSC, anything :func:`save_wav`
    wrote) the result is BIT-IDENTICAL to :func:`load_audio`'s float32 —
    that fast path below hands the RIFF data chunk straight through with
    no float conversion at all.  Other sources (MP3, stereo mixdown,
    resampled) go through the float32 decode and are quantized with the
    :func:`save_wav` formula; reconstruction error is <= 2**-16 of full
    scale — below the 16-bit mic depth every corpus here was captured at.

    Replaces the reference's f32 staging of its own decode output
    (``scripts/precompute_features.py:124-139`` keeps float tensors
    end-to-end); halving the wire bytes is what the tunnel/PCIe path pays
    for per batch.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        with open(path, "rb") as f:
            data = f.read()
        fast = _pcm16_mono_fast_path(data, target_sample_rate)
        if fast is not None:
            return fast
    x, rate = load_audio(path, target_sample_rate=target_sample_rate)
    q = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    return q, rate


def _pcm16_mono_fast_path(data: bytes,
                          target_sample_rate: Optional[int]):
    """RIFF PCM16 mono at the target rate -> (int16 samples, rate), else
    None."""
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        if chunk_id == b"fmt " and chunk_size >= 16:
            (audio_format, channels, rate, _br, _ba,
             bits) = struct.unpack_from("<HHIIHH", data, pos + 8)
            if audio_format == _WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                (audio_format,) = struct.unpack_from("<H", data, pos + 32)
            fmt = (audio_format, channels, rate, bits)
        elif chunk_id == b"data":
            samples = data[pos + 8 : pos + 8 + chunk_size]
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or samples is None:
        return None
    audio_format, channels, rate, bits = fmt
    if (audio_format != _WAVE_FORMAT_PCM or bits != 16 or channels != 1
            or (target_sample_rate is not None
                and rate != target_sample_rate)):
        return None
    return np.frombuffer(samples, "<i2").copy(), int(rate)


def _decode_any(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        with open(path, "rb") as f:
            return _decode_wav_bytes(f.read())
    # MP3: frame sync 0xFFEx/0xFFFx or ID3 tag
    if head[:3] == b"ID3" or (len(head) >= 2 and head[0] == 0xFF
                              and (head[1] & 0xE0) == 0xE0):
        return _decode_mp3_file(path)
    # last resort: try both decoders
    try:
        with open(path, "rb") as f:
            return _decode_wav_bytes(f.read())
    except AudioDecodeError:
        return _decode_mp3_file(path)


def save_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono/stereo float32 [-1, 1] samples as 16-bit PCM WAV."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    channels = x.shape[1]
    data = pcm.tobytes()
    byte_rate = sample_rate * channels * 2
    header = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, _WAVE_FORMAT_PCM,
                                    channels, sample_rate, byte_rate,
                                    channels * 2, 16)
    header += b"data" + struct.pack("<I", len(data))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(header + data)


def validate_audio(path: str, min_samples: int = 100) -> bool:
    """Reference semantics (``preprocess_fsc.py:24-54``): decodable and at
    least ``min_samples`` samples long."""
    try:
        x, _rate = load_audio(path, mono=False)
        return x.shape[0] >= min_samples
    except Exception:  # whatever the decoders refuse: an invalid file
        return False
