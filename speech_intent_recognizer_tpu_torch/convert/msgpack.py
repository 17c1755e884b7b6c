"""Reader of the JAX package's ``.msgpack`` model checkpoints.

``train/checkpoint.save_model`` and ``Checkpointer.save_best`` write
``flax.serialization.to_bytes({"params": ..., "batch_stats": ...})``: a
msgpack map of nested maps whose leaves are arrays, each packed as the ext
type 1 that flax defines, whose payload is itself msgpack: the array
``(shape, dtype name, C-order bytes)``.  This module decodes that subset in
plain Python (neither ``flax`` nor ``msgpack`` is needed): maps, arrays,
str and bin, nil and booleans, ints and floats, and the ndarray ext.  Any
other ext type, a truncated or over-long buffer, or a structure that is
not a map of the two trees raises :class:`MsgpackError` with the reason.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

_NDARRAY_EXT = 1  # flax.serialization._MsgpackExtType.ndarray
# flax splits a leaf above 2**30 bytes into a map of chunks under this key
_CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """A file that is not a checkpoint this reader understands."""


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError(f"truncated: {n} bytes wanted at offset "
                               f"{self.pos} of {len(self.data)}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: (">B", bytes), 0xC5: (">H", bytes), 0xC6: (">I", bytes),
                 0xD9: (">B", str), 0xDA: (">H", str), 0xDB: (">I", str),
                 0xDC: (">H", list), 0xDD: (">I", list),
                 0xDE: (">H", dict), 0xDF: (">I", dict)}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind is bytes:
                return bytes(self.take(n))
            if kind is str:
                return self.str(n)
            return self.array(n) if kind is list else self.map(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self.ext(self.unpack(ext[b]))
        raise MsgpackError(f"byte 0x{b:02x} at offset {self.pos - 1} is not "
                           "a msgpack type")

    def str(self, n: int) -> str:
        try:
            return bytes(self.take(n)).decode("utf-8")
        except UnicodeDecodeError as e:
            raise MsgpackError(f"invalid utf-8 string: {e}") from None

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, (str, int)):
                raise MsgpackError(f"map key of type {type(key).__name__}")
            out[key] = self.value()
        if _CHUNKED in out:
            raise MsgpackError("chunked array leaves (over 2**30 bytes) are "
                               "not read")
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code != _NDARRAY_EXT:
            raise MsgpackError(f"ext type {code} is not an ndarray (ext "
                               f"{_NDARRAY_EXT})")
        return _ndarray(payload)


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's ndarray payload: msgpack ``[shape, dtype name, bytes]``."""
    inner = _Reader(payload)
    value = inner.value()
    if inner.pos != len(payload):
        raise MsgpackError("ndarray payload has trailing bytes")
    if (not isinstance(value, list) or len(value) != 3
            or not isinstance(value[0], list)
            or not all(isinstance(d, int) and d >= 0 for d in value[0])
            or not isinstance(value[1], (str, bytes))
            or not isinstance(value[2], bytes)):
        raise MsgpackError("ndarray payload is not [shape, dtype, bytes]")
    shape, name, buf = value
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":  # widened exactly to float32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        try:
            dtype = np.dtype(name)
        except TypeError:
            raise MsgpackError(f"unknown dtype {name!r}") from None
        if dtype.hasobject or len(buf) % dtype.itemsize:
            raise MsgpackError(f"cannot read {len(buf)} bytes as {name}")
        arr = np.frombuffer(buf, dtype)
    if arr.size != int(np.prod(shape)):
        raise MsgpackError(f"{arr.size} elements do not fill shape "
                           f"{tuple(shape)}")
    return arr.reshape(shape).copy()


def loads(data: bytes) -> Any:
    """Decode one msgpack value (the whole buffer) with ndarray leaves."""
    reader = _Reader(data)
    value = reader.value()
    if reader.pos != len(data):
        raise MsgpackError(f"{len(data) - reader.pos} bytes after the "
                           "first value")
    return value


def read_variables(path: str) -> Tuple[Dict, Dict]:
    """``(params, batch_stats)`` of a checkpoint the JAX trainer wrote, as
    nested dicts of NumPy arrays (``batch_stats`` empty for a BN-folded
    model)."""
    with open(path, "rb") as f:
        tree = loads(f.read())
    if not isinstance(tree, dict) or "params" not in tree:
        raise MsgpackError(f"{path}: not a map holding 'params'")
    extra = set(tree) - {"params", "batch_stats"}
    if extra:
        raise MsgpackError(f"{path}: unexpected top-level keys "
                           f"{sorted(extra)}")
    params, stats = tree["params"], tree.get("batch_stats") or {}

    def check(node, where):
        if not isinstance(node, dict):
            raise MsgpackError(f"{path}: {where} is a "
                               f"{type(node).__name__}, not a map")
        for k, v in node.items():
            if not isinstance(v, np.ndarray):
                check(v, f"{where}/{k}")

    check(params, "params")
    check(stats, "batch_stats")
    return params, stats
