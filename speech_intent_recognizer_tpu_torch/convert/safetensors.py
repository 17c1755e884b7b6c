"""Reader of ``.safetensors`` files, without the ``safetensors`` package.

The format: 8 bytes of little-endian header length N, N bytes of a JSON
header mapping each tensor's name to ``{"dtype", "shape", "data_offsets":
[begin, end]}`` (offsets into the data that follows; an optional
``__metadata__`` entry of strings), then the raw little-endian data.  Like
``convert/msgpack.py`` this reads only what the checkpoints it serves hold
and raises :class:`SafetensorsError` with the reason for anything else.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import torch

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
           "BOOL": torch.bool}


class SafetensorsError(ValueError):
    """A file that is not a safetensors file this reader understands."""


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, on the CPU, in the file's dtypes."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise SafetensorsError(f"{path}: {len(data)} bytes, no header")
    n = struct.unpack("<Q", data[:8])[0]
    if 8 + n > len(data):
        raise SafetensorsError(f"{path}: header of {n} bytes overruns the "
                               f"file of {len(data)}")
    try:
        header = json.loads(data[8:8 + n])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SafetensorsError(f"{path}: header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: header is not a JSON object")
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = _DTYPES[info["dtype"]]
            shape = [int(d) for d in info["shape"]]
            begin, end = (int(o) for o in info["data_offsets"])
        except (KeyError, TypeError, ValueError):
            raise SafetensorsError(f"{path}: entry {name!r} is not "
                                   f"{{dtype, shape, data_offsets}} of a "
                                   f"known dtype: {info!r}") from None
        count = 1
        for d in shape:
            count *= d
        size = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= len(body) or end - begin != count * size:
            raise SafetensorsError(f"{path}: {name!r} spans [{begin}, {end}) "
                                   f"of {len(body)} data bytes; shape "
                                   f"{shape} of {info['dtype']} needs "
                                   f"{count * size}")
        flat = (torch.frombuffer(bytearray(body[begin:end]), dtype=dtype)
                if count else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(shape)
    return out
