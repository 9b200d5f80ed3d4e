"""Read the CAE's ``.msgpack`` checkpoints for the reference.

A checkpoint is flax's msgpack serialization of ``{"config": <json str>,
"state": <tree of arrays>}``; each ndarray is msgpack extension type 1
whose payload is a msgpack array ``(shape, dtype name, raw C-order
bytes)``.  This reader takes that subset of msgpack (maps, arrays, str,
bin, ints, floats, nil, bool, ext types 1 and 3), so the reference needs no
``msgpack`` package and nothing of the program.  Chunked arrays (above
2**30 bytes) do not occur in these checkpoints and are refused.
"""

import json
import struct
from typing import Any, Dict

import numpy as np


class _Reader:

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
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
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode("utf-8")
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return bytes(self.take(n)).decode("utf-8")
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (1, 3):
            raise ValueError(f"unsupported msgpack extension type {code}")
        r = _Reader(payload)
        shape, dtype_name, buf = r.value()
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode("ascii")
        if dtype_name == "bfloat16":
            arr = (np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
                   ).view(np.float32)
        else:
            arr = np.frombuffer(buf, np.dtype(dtype_name))
        arr = arr.reshape(tuple(shape)).copy()
        return arr if code == 1 else arr[()]


def load(path) -> Dict[str, Any]:
    """The checkpoint as one dict: its config scalars and its variable
    trees (``{"encoder": {"params": {...}}, ...}``, numpy arrays)."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    payload = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    state = dict(payload["state"])
    state.update(json.loads(payload["config"]))
    return state
