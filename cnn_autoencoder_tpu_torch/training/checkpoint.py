"""Checkpoint reading and writing: the JAX package's self-describing
``.msgpack`` files.

A checkpoint is flax's msgpack serialization of
``{"config": <json str>, "state": <tree of arrays>}``.  flax stores each
ndarray as msgpack extension type 1 whose payload is itself a msgpack array
``(shape, dtype name, raw C-order bytes)``; arrays above 2**30 bytes are
split into ``__msgpack_chunked_array__`` dicts.  The decoder below reads
exactly that subset of msgpack (maps, arrays, str, bin, ints, floats, nil,
bool and ext types 1 and 3), and the encoder writes it (no chunking: it
refuses an array above 2**30 bytes, which no model of the port holds), so
no ``msgpack`` or ``flax`` package is needed.  ``save_checkpoint`` writes
a flat state dict as the JAX package's does: JSON-able values go to the
config, module variable trees, optimizer and scheduler states and other
trees to the arrays, with their leaves as numpy arrays and their lists as
``{"0": ..., "1": ...}`` dicts, as flax's state dicts hold them.  Both the
JAX package's ``load_checkpoint`` and this module's read it.  A reference
torch ``.pth`` / ``.pt`` is converted by ``utils/torch_import.py``.
"""

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..parallel.distributed import is_primary
from ..utils.torch_import import load_torch_checkpoint
from ..utils.weights import state_to_jax

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
_MAX_ARRAY_BYTES = 2 ** 30


class _Reader:
    """Sequential msgpack decoder over one bytes buffer."""

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
        raw = self.take(struct.calcsize(fmt))
        return struct.unpack(fmt, raw)[0]

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
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            return getattr(self, kind)(n)
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

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")


def _dtype(name) -> Tuple[np.dtype, bool]:
    """(storage dtype, is_bfloat16): numpy has no bfloat16, so it is read
    as its raw 16 bits and widened to float32 exactly."""
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if name == "bfloat16":
        return np.dtype(np.uint16), True
    return np.dtype(name), False


def _ndarray(payload: bytes) -> np.ndarray:
    r = _Reader(payload)
    shape, dtype_name, buf = r.value()
    if r.pos != len(payload):
        raise ValueError("trailing bytes in an ndarray extension")
    dt, bf16 = _dtype(dtype_name)
    arr = np.frombuffer(buf, dtype=dt).reshape(tuple(shape))
    if bf16:
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.copy()


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED):
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """Decode flax-msgpack bytes into a tree of dicts, lists, scalars and
    numpy arrays (the counterpart of ``flax.serialization.msgpack_restore``)."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def load_checkpoint(source) -> Dict[str, Any]:
    """Load a checkpoint into a flat state dict: the config scalars merged
    with the module variable trees (numpy arrays).

    Accepts an in-memory dict (returned as is), a ``.msgpack`` path or a
    reference torch ``.pth`` / ``.pt`` (converted; JAX
    ``training/checkpoint.py:72-74``)."""
    if isinstance(source, dict):
        return source
    if not isinstance(source, (str, os.PathLike)):
        raise TypeError(f"Unsupported checkpoint source: {type(source)}")
    path = os.fspath(source)
    if path.endswith((".pth", ".pt")):
        return load_torch_checkpoint(path)
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    state = dict(payload["state"])
    state.update(json.loads(payload["config"]))
    return state


class _Writer:
    """Sequential msgpack encoder: the mirror of ``_Reader``."""

    def __init__(self):
        self.out = bytearray()

    def pack(self, fmt: str, *values) -> None:
        self.out += struct.pack(fmt, *values)

    def header(self, n: int, fix: int, fix_max: int, codes) -> None:
        """A length-prefixed header: the fix form up to ``fix_max``, then
        the 8/16/32-bit forms in ``codes`` (None where msgpack has none)."""
        if fix is not None and n <= fix_max:
            self.out.append(fix | n)
            return
        for code, fmt, limit in zip(codes, "BHI", (0xFF, 0xFFFF, 0xFFFFFFFF)):
            if code is not None and n <= limit:
                self.pack(">B" + fmt, code, n)
                return
        raise ValueError(f"msgpack item of length {n} is too long")

    def integer(self, n: int) -> None:
        if 0 <= n <= 0x7F or -32 <= n < 0:
            self.out.append(n & 0xFF)
            return
        kinds = (((0xCC, "B", 2 ** 8), (0xCD, "H", 2 ** 16),
                  (0xCE, "I", 2 ** 32), (0xCF, "Q", 2 ** 64)) if n >= 0 else
                 ((0xD0, "b", 2 ** 7), (0xD1, "h", 2 ** 15),
                  (0xD2, "i", 2 ** 31), (0xD3, "q", 2 ** 63)))
        for code, fmt, limit in kinds:
            if (n < limit) if n >= 0 else (n >= -limit):
                self.pack(">B" + fmt, code, n)
                return
        raise ValueError(f"integer {n} does not fit msgpack")

    def value(self, v: Any) -> None:
        if v is None:
            self.out.append(0xC0)
        elif isinstance(v, bool):
            self.out.append(0xC3 if v else 0xC2)
        elif isinstance(v, int):
            self.integer(v)
        elif isinstance(v, float):
            self.pack(">Bd", 0xCB, v)
        elif isinstance(v, str):
            raw = v.encode("utf-8")
            self.header(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
            self.out += raw
        elif isinstance(v, bytes):
            self.header(len(v), None, 0, (0xC4, 0xC5, 0xC6))
            self.out += v
        elif isinstance(v, dict):
            self.header(len(v), 0x80, 15, (None, 0xDE, 0xDF))
            for k, x in v.items():
                self.value(k)
                self.value(x)
        elif isinstance(v, (list, tuple)):
            self.header(len(v), 0x90, 15, (None, 0xDC, 0xDD))
            for x in v:
                self.value(x)
        elif isinstance(v, np.ndarray):
            if v.nbytes > _MAX_ARRAY_BYTES:
                raise ValueError(f"array of {v.nbytes} bytes: chunked arrays "
                                 "are not written")
            payload = msgpack_serialize([list(v.shape), v.dtype.name,
                                         np.ascontiguousarray(v).tobytes()])
            self.header(len(payload), None, 0, (0xC7, 0xC8, 0xC9))
            self.pack(">b", _EXT_NDARRAY)
            self.out += payload
        else:
            raise TypeError(f"cannot write {type(v).__name__} to msgpack")


def msgpack_serialize(tree) -> bytes:
    """Encode a tree of dicts, lists, scalars and numpy arrays as flax-msgpack
    bytes (the counterpart of ``flax.serialization.msgpack_serialize``)."""
    w = _Writer()
    w.value(tree)
    return bytes(w.out)


def model_state(model) -> Dict[str, Any]:
    """A ``CAEModel``'s config and variables as one flat state dict: the
    config scalars and ``{"encoder" | "decoder" | "fact_ent": {"params":
    tree[, "batch_stats": tree]}}``, HWIO kernels as the JAX package keeps
    them; parameters held as model-axis shards gathered first, so the
    state is one process's (a collective for a sharded model)."""
    from ..parallel.mesh import gather_model_state
    return {**model.config,
            **state_to_jax(gather_model_state(model), model.config)}


def _split_state(state: Dict[str, Any]):
    """Separate JSON-able config values from array trees (JAX
    ``training/checkpoint.py:25``)."""
    config, arrays = {}, {}
    for k, v in state.items():
        if isinstance(v, (dict, np.ndarray, torch.Tensor)):
            arrays[k] = v
        elif isinstance(v, (list, tuple)) and len(v) > 0 and isinstance(
                v[0], (np.ndarray, torch.Tensor)):
            arrays[k] = list(v)
        else:
            try:
                json.dumps(v)
                config[k] = v
            except TypeError:
                arrays[k] = v
    return config, arrays


def _state_tree(v):
    """Dicts stay dicts, lists and tuples become ``{"<i>": ...}``, None
    stays None, every other leaf becomes a numpy array: flax's
    ``to_state_dict`` followed by ``jax.tree_util.tree_map(np.asarray)``,
    which also sorts every dict's keys, so a state writes the bytes the JAX
    package writes for it."""
    if isinstance(v, (list, tuple)):
        v = dict(enumerate(v))
    if isinstance(v, dict):
        return {k: _state_tree(x) for k, x in sorted(
            (str(k), x) for k, x in v.items())}
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path, state) -> None:
    """Write a self-describing checkpoint that both packages load.
    ``state`` is a flat dict of config values, module variable trees,
    optimizer and scheduler states and histories (JAX
    ``training/checkpoint.py:47``); a ``CAEModel`` stands for its
    ``model_state``.  The file is replaced atomically.  In a multi-process
    run only rank 0 writes (every rank holds the same state; two writers
    of one path would race); a model held as model-axis shards is gathered
    first, so every rank of its model group calls this."""
    if isinstance(state, torch.nn.Module):
        state = model_state(state)
    if not is_primary():
        return
    config, arrays = _split_state(state)
    payload = {"config": json.dumps(config), "state": _state_tree(arrays)}
    data = msgpack_serialize(payload)
    path = os.fspath(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
