"""Host rANS coder of the 'cae' / 'cae_bn' frames, of the interleaved
(frame-v4) word queues and of the pixel transport: a ctypes binding to the
port's C++ coder (``csrc/rans.cpp``).

The library is built with ``g++`` at first use, never at import, into
``build/host/<hash>/`` beside the package, where ``<hash>`` is taken over
the source, the compiler commands and the host's CPU, so an edited source or
another CPU builds anew and an unchanged one loads the cached library.
``-march=native`` is tried first and the generic flags second, as in the
JAX package.  Processes that build at once take a file lock, compile to a
temporary name and rename the result into place, so each loads one whole
library.  A missing ``g++`` or a failed build raises with the compiler's
message: there is no Python fallback (``_rans_py`` is the plain version
the tests hold the library to).

All entries take numpy arrays.  The batched entries release the
interpreter lock in C++ (OpenMP over tiles).  The pixel entries
(``pixel_*``) are called by ``coding/pixel_rans.py`` and
``coding/pixel_pack.py`` through ``load_library()``.
"""

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "rans.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "host"
LIB_NAME = "librans.so"
_BASE_CMD = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp"]
# the library is built on the machine it runs on, so -march=native is safe;
# the generic build is the second choice if the toolchain rejects it
COMMANDS = (_BASE_CMD[:1] + ["-march=native"] + _BASE_CMD[1:], _BASE_CMD)

# worst case bytes a symbol: 1 regular + up to 11 bypass renorm words
_WORST_CASE_BYTES_PER_SYMBOL = 48
_HEADROOM = 32

_LOCK = threading.Lock()
_lib = None
build_seconds = 0.0   # of the build this process ran (0 if it loaded one)


def _cpuinfo() -> dict:
    """Each field of /proc/cpuinfo with the sorted set of its values over
    the cores; empty where it cannot be read."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, sep, value = line.partition(":")
                if sep:
                    fields.setdefault(key.strip(), set()).add(value.strip())
    except OSError:
        return {}
    return {k: sorted(v) for k, v in fields.items()}


def _cpu_id() -> str:
    """The host CPU's model and flags: a -march=native build is kept per
    CPU."""
    info = _cpuinfo()
    if not info:
        return platform.machine() + platform.processor()
    return "\n".join(info.get("model name", []) + info.get("flags", []))


def cpu_name() -> str:
    """The host CPU's model name, or its vendor, family and model numbers
    where the name reads 'unknown'."""
    info = {k: v[0] for k, v in _cpuinfo().items()}
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"{info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}"
            + (" (AVX-512)" if "avx512f" in info.get("flags", "") else ""))


def _build_dir() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    for cmd in COMMANDS:
        h.update(" ".join(cmd).encode())
    h.update(_cpu_id().encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _compile(out_dir: Path) -> Path:
    """Build into a temporary file and rename it into place; raises with
    the compiler's output if every command fails."""
    global build_seconds
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(prefix="build-", suffix=".so", dir=out_dir)
    os.close(fd)
    errors = []
    try:
        for cmd in COMMANDS:
            try:
                res = subprocess.run(cmd + ["-o", tmp, str(SRC)],
                                     capture_output=True, text=True,
                                     timeout=300)
            except FileNotFoundError as exc:
                raise RuntimeError(
                    "g++ not found: the host rANS coder of "
                    "cnn_autoencoder_tpu_torch is built with g++") from exc
            if res.returncode == 0:
                lib = out_dir / LIB_NAME
                os.replace(tmp, lib)
                build_seconds = time.perf_counter() - t0
                return lib
            errors.append(f"$ {' '.join(cmd)}\n{res.stderr}")
        raise RuntimeError("host rANS coder build failed:\n"
                           + "\n".join(errors))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library() -> ctypes.CDLL:
    """The coder's shared library, built on first use."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / LIB_NAME
        if not path.exists():
            with open(out_dir / "lock", "w") as lock:
                # across processes: one builds, the others wait and load it
                fcntl.flock(lock, fcntl.LOCK_EX)
                try:
                    if not path.exists():
                        path = _compile(out_dir)
                finally:
                    fcntl.flock(lock, fcntl.LOCK_UN)
        lib = ctypes.CDLL(str(path))
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        p_u16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        sigs = {
            "rans_encode_with_indexes": (i64, [p_i32, p_i32, i64, p_u32, i64,
                                               p_i32, p_i32, p_u8, i64]),
            "rans_decode_with_indexes": (None, [p_u8, i64, p_i32, i64, p_u32,
                                                i64, p_i32, p_i32, p_i32]),
            "rans_encode_batch": (i32, [p_i32, p_i32, i64, i64, p_u32, i64,
                                        p_i32, p_i32, p_u8, i64, p_i64]),
            "rans_decode_batch": (None, [p_u8, p_i64, p_i64, p_i32, i64, i64,
                                         p_u32, i64, p_i32, p_i32, p_i32]),
            "ilv_encode": (i64, [p_i32, p_i32, i64, p_i32, p_i32, i64,
                                 p_i32, p_i32, i64, p_u16, i64]),
            "ilv_decode": (i32, [p_u16, i64, p_i32, i64, p_i32, p_i32, i64,
                                 p_i32, p_i32, i64, i64, p_i32]),
            "pixel_unpack_blocks": (i64, [p_u32, i64, p_u8, i64, i64, i64,
                                          i64, i64, p_u8]),
            "pixel_rans_decode": (i32, [p_u16, i64, p_i32, p_i32, i32, i64,
                                        i64, i64, i64, i64, p_u8, i64]),
            "pixel_predict_zigzag": (None, [p_u8, i64, i64, i64, i64, p_u8,
                                            i64]),
            "pixel_rans_encode": (i64, [p_u8, i64, i64, i64, i64, p_i32,
                                        p_i32, i32, i64, p_u16, i64, i64]),
            "rans_num_threads": (i32, []),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def num_threads() -> int:
    """OpenMP threads the batched entries use."""
    return int(load_library().rans_num_threads())


def _as_tables(cdfs, cdf_lengths, offsets):
    cdfs = np.ascontiguousarray(cdfs, np.uint32)
    cdf_lengths = np.ascontiguousarray(cdf_lengths, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int32)
    return cdfs, cdf_lengths, offsets


def encode_with_indexes(symbols, indexes, cdfs, cdf_lengths,
                        offsets) -> bytes:
    """Encode one flat symbol array; returns the bitstream bytes."""
    symbols = np.ascontiguousarray(symbols, np.int32).ravel()
    indexes = np.ascontiguousarray(indexes, np.int32).ravel()
    cdfs, cdf_lengths, offsets = _as_tables(cdfs, cdf_lengths, offsets)
    lib = load_library()
    n = symbols.shape[0]
    capacity = n * _WORST_CASE_BYTES_PER_SYMBOL + _HEADROOM
    out = np.empty(capacity, np.uint8)
    size = lib.rans_encode_with_indexes(
        symbols, indexes, n, cdfs, cdfs.shape[1], cdf_lengths, offsets, out,
        capacity)
    if size < 0:
        raise RuntimeError("rANS encode overflow")
    return out[:size].tobytes()


def decode_with_indexes(data, indexes, cdfs, cdf_lengths,
                        offsets) -> np.ndarray:
    """Decode a bitstream back into an int32 symbol array.  A truncated or
    corrupt stream decodes to garbage symbols, never past its end."""
    indexes = np.ascontiguousarray(indexes, np.int32).ravel()
    cdfs, cdf_lengths, offsets = _as_tables(cdfs, cdf_lengths, offsets)
    lib = load_library()
    n = indexes.shape[0]
    buf = np.frombuffer(bytes(data), np.uint8).copy()
    out = np.empty(n, np.int32)
    lib.rans_decode_with_indexes(buf, buf.shape[0], indexes, n, cdfs,
                                 cdfs.shape[1], cdf_lengths, offsets, out)
    return out


def encode_batch(symbols, indexes, cdfs, cdf_lengths, offsets):
    """Encode (B, n) symbol tiles in parallel; returns a list of bytes."""
    symbols = np.ascontiguousarray(symbols, np.int32)
    if symbols.ndim != 2:
        raise ValueError(f"symbols must be (B, n), got {symbols.shape}")
    batch, n = symbols.shape
    indexes = np.ascontiguousarray(indexes, np.int32).ravel()
    if indexes.shape[0] != n:
        raise ValueError(f"{indexes.shape[0]} indexes for {n} symbols")
    cdfs, cdf_lengths, offsets = _as_tables(cdfs, cdf_lengths, offsets)
    lib = load_library()
    capacity = n * _WORST_CASE_BYTES_PER_SYMBOL + _HEADROOM
    out = np.empty((batch, capacity), np.uint8)
    sizes = np.empty(batch, np.int64)
    ok = lib.rans_encode_batch(symbols, indexes, batch, n, cdfs,
                               cdfs.shape[1], cdf_lengths, offsets, out,
                               capacity, sizes)
    if not ok:
        raise RuntimeError("rANS batch encode overflow")
    return [out[b, :sizes[b]].tobytes() for b in range(batch)]


def decode_batch(streams, indexes, cdfs, cdf_lengths,
                 offsets) -> np.ndarray:
    """Decode a list of bitstreams into a (B, n) int32 symbol array."""
    indexes = np.ascontiguousarray(indexes, np.int32).ravel()
    n = indexes.shape[0]
    batch = len(streams)
    cdfs, cdf_lengths, offsets = _as_tables(cdfs, cdf_lengths, offsets)
    lib = load_library()
    sizes = np.asarray([len(s) for s in streams], np.int64)
    data_offsets = np.zeros(batch, np.int64)
    np.cumsum(sizes[:-1], out=data_offsets[1:])
    data = (np.concatenate([np.frombuffer(bytes(s), np.uint8)
                            for s in streams]) if batch
            else np.zeros(0, np.uint8))
    out = np.empty((batch, n), np.int32)
    lib.rans_decode_batch(data, data_offsets, sizes, indexes, batch, n, cdfs,
                          cdfs.shape[1], cdf_lengths, offsets, out)
    return out


def _ilv_tables(indexes, freqs, starts, lengths, offsets):
    """The tables as contiguous int32, after checking that every index
    names one of their channels (the C++ coder reads the rows unchecked)."""
    freqs, starts, lengths, offsets = (
        np.ascontiguousarray(a, np.int32)
        for a in (freqs, starts, lengths, offsets))
    channels = freqs.shape[0]
    if (starts.shape != freqs.shape or lengths.shape != (channels,)
            or offsets.shape != (channels,)):
        raise ValueError(f"interleaved rANS tables: freqs {freqs.shape}, "
                         f"starts {starts.shape}, lengths {lengths.shape}, "
                         f"offsets {offsets.shape}")
    if indexes.size and not 0 <= indexes.min() <= indexes.max() < channels:
        raise ValueError(f"channel indexes outside 0..{channels - 1}")
    if lengths.size and lengths.max() > freqs.shape[1]:
        raise ValueError(f"a channel length past the tables' "
                         f"{freqs.shape[1]} columns")
    return freqs, starts, lengths, offsets


def encode_interleaved(symbols, indexes, freqs, starts, lengths, offsets,
                       num_streams: int) -> np.ndarray:
    """Interleaved multi-stream rANS-32/16 encode, the host twin of the
    device coder's frame-v4 queue (``coding/device_rans.py``).  ``symbols``
    are step-major (symbol i goes to stream i % num_streams) with their
    channel in ``indexes``; the tables are 12-bit (freq, start) rows per
    channel, ``lengths`` values from ``offsets``.

    Returns the uint16 words (flush, then payload).  Raises ValueError on a
    symbol outside its channel's support (the format has no escapes) or a
    channel of more than 256 values."""
    symbols = np.ascontiguousarray(symbols, np.int32).ravel()
    indexes = np.ascontiguousarray(indexes, np.int32).ravel()
    freqs, starts, lengths, offsets = _ilv_tables(indexes, freqs, starts,
                                                  lengths, offsets)
    if indexes.shape != symbols.shape:
        raise ValueError(f"{indexes.shape[0]} indexes for "
                         f"{symbols.shape[0]} symbols")
    lib = load_library()
    n = symbols.shape[0]
    capacity = 2 * num_streams + n + 16  # at most one word a symbol
    out = np.empty(capacity, np.uint16)
    total = lib.ilv_encode(symbols, indexes, n, freqs, starts,
                           freqs.shape[1], lengths, offsets, num_streams,
                           out, capacity)
    if total == -1:
        raise ValueError("symbol outside its channel support")
    if total == -3:
        raise ValueError("interleaved rANS supports <=256 values/channel")
    if total < 0:
        raise RuntimeError("interleaved rANS capacity overflow")
    return out[:total].copy()


def decode_interleaved(words, indexes, freqs, starts, lengths, offsets,
                       num_streams: int) -> np.ndarray:
    """Decode an interleaved word queue back to int32 symbols; reads past
    a truncated queue take zero words (garbage out, no overread)."""
    words = np.ascontiguousarray(words, np.uint16).ravel()
    indexes = np.ascontiguousarray(indexes, np.int32).ravel()
    freqs, starts, lengths, offsets = _ilv_tables(indexes, freqs, starts,
                                                  lengths, offsets)
    lib = load_library()
    n = indexes.shape[0]
    out = np.empty(n, np.int32)
    rc = lib.ilv_decode(words, words.shape[0], indexes, n, freqs, starts,
                        freqs.shape[1], lengths, offsets, freqs.shape[0],
                        num_streams, out)
    if rc != 0:
        raise ValueError("interleaved rANS supports <=256 values/channel")
    return out
