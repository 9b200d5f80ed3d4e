"""Codec ABI and registry (the numcodecs-style surface), the general
byte codecs, and the CAE codecs' shared frame geometry.

The port keeps a registry of its own: ``encode``/``decode(out=None)``,
``get_config``/``from_config`` for zarr metadata, keyed by ``codec_id``.
Codec configs written by the JAX package instantiate the port's codec of
the same id, and the reverse.  The general codecs (zlib, gzip, bz2, lzma,
blosc) write the bytes the JAX package's write; the CAE and image codecs
live in their own modules, which ``get_codec`` imports on first use.
"""

import bz2
import importlib
import lzma
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

# a frame header is untrusted input and its (h, w) size allocations: a
# garbage header must raise, not allocate gigabytes (same bounds as the JAX
# package's cae_codec)
_MAX_TILE_SIDE = 1 << 16
_MAX_TILE_PX = 1 << 28


def check_frame_hw(h: int, w: int) -> None:
    if not (0 < h <= _MAX_TILE_SIDE and 0 < w <= _MAX_TILE_SIDE
            and h * w <= _MAX_TILE_PX):
        raise ValueError(
            f"implausible frame header: {h}x{w} px tile (corrupt or "
            "non-cae bitstream)")


def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


def padded_hw(h: int, w: int, level: int) -> Tuple[int, int]:
    """Tile size after reflect padding to a multiple of 2**level."""
    m = 2 ** level
    return _ceil_to(h, m), _ceil_to(w, m)


def latent_hw(h: int, w: int, level: int) -> Tuple[int, int]:
    m = 2 ** level
    return -(-h // m), -(-w // m)


class Codec:
    """Base codec: subclasses set ``codec_id`` and implement encode/decode."""

    codec_id: str = None
    # the CAE codecs run a model and take ``device`` (a run-time choice that
    # no stored config carries); the others take no device
    takes_device: bool = False

    def encode(self, buf) -> bytes:
        raise NotImplementedError

    def decode(self, buf, out=None):
        raise NotImplementedError

    def get_config(self) -> Dict[str, Any]:
        return {"id": self.codec_id}

    @classmethod
    def from_config(cls, config: Dict[str, Any], **kwargs) -> "Codec":
        """``kwargs`` (e.g. ``device``) are run-time choices that the stored
        config does not carry; ``device`` reaches only a codec that takes
        one."""
        config = {k: v for k, v in config.items() if k != "id"}
        if not cls.takes_device:
            kwargs.pop("device", None)
        return cls(**config, **kwargs)

    def __repr__(self):
        return f"{type(self).__name__}(id={self.codec_id!r})"


_REGISTRY: Dict[str, type] = {}
# codec id -> the module that registers it (the JAX registry's map, plus the
# ids the image codecs register under)
_LAZY = {"cae": "cae_codec", "cae_bn": "cae_codec", "cae_tpu": "turbo_codec",
         "jpeg": "image_codecs", "jpeg2k": "image_codecs",
         "imagecodecs_jpeg": "image_codecs",
         "imagecodecs_jpeg2k": "image_codecs"}


def register_codec(cls, codec_id: Optional[str] = None) -> None:
    _REGISTRY[codec_id or cls.codec_id] = cls


def get_codec(config, **kwargs) -> Optional[Codec]:
    """Instantiate a codec from a config dict (zarr v2 compressor field)."""
    if config is None:
        return None
    if isinstance(config, Codec):
        return config
    codec_id = config["id"]
    if codec_id not in _REGISTRY and codec_id in _LAZY:
        # registers on import; a fresh reader may not have imported it
        importlib.import_module(f".{_LAZY[codec_id]}", __package__)
    if codec_id not in _REGISTRY:
        raise KeyError(f"Codec {codec_id!r} is not registered")
    return _REGISTRY[codec_id].from_config(config, **kwargs)


def ndarray_copy(src, out):
    """Copy decoded bytes/array into ``out`` if given (numcodecs helper)."""
    if out is None:
        return src
    out_view = out.reshape(-1).view(np.uint8)
    src_view = np.ascontiguousarray(src).reshape(-1).view(np.uint8)
    out_view[:src_view.size] = src_view
    return out


def ensure_bytes(buf) -> bytes:
    if isinstance(buf, (bytes, bytearray, memoryview)):
        return bytes(buf)
    return np.ascontiguousarray(buf).tobytes()


class Zlib(Codec):
    codec_id = "zlib"

    def __init__(self, level: int = 1):
        self.level = int(level)

    def encode(self, buf) -> bytes:
        return zlib.compress(ensure_bytes(buf), self.level)

    def decode(self, buf, out=None):
        data = np.frombuffer(zlib.decompress(bytes(buf)), np.uint8)
        return ndarray_copy(data, out)

    def get_config(self):
        return {"id": self.codec_id, "level": self.level}


class GZip(Zlib):
    codec_id = "gzip"

    def encode(self, buf) -> bytes:
        co = zlib.compressobj(self.level, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
        return co.compress(ensure_bytes(buf)) + co.flush()

    def decode(self, buf, out=None):
        data = np.frombuffer(zlib.decompress(bytes(buf), 16 + zlib.MAX_WBITS),
                             np.uint8)
        return ndarray_copy(data, out)


class BZ2(Codec):
    codec_id = "bz2"

    def __init__(self, level: int = 1):
        self.level = int(level)

    def encode(self, buf) -> bytes:
        return bz2.compress(ensure_bytes(buf), self.level)

    def decode(self, buf, out=None):
        return ndarray_copy(np.frombuffer(bz2.decompress(bytes(buf)),
                                          np.uint8), out)

    def get_config(self):
        return {"id": self.codec_id, "level": self.level}


class LZMACodec(Codec):
    codec_id = "lzma"

    def __init__(self, preset: int = 1, **_):
        self.preset = int(preset)

    def encode(self, buf) -> bytes:
        return lzma.compress(ensure_bytes(buf), preset=self.preset)

    def decode(self, buf, out=None):
        return ndarray_copy(np.frombuffer(lzma.decompress(bytes(buf)),
                                          np.uint8), out)

    def get_config(self):
        return {"id": self.codec_id, "preset": self.preset}


class Blosc(Codec):
    """zarr-compatible blosc chunks.  Through the C ``blosc`` module when it
    is importable; else through ``blosc_frame.py``, a stdlib blosc1 frame
    with zlib blocks that c-blosc readers read, in which mode a cname other
    than zlib becomes zlib (``get_config`` reports what was written)."""

    codec_id = "blosc"

    def __init__(self, cname: str = "zlib", clevel: int = 5, shuffle: int = 1,
                 blocksize: int = 0):
        self.cname = cname
        self.clevel = int(clevel)
        self.shuffle = int(shuffle)
        self.blocksize = int(blocksize)
        try:
            import blosc
            self._blosc = blosc
        except ImportError:
            self._blosc = None
        if self._blosc is None and cname != "zlib":
            self.cname = "zlib"

    def encode(self, buf) -> bytes:
        data = ensure_bytes(buf)
        if self._blosc is not None:
            return self._blosc.compress(data, typesize=1, cname=self.cname,
                                        clevel=self.clevel,
                                        shuffle=self.shuffle)
        from . import blosc_frame
        return blosc_frame.compress(data, typesize=1, clevel=self.clevel,
                                    shuffle=self.shuffle,
                                    blocksize=self.blocksize)

    def decode(self, buf, out=None):
        if self._blosc is not None:
            data = np.frombuffer(self._blosc.decompress(bytes(buf)), np.uint8)
        else:
            from . import blosc_frame
            data = np.frombuffer(blosc_frame.decompress(buf), np.uint8)
        return ndarray_copy(data, out)

    def get_config(self):
        return {"id": self.codec_id, "cname": self.cname,
                "clevel": self.clevel, "shuffle": self.shuffle,
                "blocksize": self.blocksize}


for _cls in (Zlib, GZip, BZ2, LZMACodec, Blosc):
    register_codec(_cls)
