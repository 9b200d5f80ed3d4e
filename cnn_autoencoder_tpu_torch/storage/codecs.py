"""Codec ABI and registry (the numcodecs-style surface), plus the CAE
codecs' shared frame geometry.

The port keeps a registry of its own: ``encode``/``decode(out=None)``,
``get_config``/``from_config`` for zarr metadata, keyed by ``codec_id``.
Codec configs written by the JAX package (``{"id": "cae_tpu",
"checkpoint": ..., "num_streams": ...}``) instantiate the port's codec.
"""

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

    def encode(self, buf) -> bytes:
        raise NotImplementedError

    def decode(self, buf, out=None):
        raise NotImplementedError

    def get_config(self) -> Dict[str, Any]:
        return {"id": self.codec_id}

    @classmethod
    def from_config(cls, config: Dict[str, Any], **kwargs) -> "Codec":
        """``kwargs`` (e.g. ``device``) are run-time choices that the stored
        config does not carry."""
        config = {k: v for k, v in config.items() if k != "id"}
        return cls(**config, **kwargs)

    def __repr__(self):
        return f"{type(self).__name__}(id={self.codec_id!r})"


_REGISTRY: Dict[str, type] = {}


def register_codec(cls, codec_id: Optional[str] = None) -> None:
    _REGISTRY[codec_id or cls.codec_id] = cls


def get_codec(config, **kwargs) -> Optional[Codec]:
    """Instantiate a codec from a config dict (zarr v2 compressor field)."""
    if config is None:
        return None
    if isinstance(config, Codec):
        return config
    codec_id = config["id"]
    if codec_id == "cae_tpu" and codec_id not in _REGISTRY:
        # registers on import; a fresh reader may not have imported it
        from . import turbo_codec  # noqa: F401
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
