"""Minimal zarr-v2 directory store: arrays, groups, attributes.

The port's copy of the JAX package's own store (``storage/zarr.py``):
``.zgroup``/``.zarray``/``.zattrs`` JSON metadata, C-order chunk files with
a configurable dimension separator, codecs through ``storage.codecs``.  It
writes the same metadata JSON and the same chunk keys, so a store written by
either package opens in the other (``tests/test_torch_zarr.py``).

Scope: what the pipelines need: whole-chunk read/write (the tile pipeline is
chunk-aligned by design), basic slicing, group trees, attributes.  Chunk IO
is thread-safe (one file per chunk) so the pipeline's thread pools can fan
out.

The one addition is ``device``: a store opened or created by the port holds
the device on which a 'cae' or 'cae_tpu' codec of its metadata builds its
model (``None``: the card; tests pass ``device="cpu"``).  It is a run-time
choice and never enters the stored metadata; codecs that take no device
never receive it.
"""

import builtins
import itertools
import json
import os
import shutil
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np

from .codecs import Codec, get_codec

# Read-only remote stores: s3:// and http(s):// paths route every read
# through data.remote.  s3:// requests are SigV4-signed when
# AWS credentials are in the environment (anonymous otherwise), and s3://
# groups list + size themselves via ListObjectsV2; plain-HTTP stores
# cannot list.  Writes are local-only: the pipelines only ever write
# local outputs.
from ..data.remote import aws_credentials, fetch_remote, is_remote


def _join(base: str, *parts: str) -> str:
    if is_remote(base):
        return "/".join([base.rstrip("/")]
                        + [str(p).strip("/") for p in parts])
    return os.path.join(base, *parts)


def _read_bytes_denied(path: str, missing_403_ok: bool = False):
    """``(contents | None, ambiguous_denied)``: like `_read_bytes` but
    also reports whether the absence was a credentialed S3 AccessDenied
    that ``missing_403_ok`` mapped to None (GetObject-only principals see
    403 for absent keys, so existing-but-denied is indistinguishable from
    missing at the S3 API level).  The ONE implementation of the
    remote-read-to-absence mapping — it must mirror fetch_remote's raise
    surface (FileNotFoundError for definitive/mapped absence with the
    HTTP error as __cause__, RuntimeError on retry exhaustion)."""
    if is_remote(path):
        try:
            return fetch_remote(path, missing_403_ok=missing_403_ok), False
        except FileNotFoundError as e:
            # only a SIGNED 403 is the ambiguous case; anonymous 403s
            # already read as plain absence everywhere
            denied = (missing_403_ok
                      and getattr(e.__cause__, "code", None) == 403
                      and path.startswith("s3://")
                      and aws_credentials() is not None)
            return None, denied
        except RuntimeError:
            return None, False
    if not os.path.exists(path):
        return None, False
    with builtins.open(path, "rb") as f:
        return f.read(), False


def _read_bytes(path: str, missing_403_ok: bool = False) -> Optional[bytes]:
    """File/object contents, or None when absent (local missing file or
    remote 4xx/5xx after retries).  ``missing_403_ok`` maps a credentialed
    S3 AccessDenied to absent — only set for chunk reads after a signed
    metadata read of the same store succeeded (see fetch_remote)."""
    return _read_bytes_denied(path, missing_403_ok)[0]


def _check_writable(path: str):
    if is_remote(path):
        raise OSError(f"remote zarr stores are read-only: {path}")


def _dtype_to_str(dt: np.dtype) -> str:
    dt = np.dtype(dt)
    if dt.byteorder == "=":
        order = "<" if dt.itemsize > 1 else "|"
    else:
        order = dt.byteorder if dt.itemsize > 1 else "|"
    return f"{order}{dt.kind}{dt.itemsize}"


class Attributes(dict):
    """Dict-backed .zattrs with write-through persistence."""

    def __init__(self, path: str):
        super().__init__()
        self._path = path
        # .zattrs is OPTIONAL metadata: absent is normal, so the ambiguous
        # credentialed AccessDenied (GetObject-only principal, no
        # ListBucket) reads as absent too — a genuinely denied store
        # already failed loudly on its REQUIRED .zarray/.zgroup read
        raw = _read_bytes(path, missing_403_ok=True)
        if raw is not None:
            dict.update(self, json.loads(raw))

    def _flush(self):
        _check_writable(self._path)
        with builtins.open(self._path, "w") as f:
            json.dump(self, f)

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self._flush()

    def update(self, *args, **kwargs):
        dict.update(self, *args, **kwargs)
        if args or kwargs:
            self._flush()

    def put(self, d):
        self.clear()
        self.update(d)


class Array:
    """A zarr v2 array in a directory store; its codec builds on
    ``device``."""

    def __init__(self, path: str, meta: Dict[str, Any], device=None):
        self.path = path
        self.device = device
        self._meta = meta
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value", 0)
        self._sep = meta.get("dimension_separator", ".")
        self._compressor = None
        self._compressor_loaded = False
        # every remote Array is constructed AFTER a signed .zarray read of
        # the same store succeeded (open / Group.__getitem__), so a
        # chunk-level S3 AccessDenied means "absent key under a
        # GetObject-only principal" (sparse fill_value state), not an auth
        # failure; distinguishable codes (ExpiredToken, ...) still raise
        self._chunk_403_is_missing = (path.startswith("s3://")
                                      and aws_credentials() is not None)
        self.attrs = Attributes(_join(path, ".zattrs"))

    @property
    def compressor(self):
        # lazy: heavyweight codecs (e.g. 'cae' loads a model) only
        # materialize when chunk data is actually encoded/decoded
        if not self._compressor_loaded:
            self._compressor = get_codec(self._meta.get("compressor"),
                                         device=self.device)
            self._compressor_loaded = True
        return self._compressor

    # -- construction ---------------------------------------------------

    @classmethod
    def create(cls, path: str, shape: Sequence[int], chunks: Sequence[int],
               dtype, compressor: Optional[Union[Codec, Dict]] = None,
               fill_value=0, dimension_separator: str = ".",
               overwrite: bool = False, device=None) -> "Array":
        if os.path.exists(os.path.join(path, ".zarray")) and not overwrite:
            raise FileExistsError(f"Array already exists at {path}")
        os.makedirs(path, exist_ok=True)
        comp_cfg = None
        if compressor is not None:
            comp_cfg = (compressor.get_config()
                        if isinstance(compressor, Codec) else dict(compressor))
        meta = {
            "zarr_format": 2,
            "shape": list(int(s) for s in shape),
            "chunks": list(int(c) for c in chunks),
            "dtype": _dtype_to_str(np.dtype(dtype)),
            "compressor": comp_cfg,
            "fill_value": fill_value,
            "order": "C",
            "filters": None,
            "dimension_separator": dimension_separator,
        }
        with builtins.open(os.path.join(path, ".zarray"), "w") as f:
            json.dump(meta, f)
        return cls(path, meta, device=device)

    @classmethod
    def open(cls, path: str, device=None) -> "Array":
        raw = _read_bytes(_join(path, ".zarray"))
        if raw is None:
            raise FileNotFoundError(f"No zarr array at {path}")
        return cls(path, json.loads(raw), device=device)

    # -- chunk addressing -------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def cdata_shape(self) -> Tuple[int, ...]:
        return tuple(-(-s // c) for s, c in zip(self.shape, self.chunks))

    @property
    def nchunks(self) -> int:
        n = 1
        for c in self.cdata_shape:
            n *= c
        return n

    def chunk_key(self, idx: Sequence[int]) -> str:
        return self._sep.join(str(i) for i in idx)

    def chunk_path(self, idx: Sequence[int]) -> str:
        key = self.chunk_key(idx)
        if self._sep == "/":
            return _join(self.path, *key.split("/"))
        return _join(self.path, key)

    def chunk_slices(self, idx: Sequence[int]):
        """(array slice, valid-extent shape) for chunk idx."""
        starts = [i * c for i, c in zip(idx, self.chunks)]
        stops = [min(st + c, s)
                 for st, c, s in zip(starts, self.chunks, self.shape)]
        sl = tuple(slice(st, sp) for st, sp in zip(starts, stops))
        valid = tuple(sp - st for st, sp in zip(starts, stops))
        return sl, valid

    def chunk_ids(self) -> Iterator[Tuple[int, ...]]:
        return itertools.product(*[range(n) for n in self.cdata_shape])

    # -- chunk IO --------------------------------------------------------

    def read_chunk(self, idx: Sequence[int]) -> np.ndarray:
        """Full (padded) chunk; missing chunks come back as fill_value."""
        raw = _read_bytes(self.chunk_path(idx),
                          missing_403_ok=self._chunk_403_is_missing)
        if raw is None:
            return np.full(self.chunks, self.fill_value, self.dtype)
        if self.compressor is not None:
            dec = self.compressor.decode(raw)
            arr = np.asarray(dec)
            if arr.dtype != self.dtype or arr.ndim != len(self.chunks):
                arr = np.frombuffer(
                    np.ascontiguousarray(arr).tobytes(), self.dtype)
            arr = arr.reshape(self.chunks)
        else:
            arr = np.frombuffer(raw, self.dtype).reshape(self.chunks)
        return arr

    def write_chunk(self, idx: Sequence[int], data: np.ndarray) -> int:
        """Write one full chunk (padded to chunk shape); returns stored bytes."""
        data = np.ascontiguousarray(data, self.dtype)
        if data.shape != tuple(self.chunks):
            padded = np.full(self.chunks, self.fill_value, self.dtype)
            padded[tuple(slice(0, s) for s in data.shape)] = data
            data = padded
        raw = (self.compressor.encode(data) if self.compressor is not None
               else data.tobytes())
        p = self.chunk_path(idx)
        _check_writable(p)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with builtins.open(p, "wb") as f:
            f.write(raw)
        return len(raw)

    def write_chunk_raw(self, idx: Sequence[int], raw: bytes) -> int:
        """Write pre-encoded chunk bytes (used by the pipelined encoder)."""
        p = self.chunk_path(idx)
        _check_writable(p)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with builtins.open(p, "wb") as f:
            f.write(raw)
        return len(raw)

    def read_chunk_raw(self, idx: Sequence[int]) -> Optional[bytes]:
        return _read_bytes(self.chunk_path(idx),
                           missing_403_ok=self._chunk_403_is_missing)

    # -- whole-array / sliced access ---------------------------------------

    def _expand_key(self, key):
        if key is Ellipsis or (isinstance(key, slice)
                               and key == slice(None)):
            return tuple(slice(None) for _ in self.shape)
        if not isinstance(key, tuple):
            key = (key,)
        if Ellipsis in key:
            i = key.index(Ellipsis)
            fill = self.ndim - (len(key) - 1)
            key = key[:i] + tuple(slice(None) for _ in range(fill)) \
                + key[i + 1:]
        return key + tuple(slice(None) for _ in range(self.ndim - len(key)))

    def __getitem__(self, key) -> np.ndarray:
        key = self._expand_key(key)
        norm = []
        for k, s in zip(key, self.shape):
            if isinstance(k, int):
                norm.append(slice(k, k + 1))
            else:
                norm.append(slice(*k.indices(s)))
        out_shape = tuple(sl.stop - sl.start for sl in norm)
        out = np.full(out_shape, self.fill_value, self.dtype)

        lo = [sl.start for sl in norm]
        hi = [sl.stop for sl in norm]
        first = [l // c for l, c in zip(lo, self.chunks)]
        last = [(h - 1) // c if h > l else l // c
                for l, h, c in zip(lo, hi, self.chunks)]
        for idx in itertools.product(*[range(f, la + 1)
                                       for f, la in zip(first, last)]):
            if any(h <= l for l, h in zip(lo, hi)):
                continue
            chunk = self.read_chunk(idx)
            c_sl, a_sl = [], []
            for d, (i, c) in enumerate(zip(idx, self.chunks)):
                c0 = i * c
                a0 = max(lo[d], c0)
                a1 = min(hi[d], c0 + c)
                c_sl.append(slice(a0 - c0, a1 - c0))
                a_sl.append(slice(a0 - lo[d], a1 - lo[d]))
            out[tuple(a_sl)] = chunk[tuple(c_sl)]

        sq = tuple(i for i, k in enumerate(key)
                   if isinstance(k, int))
        if sq:
            out = np.squeeze(out, axis=sq)
        return out

    def __setitem__(self, key, value):
        value = np.asarray(value, self.dtype)
        key = self._expand_key(key)
        norm = [slice(*k.indices(s)) if not isinstance(k, int)
                else slice(k, k + 1)
                for k, s in zip(key, self.shape)]
        value = np.broadcast_to(
            value, tuple(sl.stop - sl.start for sl in norm))

        lo = [sl.start for sl in norm]
        hi = [sl.stop for sl in norm]
        first = [l // c for l, c in zip(lo, self.chunks)]
        last = [(h - 1) // c if h > l else l // c
                for l, h, c in zip(lo, hi, self.chunks)]
        for idx in itertools.product(*[range(f, la + 1)
                                       for f, la in zip(first, last)]):
            _, valid = self.chunk_slices(idx)
            aligned = all(
                max(lo[d], idx[d] * self.chunks[d]) == idx[d] * self.chunks[d]
                and min(hi[d], idx[d] * self.chunks[d] + self.chunks[d])
                >= idx[d] * self.chunks[d] + valid[d]
                for d in range(self.ndim))
            chunk = (np.full(self.chunks, self.fill_value, self.dtype)
                     if aligned else self.read_chunk(idx))
            if not chunk.flags.writeable:
                chunk = chunk.copy()
            c_sl, v_sl = [], []
            for d, (i, c) in enumerate(zip(idx, self.chunks)):
                c0 = i * c
                a0 = max(lo[d], c0)
                a1 = min(hi[d], c0 + c)
                c_sl.append(slice(a0 - c0, a1 - c0))
                v_sl.append(slice(a0 - lo[d], a1 - lo[d]))
            chunk[tuple(c_sl)] = value[tuple(v_sl)]
            self.write_chunk(idx, chunk)

    # -- stats -------------------------------------------------------------

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.dtype.itemsize

    @property
    def nbytes_stored(self) -> int:
        """Total bytes on disk (metadata + chunks), the bpp accounting."""
        if is_remote(self.path):
            if self.path.startswith("s3://"):
                from ..data.remote import s3_list
                sizes, _ = s3_list(self.path, delimiter="")
                return sum(sizes.values())
            raise NotImplementedError(
                "nbytes_stored needs a directory walk; plain-HTTP stores "
                "cannot be listed (S3 stores list via ListObjectsV2)")
        total = 0
        for root, _, files in os.walk(self.path):
            for fn in files:
                total += os.path.getsize(os.path.join(root, fn))
        return total

    def __repr__(self):
        return (f"Array(shape={self.shape}, chunks={self.chunks}, "
                f"dtype={self.dtype}, path={self.path!r})")


class Group:
    """A zarr v2 group (directory with .zgroup); its arrays' codecs build
    on ``device``."""

    def __init__(self, path: str, device=None):
        self.path = path
        self.device = device
        self.attrs = Attributes(_join(path, ".zattrs"))

    @classmethod
    def create(cls, path: str, overwrite: bool = False,
               device=None) -> "Group":
        _check_writable(path)
        if overwrite and os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)
        zg = os.path.join(path, ".zgroup")
        if not os.path.exists(zg):
            with builtins.open(zg, "w") as f:
                json.dump({"zarr_format": 2}, f)
        return cls(path, device=device)

    @classmethod
    def open(cls, path: str, device=None) -> "Group":
        if _read_bytes(_join(path, ".zgroup")) is None:
            raise FileNotFoundError(f"No zarr group at {path}")
        return cls(path, device=device)

    def create_group(self, name: str) -> "Group":
        g = self
        for part in str(name).split("/"):
            g = Group.create(os.path.join(g.path, part), device=self.device)
        return g

    def create_dataset(self, name: str, **kwargs) -> Array:
        parts = str(name).split("/")
        g = self
        for part in parts[:-1]:
            g = Group.create(os.path.join(g.path, part), device=self.device)
        kwargs.setdefault("device", self.device)
        return Array.create(os.path.join(g.path, parts[-1]), **kwargs)

    def require_group(self, name: str) -> "Group":
        return Group.create(os.path.join(self.path, name),
                            device=self.device)

    def __contains__(self, name: str) -> bool:
        # membership PROBES: absence is a valid answer, so the ambiguous
        # credentialed AccessDenied reads as absent (see Attributes)
        p = _join(self.path, *str(name).split("/"))
        return (_read_bytes(_join(p, ".zarray"),
                            missing_403_ok=True) is not None
                or _read_bytes(_join(p, ".zgroup"),
                               missing_403_ok=True) is not None)

    def __getitem__(self, name: str):
        # The ambiguous credentialed AccessDenied (GetObject-only
        # principals see it for absent keys) maps to "absent" here like
        # the chunk reads do — an existing-but-denied member is
        # indistinguishable from a missing one at the S3 API level — but
        # the KeyError then SAYS so instead of silently reading as
        # absence; distinguishable auth codes (ExpiredToken, ...) still
        # raise PermissionError out of fetch_remote.
        p = _join(self.path, *str(name).split("/"))
        raw, denied = _read_bytes_denied(_join(p, ".zarray"),
                                         missing_403_ok=True)
        if raw is not None:
            return Array(p, json.loads(raw), device=self.device)
        raw2, denied2 = _read_bytes_denied(_join(p, ".zgroup"),
                                           missing_403_ok=True)
        if raw2 is not None:
            return Group(p, device=self.device)
        if denied or denied2:
            raise KeyError(
                "%s (S3 answered AccessDenied for the member's metadata: "
                "either absent under a GetObject-only principal, or an "
                "existing member this principal is denied — check the "
                "bucket policy)" % name)
        raise KeyError(name)

    def keys(self):
        if is_remote(self.path):
            if self.path.startswith("s3://"):
                # ONE delimited ListObjectsV2 returns the direct children
                # as CommonPrefixes (~1 page for any zarr group), then 1-2
                # small probe GETs per child decide membership.  An
                # undelimited recursive listing would instead enumerate
                # EVERY chunk object under the group — for a pyramid store
                # that is 10^5+ keys = hundreds of sequential 1000-key
                # pages over a congested link, vs a handful of children
                # here.
                from ..data.remote import s3_list
                _, commons = s3_list(self.path, delimiter="/")
                # prefixes are bucket-absolute; strip this group's prefix
                _, _, prefix = self.path[len("s3://"):].partition("/")
                if prefix and not prefix.endswith("/"):
                    prefix += "/"
                members = []
                for cp in sorted(commons):
                    child = cp[len(prefix):].strip("/")
                    if not child:
                        continue
                    p = _join(self.path, child)
                    if (_read_bytes(_join(p, ".zarray"),
                                    missing_403_ok=True) is not None
                            or _read_bytes(_join(p, ".zgroup"),
                                           missing_403_ok=True)
                            is not None):
                        members.append(child)
                yield from members
                return
            raise NotImplementedError(
                "plain-HTTP zarr groups cannot be listed; address members "
                "by name (e.g. group['0/0']) or use an s3:// URL")
        if not os.path.isdir(self.path):
            return
        for name in sorted(os.listdir(self.path)):
            p = os.path.join(self.path, name)
            if (os.path.exists(os.path.join(p, ".zarray"))
                    or os.path.exists(os.path.join(p, ".zgroup"))):
                yield name

    def arrays(self, recursive: bool = False):
        for name in self.keys():
            node = self[name]
            if isinstance(node, Array):
                yield name, node
            elif recursive:
                for sub, arr in node.arrays(recursive=True):
                    yield f"{name}/{sub}", arr

    def __repr__(self):
        return f"Group(path={self.path!r})"


def open(path: str, mode: str = "r", device=None):
    """Open a zarr array or group at ``path`` (creates a group for 'a'/'w'),
    whose codecs build on ``device`` (``None``: the card).

    Remote (s3:// / http(s)://) paths open read-only; writes raise."""
    # Both reads are membership PROBES (array-or-group discrimination), so
    # the ambiguous credentialed AccessDenied — GetObject-only principals
    # see 403 for ABSENT keys — maps to "not this kind" and we try the
    # other; if neither resolves, say which probes were denied instead of
    # aborting on the first 403 (a group root under such a principal has a
    # readable .zgroup but a denied .zarray probe).
    raw, denied_a = _read_bytes_denied(_join(path, ".zarray"),
                                       missing_403_ok=True)
    if raw is not None:
        return Array(path, json.loads(raw), device=device)
    raw2, denied_g = _read_bytes_denied(_join(path, ".zgroup"),
                                        missing_403_ok=True)
    if raw2 is not None:
        return Group(path, device=device)
    if mode in ("a", "w"):
        return Group.create(path, overwrite=(mode == "w"), device=device)
    if denied_a or denied_g:
        raise FileNotFoundError(
            f"No zarr array or group at {path} (S3 answered AccessDenied "
            "for the metadata probes: either absent under a GetObject-only "
            "principal, or existing but denied — check the bucket policy)")
    raise FileNotFoundError(f"No zarr array or group at {path}")
