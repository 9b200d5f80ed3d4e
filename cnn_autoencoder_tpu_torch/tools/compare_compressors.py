"""Benchmark lossless chunk compressors on a stored bottleneck array: the
port of the JAX package's ``scripts/compare_compressors.py``.

    python -m cnn_autoencoder_tpu_torch.tools.compare_compressors \
        latent.zarr [chunk_size [clevel]]

Re-compresses an existing latent array (a group's ``0/0`` or a bare array)
with Blosc, Zlib, BZ2, GZip and LZMA (``storage/codecs.py``) and reports
stored bytes, bpp and wall time; the stored bytes equal the JAX tool's.
The trial stores go under ``tmp_dir`` (the system's temporary directory by
default) and are removed.
"""

import os
import shutil
import sys
import tempfile
from time import perf_counter

from ..storage import zarr as zarrlib
from ..storage.codecs import BZ2, Blosc, GZip, LZMACodec, Zlib

COMPRESSORS = {
    "Blosc": lambda clevel: Blosc(cname="blosclz", clevel=clevel, shuffle=1),
    "Zlib": lambda clevel: Zlib(level=clevel),
    "BZ2": lambda clevel: BZ2(level=clevel),
    "GZip": lambda clevel: GZip(level=clevel),
    "LZMA": lambda clevel: LZMACodec(preset=min(clevel, 9)),
}


def test_compressor(src: zarrlib.Array, comp_name: str, comp_level: int = 5,
                    chunk_size: int = 1024, tmp_dir=None):
    h, w = src.shape[:2]
    compressor = COMPRESSORS[comp_name](comp_level)
    data = src[...]

    out_path = os.path.join(tmp_dir or tempfile.gettempdir(),
                            f"_cmp_{comp_name}.zarr")
    e_time = perf_counter()
    arr = zarrlib.Array.create(
        out_path, shape=data.shape,
        chunks=(min(chunk_size, h), min(chunk_size, w)) + data.shape[2:],
        dtype=data.dtype, compressor=compressor, overwrite=True)
    arr[...] = data
    e_time = perf_counter() - e_time

    stored = arr.nbytes_stored
    bpp = stored * 8 / (h * w)
    print("Array shape %s (%d bytes) compressed into %d bytes using %s "
          "(level %d). BPP=%0.4f. Time=%0.3fs"
          % (data.shape, data.nbytes, stored, comp_name, comp_level, bpp,
             e_time))
    shutil.rmtree(out_path, ignore_errors=True)
    return stored, e_time


def main(argv=None, tmp_dir=None):
    """Every compressor on the array; returns {name: stored bytes}."""
    argv = sys.argv[1:] if argv is None else argv
    z_fn = argv[0]
    z_chunk = int(argv[1]) if len(argv) > 1 else 1024
    z_clevel = int(argv[2]) if len(argv) > 2 else 5

    node = zarrlib.open(z_fn, mode="r")
    src = node["0/0"] if isinstance(node, zarrlib.Group) else node

    print("Test compressors for zarr files")
    return {comp_name: test_compressor(src, comp_name, z_clevel, z_chunk,
                                       tmp_dir)[0]
            for comp_name in COMPRESSORS}


if __name__ == "__main__":
    main()
