"""The port's zarr-v2 store against the JAX package's: a store written by
either package opens in the other with equal metadata JSON, chunk keys and
arrays (None, zlib, blosc, cae, cae_tpu); the slice fuzz of
``tests/test_zarr_fuzz.py`` and the group, attribute and ``nbytes_stored``
cases of ``tests/test_storage.py``; the device keyword reaches only the
codecs that take one and never the stored metadata."""

import json
import os

import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.storage import zarr as jzarr
from cnn_autoencoder_tpu.storage.codecs import Blosc as JBlosc
from cnn_autoencoder_tpu.storage.codecs import Zlib as JZlib
from cnn_autoencoder_tpu_torch.storage import zarr as tzarr
from cnn_autoencoder_tpu_torch.storage.codecs import Blosc, Zlib, get_codec

from tests.test_torch_turbo import (  # noqa: F401 (a fixture)
    _assert_u8_close, _image, small_checkpoint)

PACKAGES = {"jax": jzarr, "port": tzarr}


def _open(pkg, path):
    if pkg == "port":
        return tzarr.open(path, mode="r", device="cpu")
    return jzarr.open(path, mode="r")


def _compressor(pkg, name, checkpoint):
    if name == "none":
        return None
    if name == "zlib":
        return (JZlib if pkg == "jax" else Zlib)(1)
    if name == "blosc":
        return (JBlosc if pkg == "jax" else Blosc)(cname="zlib", clevel=5)
    if name == "cae":
        return {"id": "cae", "checkpoint": checkpoint, "offset": 0}
    return {"id": "cae_tpu", "checkpoint": checkpoint, "num_streams": 64}


def _write(pkg, path, name, checkpoint, img):
    kw = {"device": "cpu"} if pkg == "port" else {}
    root = PACKAGES[pkg].Group.create(path, **kw)
    root.attrs["origin"] = pkg
    arr = root.create_dataset(
        "0/0", shape=img.shape, chunks=(16, 16, 3), dtype=np.uint8,
        compressor=_compressor(pkg, name, checkpoint), overwrite=True)
    arr[...] = img
    arr.attrs.update({"scale": [1.0, 0.5]})
    return arr


def _files(path):
    out = {}
    for root, _, files in os.walk(path):
        for fn in files:
            full = os.path.join(root, fn)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


@pytest.mark.parametrize("name", ["none", "zlib", "blosc", "cae", "cae_tpu"])
def test_stores_cross_packages(tmp_path, small_checkpoint, name):
    img = _image(40, 36, seed=1)
    paths = {pkg: str(tmp_path / f"{pkg}.zarr") for pkg in PACKAGES}
    for pkg in PACKAGES:
        _write(pkg, paths[pkg], name, small_checkpoint, img)
    # the same files, byte for byte: metadata JSON, attributes and chunks
    files = {pkg: _files(paths[pkg]) for pkg in PACKAGES}
    assert sorted(files["port"]) == sorted(files["jax"])
    for key in files["jax"]:
        if key.endswith(".zattrs") and key.count(os.sep) == 0:
            continue  # the group's "origin" attribute differs on purpose
        assert files["port"][key] == files["jax"][key], key
    meta = json.loads(files["port"][os.path.join("0", "0", ".zarray")])
    assert "device" not in json.dumps(meta)

    # each package reads the other's store
    for reader, writer in (("port", "jax"), ("jax", "port")):
        root = _open(reader, paths[writer])
        assert root.attrs["origin"] == writer
        arr = root["0/0"]
        assert arr.shape == img.shape and arr.chunks == (16, 16, 3)
        assert arr.attrs["scale"] == [1.0, 0.5]
        assert sorted(arr.chunk_ids()) == sorted(
            _open(writer, paths[writer])["0/0"].chunk_ids())
        got = arr[...]
        if name in ("cae", "cae_tpu"):
            _assert_u8_close(got, _open(writer, paths[writer])["0/0"][...])
        else:
            np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_read_write_slices(tmp_path, seed):
    """``tests/test_zarr_fuzz.py``'s random slices on the port's store; the
    JAX store then reads the result, and the two stores' files agree."""
    rng = np.random.RandomState(seed)
    ndim = rng.randint(1, 4)
    shape = tuple(rng.randint(1, 40) for _ in range(ndim))
    chunks = tuple(rng.randint(1, s + 1) for s in shape)
    dtype = rng.choice([np.uint8, np.int16, np.float32])
    zlib = rng.rand() < 0.5

    ref = np.zeros(shape, dtype)
    arrs = [pkg.Array.create(str(tmp_path / f"{name}{seed}.zarr"),
                             shape=shape, chunks=chunks, dtype=dtype,
                             compressor=codec(1) if zlib else None)
            for name, pkg, codec in (("t", tzarr, Zlib), ("j", jzarr, JZlib))]
    for arr in arrs:
        arr[...] = ref

    for _ in range(12):
        sl = tuple(slice(rng.randint(0, s), rng.randint(1, s + 1) or 1)
                   for s in shape)
        sl = tuple(slice(min(a.start, a.stop - 1) if a.stop > 0 else 0,
                         max(a.stop, a.start + 1)) for a in sl)
        if rng.rand() < 0.5:
            val = rng.randint(0, 100, tuple(max(0, s.stop - s.start)
                                            for s in sl)).astype(dtype)
            if val.size == 0:
                continue
            ref[sl] = val
            for arr in arrs:
                arr[sl] = val
        else:
            np.testing.assert_array_equal(arrs[0][sl], ref[sl])

    np.testing.assert_array_equal(arrs[0][...], ref)
    np.testing.assert_array_equal(jzarr.Array.open(arrs[0].path)[...], ref)
    assert _files(arrs[0].path) == _files(arrs[1].path)


def test_int_indexing_consistency(tmp_path):
    rng = np.random.RandomState(0)
    data = rng.randint(0, 255, (9, 13, 3), np.uint8)
    arr = tzarr.Array.create(str(tmp_path / "i.zarr"), shape=data.shape,
                             chunks=(4, 5, 2), dtype=np.uint8,
                             compressor=Zlib(1))
    arr[...] = data
    np.testing.assert_array_equal(arr[3], data[3])
    np.testing.assert_array_equal(arr[3, 2:7], data[3, 2:7])
    np.testing.assert_array_equal(arr[..., 1], data[..., 1])
    np.testing.assert_array_equal(arr[2:5, ..., 0], data[2:5, ..., 0])


def test_ragged_edges_fill_and_nbytes_stored(tmp_path):
    arr = tzarr.Array.create(str(tmp_path / "b.zarr"), shape=(10, 7, 3),
                             chunks=(4, 4, 3), dtype=np.float32,
                             compressor=None, fill_value=-1)
    arr[0:4, 0:4, :] = np.ones((4, 4, 3), np.float32)
    out = arr[...]
    np.testing.assert_array_equal(out[:4, :4], 1.0)
    np.testing.assert_array_equal(out[4:, 4:], -1.0)
    assert out.shape == (10, 7, 3)
    jarr = jzarr.Array.open(arr.path)
    np.testing.assert_array_equal(jarr[...], out)
    assert arr.nbytes_stored == jarr.nbytes_stored == sum(
        len(b) for b in _files(arr.path).values())
    assert arr.nbytes == jarr.nbytes == 10 * 7 * 3 * 4


def test_group_tree_and_attrs(tmp_path):
    g = tzarr.Group.create(str(tmp_path / "g.zarr"))
    g.attrs["hello"] = "world"
    sub = g.create_group("0")
    a = sub.create_dataset("0", shape=(4, 4), chunks=(2, 2), dtype=np.uint8,
                           compressor=None)
    a[...] = np.eye(4, dtype=np.uint8)
    a.attrs.update({"scale": 1.25})

    for pkg in (tzarr, jzarr):
        g2 = pkg.open(str(tmp_path / "g.zarr"))
        assert g2.attrs["hello"] == "world"
        assert "0" in g2 and "1" not in g2
        assert list(g2.keys()) == ["0"]
        arr = g2["0"]["0"]
        np.testing.assert_array_equal(arr[...], np.eye(4, dtype=np.uint8))
        assert dict(arr.attrs)["scale"] == 1.25
        assert [name for name, _ in g2.arrays(recursive=True)] == ["0/0"]
        with pytest.raises(KeyError):
            g2["missing"]
    with pytest.raises(FileNotFoundError):
        tzarr.open(str(tmp_path / "nothing"), mode="r")
    assert isinstance(tzarr.open(str(tmp_path / "new"), mode="a"),
                      tzarr.Group)


def test_device_reaches_only_device_codecs(tmp_path, small_checkpoint,
                                           monkeypatch):
    """``device`` goes to 'cae' / 'cae_tpu' codecs only: general codecs take
    none, and a store of them opens with any device; without a card the
    default device (the card) raises where a CAE codec is built, and
    ``device="cpu"`` builds it on the CPU."""
    for cfg in ({"id": "zlib", "level": 1},
                {"id": "blosc", "cname": "zlib", "clevel": 5, "shuffle": 1,
                 "blocksize": 0},
                {"id": "lzma", "preset": 1},
                {"id": "imagecodecs_jpeg", "level": 90}):
        assert get_codec(cfg, device="cuda").get_config()["id"] == cfg["id"]

    img = _image(32, 32, seed=2)
    _write("port", str(tmp_path / "z.zarr"), "zlib", None, img)
    _write("jax", str(tmp_path / "c.zarr"), "cae_tpu", small_checkpoint, img)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.testing.assert_array_equal(
        tzarr.open(str(tmp_path / "z.zarr"))["0/0"][...], img)
    arr = tzarr.open(str(tmp_path / "c.zarr"))["0/0"]
    assert arr.read_chunk_raw((0, 0, 0))  # raw chunk reads need no model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arr[...]
    cpu = tzarr.open(str(tmp_path / "c.zarr"), device="cpu")["0/0"]
    assert cpu.compressor.core.device.type == "cpu"
    assert cpu[...].shape == img.shape
