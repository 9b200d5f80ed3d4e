"""The port's tile pipeline (``pipeline/tiles.py``, plain versions on the
CPU) against the JAX package's on the same seeded images: 'cae' (with and
without the offset halo) and 'cae_tpu' chunks byte-identical, each
package's store decoding in the other, the overlapped round trip equal to
the sequential pair, batch sizes 1 and 3 writing the same bytes, the
sidecar copy, and 'cae_bn' with a latent halo."""

import os

import numpy as np
import pytest

from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.pipeline import tiles as jtiles
from cnn_autoencoder_tpu.storage import zarr as jzarr
from cnn_autoencoder_tpu.storage.cae_codec import CAECodecCore as JCore
from cnn_autoencoder_tpu.storage.turbo_codec import CAETurboCore as JTurbo
from cnn_autoencoder_tpu.utils.profiling import GLOBAL_TIMER as JTIMER
from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.pipeline import tiles as ttiles
from cnn_autoencoder_tpu_torch.storage import zarr as tzarr
from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
from cnn_autoencoder_tpu_torch.utils.profiling import GLOBAL_TIMER as TIMER

from tests.test_torch_turbo import (  # noqa: F401 (a fixture)
    FLAGSHIP, _assert_u8_close, _image, small_checkpoint)

CAE_STAGES = {"compress/read", "compress/h2d+dispatch", "compress/d2h_sym",
              "compress/rans", "compress/write", "decompress/rans",
              "decompress/h2d+dispatch", "decompress/fetch_total",
              "decompress/d2h_pixels", "decompress/stitch"}

# (model, image h, w, patch): the flagship at 64^2 patches, the small
# model at 32^2; both grids have ragged right and bottom tiles
CASES = {"small": (96, 80, 32), "flagship": (96, 80, 64)}


@pytest.fixture(scope="module")
def cores(small_checkpoint):
    """{name: (JAX 'cae' core, JAX turbo core, port 'cae' core, port turbo
    core)}, the turbo cores at the default 1024 streams."""
    out = {}
    for name, path in (("flagship", FLAGSHIP), ("small", small_checkpoint)):
        jm = jax_from_state_dict(path)
        tm = autoencoder_from_state_dict(path, device="cpu")
        out[name] = (JCore(jm), JTurbo(jm), CAECodecCore(tm, device="cpu"),
                     CAETurboCore(tm, device="cpu"))
    return out


def _chunks(arr):
    return {ij: arr.read_chunk_raw(ij) for ij in arr.chunk_ids()}


def _meta(path, group="0/0"):
    with open(os.path.join(path, group, ".zarray"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", ["small", "flagship"])
def test_turbo_pipeline_matches_jax(cores, tmp_path, name):
    """'cae_tpu' chunks and metadata byte-identical to the JAX pipeline's
    at batches of 3, and at batches of 1 in the port; each package's store
    decodes in the other."""
    _, jturbo, _, tturbo = cores[name]
    h, w, p = CASES[name]
    img = _image(h, w, seed=3)
    paths = {k: str(tmp_path / f"{k}.zarr") for k in ("jax", "port", "b1")}
    jarr = jtiles.compress_pixels_to_cae_turbo(
        jturbo, img, paths["jax"], patch_size=p, batch_tiles=3,
        checkpoint_id="m.msgpack")
    tarr = ttiles.compress_pixels_to_cae_turbo(
        tturbo, img, paths["port"], patch_size=p, batch_tiles=3,
        checkpoint_id="m.msgpack")
    b1 = ttiles.compress_pixels_to_cae_turbo(
        tturbo, img, paths["b1"], patch_size=p, batch_tiles=1,
        checkpoint_id="m.msgpack")
    assert _meta(paths["port"]) == _meta(paths["jax"])
    assert _chunks(tarr) == _chunks(jarr) == _chunks(b1)
    assert len(_chunks(tarr)) == (-(-h // p)) * (-(-w // p))

    rec_t = ttiles.decompress_cae_turbo_array(
        tzarr.open(paths["jax"], device="cpu")["0/0"], batch_tiles=3,
        core=tturbo)
    rec_j = jtiles.decompress_cae_turbo_array(
        jzarr.open(paths["port"])["0/0"], batch_tiles=3, core=jturbo)
    assert rec_t.shape == img.shape and rec_t.dtype == np.uint8
    _assert_u8_close(rec_t, rec_j)
    np.testing.assert_array_equal(
        ttiles.decompress_cae_turbo_array(tarr, batch_tiles=1, core=tturbo),
        rec_t)


def test_roundtrip_matches_sequential(cores, tmp_path):
    """``roundtrip_cae_turbo``: the stored bytes and the reconstruction of
    compress then decompress (``tests/test_roundtrip_pipelined.py:52``)."""
    tturbo = cores["small"][3]
    img = _image(70, 100, seed=4)
    arr_seq = ttiles.compress_pixels_to_cae_turbo(
        tturbo, img, str(tmp_path / "seq.zarr"), patch_size=32)
    rec_seq = ttiles.decompress_cae_turbo_array(arr_seq, core=tturbo)
    arr_rt, rec_rt = ttiles.roundtrip_cae_turbo(
        tturbo, img, str(tmp_path / "rt.zarr"), patch_size=32)
    assert _chunks(arr_rt) == _chunks(arr_seq)
    np.testing.assert_array_equal(rec_rt, rec_seq)
    assert rec_rt.shape == img.shape
    assert _meta(str(tmp_path / "rt.zarr")) == _meta(str(tmp_path /
                                                         "seq.zarr"))


@pytest.mark.parametrize("name,halo", [("small", False), ("small", True),
                                       ("flagship", False)])
def test_cae_pipeline_matches_jax(cores, tmp_path, name, halo):
    """'cae' chunks byte-identical to the JAX pipeline's, with ``offset``
    0 or one decoder receptive field (2**level); cross-package decodes
    agree, and the store's own codec decodes what the pipeline does."""
    jcore, _, tcore, _ = cores[name]
    h, w, p = CASES[name]
    img = _image(h, w, seed=6)
    offset = 2 ** tcore.level if halo else 0
    for timer in (TIMER, JTIMER):
        timer.reset()
    jarr = jtiles.compress_pixels_to_cae(
        jcore, img, str(tmp_path / "j.zarr"), patch_size=p, batch_tiles=3,
        checkpoint_id=FLAGSHIP if name == "flagship" else None,
        offset=offset)
    tarr = ttiles.compress_pixels_to_cae(
        tcore, img, str(tmp_path / "t.zarr"), patch_size=p, batch_tiles=3,
        checkpoint_id=FLAGSHIP if name == "flagship" else None,
        offset=offset)
    assert tarr._meta == jarr._meta
    assert tarr._meta["compressor"]["offset"] == offset
    assert _meta(str(tmp_path / "t.zarr")) == _meta(str(tmp_path / "j.zarr"))
    assert _chunks(tarr) == _chunks(jarr)

    rec_t = ttiles.decompress_cae_array(
        tzarr.open(str(tmp_path / "j.zarr"), device="cpu")["0/0"],
        batch_tiles=3, core=tcore)
    rec_j = jtiles.decompress_cae_array(jarr, batch_tiles=3, core=jcore)
    assert rec_t.shape == img.shape
    _assert_u8_close(rec_t, rec_j)
    # the JAX pipeline's stage names, one entry a batch each way
    n = -(-len(_chunks(tarr)) // 3)
    stages = TIMER.totals()
    assert set(stages) == CAE_STAGES and set(stages) <= set(JTIMER.totals())
    assert all(TIMER._count[k] == n for k in stages)
    pe = p + 2 * offset
    # the tiles up, then the decoded symbols up (as narrow as JAX's)
    h2d = TIMER.link_bytes()["h2d"]
    assert h2d > n * 3 * pe * pe * 3
    assert h2d == JTIMER.link_bytes()["h2d"]
    assert "compress/rans" in TIMER.report()
    if name == "flagship":
        # the store names its checkpoint: a fresh reader builds the codec
        fresh = tzarr.open(str(tmp_path / "t.zarr"), device="cpu")["0/0"]
        np.testing.assert_array_equal(ttiles.decompress_cae_array(fresh),
                                      rec_t)


def test_bottleneck_with_latent_halo(cores, tmp_path):
    """'cae_bn' latents: the stores agree with the JAX pipeline's in shape,
    metadata and true pixel size, and quantize to the same symbols up to
    float32 roundings; decoding one store with a latent halo of 2 agrees
    across the packages within the u8 tolerance, and both crop to the
    true size."""
    jcore, _, tcore, _ = cores["small"]
    img = _image(72, 88, seed=8)
    jarr = jtiles.compress_pixels_to_bottleneck(
        jcore, img, str(tmp_path / "j.zarr"), patch_size=32, batch_tiles=3)
    tarr = ttiles.compress_pixels_to_bottleneck(
        tcore, img, str(tmp_path / "t.zarr"), patch_size=32, batch_tiles=3)
    assert tarr._meta == jarr._meta
    assert tarr.attrs["true_pixel_shape"] == [72, 88]
    assert tarr.shape == (18, 22, 16) and tarr.chunks == (8, 8, 16)
    y_t, y_j = tarr[...], jzarr.open(str(tmp_path / "j.zarr"))["0/0"][...]
    assert np.mean(y_t != y_j) < 1e-3

    out = {}
    for pkg, tiles, core, zarrlib in (("t", ttiles, tcore, tzarr),
                                      ("j", jtiles, jcore, jzarr)):
        src = jzarr.open(str(tmp_path / "j.zarr"))["0/0"] if pkg == "j" \
            else tzarr.open(str(tmp_path / "j.zarr"), device="cpu")["0/0"]
        res = tiles.decompress_latents_to_pixels(
            core, src, str(tmp_path / f"rec_{pkg}.zarr"), "rec/0",
            batch_tiles=3, halo=2)
        out[pkg] = res[...]
        assert res.shape == (72, 88, 3)
    _assert_u8_close(out["t"], out["j"])

    with pytest.raises(ValueError, match="multiscale"):
        ttiles.decompress_latents_to_pixels(
            tcore, tarr, str(tmp_path / "never.zarr"), "rec/0", rec_level=1)
    assert not os.path.exists(str(tmp_path / "never.zarr"))


def test_copy_sidecar_metadata(tmp_path):
    """Labels and masks groups and the OME folder are copied beside the
    output, as the JAX function copies them; existing ones stay."""
    src = str(tmp_path / "src.zarr")
    g = tzarr.Group.create(src)
    for name in ("labels", "masks", "other"):
        a = g.create_dataset(f"{name}/0", shape=(4, 4), chunks=(2, 2),
                             dtype=np.uint8, compressor=None)
        a[...] = np.arange(16, dtype=np.uint8).reshape(4, 4)
    os.makedirs(os.path.join(src, "OME"))
    with open(os.path.join(src, "OME", "METADATA.ome.xml"), "w") as f:
        f.write("<OME/>")
    dsts = {}
    for pkg, tiles in (("t", ttiles), ("j", jtiles)):
        dst = str(tmp_path / f"dst_{pkg}.zarr")
        tzarr.Group.create(dst)
        tiles.copy_sidecar_metadata(src, dst)
        dsts[pkg] = dst
    got = tzarr.open(dsts["t"])
    assert sorted(got.keys()) == ["labels", "masks"]
    np.testing.assert_array_equal(got["labels/0"][...],
                                  np.arange(16).reshape(4, 4))
    with open(os.path.join(dsts["t"], "OME", "METADATA.ome.xml")) as f:
        assert f.read() == "<OME/>"
    listing = {pkg: sorted(os.path.relpath(os.path.join(r, fn), d)
                           for r, _, fs in os.walk(d) for fn in fs)
               for pkg, d in dsts.items()}
    assert listing["t"] == listing["j"]
    ttiles.copy_sidecar_metadata(str(tmp_path / "absent.zarr"), dsts["t"])
    ttiles.copy_sidecar_metadata(src, dsts["t"])  # already there: kept


def test_helpers_match_jax(monkeypatch):
    for args in ((512, None, 64), (512, None, 5), (32, None, None),
                 (64, None, 1000), (2048, None, 3)):
        assert ttiles.default_batch_tiles(*args) == \
            jtiles.default_batch_tiles(*args)
    monkeypatch.setenv("CAE_TPU_BATCH_TILES", "5")
    assert ttiles.default_batch_tiles(512, None, 64) == 5
    rng = np.random.RandomState(0)
    for shape, axes, roi in (((6, 5), "YX", None),
                             ((2, 3, 1, 6, 5), "TCZYX", None),
                             ((5, 6, 3), "XYC", None),
                             ((6, 5, 3), "TCZYX", None),
                             ((1, 3, 6, 5), "CZYX",
                              (slice(None), slice(None), slice(1, 4),
                               slice(0, 2)))):
        z = rng.randint(0, 255, shape).astype(np.uint8)
        np.testing.assert_array_equal(
            ttiles.normalize_to_yxc(z, axes, roi),
            jtiles.normalize_to_yxc(z, axes, roi))
