"""The port's whole-image fused paths (``pipeline/tiles.py``, plain versions
on the CPU) against the JAX package's ``compress_image_fused`` /
``decompress_image_fused`` on the same image and the same checkpoint (the
model of ``tests/test_fused_pipeline.py``'s fixture, saved by the JAX
package): chunks byte-equal, each package's fused store decoding in the
other, the port's fused result equal to its own pipeline; and ``trace``."""

import os

import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.pipeline import tiles as jtiles
from cnn_autoencoder_tpu.storage import zarr as jzarr
from cnn_autoencoder_tpu.storage.cae_codec import CAECodecCore as JCore
from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.pipeline import tiles as ttiles
from cnn_autoencoder_tpu_torch.storage import zarr as tzarr
from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
from cnn_autoencoder_tpu_torch.utils.profiling import trace

from tests.test_torch_turbo import small_checkpoint  # noqa: F401 (fixture)

H, W, P, CHUNK = 96, 80, 32, 4     # 3 x 3 tiles, ragged right and bottom


@pytest.fixture(scope="module")
def cores(small_checkpoint):
    """(JAX 'cae' core, port 'cae' core on the CPU) of one checkpoint."""
    return (JCore(jax_from_state_dict(small_checkpoint)),
            CAECodecCore(autoencoder_from_state_dict(small_checkpoint,
                                                     device="cpu"),
                         device="cpu"))


@pytest.fixture(scope="module")
def img():
    """``tests/test_fused_pipeline.py``'s image."""
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:H, 0:W]
    return np.clip((np.sin(yy / 9.0) + np.cos(xx / 11.0))[:, :, None]
                   * np.ones((1, 1, 3)) * 55 + 128
                   + rng.randn(H, W, 3) * 4, 0, 255).astype(np.uint8)


def _chunks(arr):
    return {ij: arr.read_chunk_raw(ij) for ij in arr.chunk_ids()}


def test_fused_matches_jax(cores, img, tmp_path):
    """Chunks and metadata byte-equal to the JAX package's fused store; each
    package's fused decode reads the other's store to the same pixels."""
    jcore, tcore = cores
    jpath, tpath = str(tmp_path / "j.zarr"), str(tmp_path / "t.zarr")
    jarr = jtiles.compress_image_fused(jcore, img, jpath, patch_size=P,
                                       chunk=CHUNK, checkpoint_id="m")
    tarr = ttiles.compress_image_fused(tcore, img, tpath, patch_size=P,
                                       chunk=CHUNK, checkpoint_id="m")
    assert len(_chunks(tarr)) == 9
    assert _chunks(tarr) == _chunks(jarr)
    with open(os.path.join(jpath, "0/0/.zarray"), "rb") as f, \
            open(os.path.join(tpath, "0/0/.zarray"), "rb") as g:
        assert f.read() == g.read()

    rec_j = jtiles.decompress_image_fused(
        jzarr.open(tpath, mode="r")["0/0"], core=jcore, chunk=CHUNK)
    rec_t = ttiles.decompress_image_fused(
        tzarr.open(jpath, mode="r", device="cpu")["0/0"], core=tcore,
        chunk=CHUNK)
    assert rec_t.shape == img.shape
    np.testing.assert_array_equal(
        rec_j, jtiles.decompress_image_fused(jarr, core=jcore, chunk=CHUNK))
    diff = np.abs(rec_t.astype(np.int32) - rec_j)
    assert np.mean(diff != 0) < 5e-3 and diff.max() <= 1


@pytest.mark.parametrize("chunk", [CHUNK, 9])
def test_fused_equals_pipeline(cores, img, tmp_path, chunk,
                               small_checkpoint):  # noqa: F811
    """The fused store equals ``compress_pixels_to_cae``'s byte for byte,
    and the fused decode ``decompress_cae_array``'s bit for bit, with a
    padded last chunk and with one chunk of the whole image."""
    _, tcore = cores
    fused = ttiles.compress_image_fused(tcore, img, str(tmp_path / "f.zarr"),
                                        patch_size=P, chunk=chunk,
                                        checkpoint_id=small_checkpoint)
    piped = ttiles.compress_pixels_to_cae(tcore, img,
                                          str(tmp_path / "p.zarr"),
                                          patch_size=P, batch_tiles=chunk,
                                          checkpoint_id=small_checkpoint)
    assert _chunks(fused) == _chunks(piped)
    rec = ttiles.decompress_image_fused(fused, core=tcore, chunk=chunk)
    np.testing.assert_array_equal(
        rec, ttiles.decompress_cae_array(piped, core=tcore,
                                         batch_tiles=chunk))
    # the store's own codec (built on the store's device) decodes it too
    fresh = tzarr.open(str(tmp_path / "f.zarr"), mode="r",
                       device="cpu")["0/0"]
    np.testing.assert_array_equal(ttiles.decompress_image_fused(fresh), rec)


def test_fused_decode_refuses_an_offset(cores, img, tmp_path):
    _, tcore = cores
    arr = ttiles.compress_pixels_to_cae(tcore, img, str(tmp_path / "o.zarr"),
                                        patch_size=P, offset=4)
    with pytest.raises(ValueError, match="offset 0"):
        ttiles.decompress_image_fused(arr, core=tcore)


def test_trace_writes_a_file(tmp_path, monkeypatch):
    """``trace(dir)`` writes one trace file that names the traced
    operations; ``CAE_TPU_TRACE`` does the same; without a directory the
    block runs and nothing is written."""
    monkeypatch.delenv("CAE_TPU_TRACE", raising=False)
    with trace():
        torch.ones(8).sum()
    d = tmp_path / "arg"
    with trace(str(d)):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert "aten::matmul" in (d / files[0]).read_text()

    e = tmp_path / "env"
    monkeypatch.setenv("CAE_TPU_TRACE", str(e))
    with trace():
        torch.ones(8).sum()
    assert len(os.listdir(e)) == 1
