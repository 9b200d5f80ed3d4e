"""The port's host-format CAE codecs ('cae', 'cae_bn' and ``CAECodecCore``,
plain versions on the CPU) against the JAX package's: equal symbols,
byte-identical frames, decode across the two packages both ways, u8
reconstructions within the ``test_rd_parity`` tolerance (< 0.5 % of values
differ, by at most 1), the int8 fetch and its overflow path, the upload
type, the codec ABI, and garbage frames."""

import base64
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.storage import cae_codec as jcodec
from cnn_autoencoder_tpu.storage.codecs import get_codec as jax_get_codec
from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.storage import cae_codec as tcodec
from cnn_autoencoder_tpu_torch.storage.codecs import get_codec
from cnn_autoencoder_tpu_torch.training.checkpoint import (load_checkpoint,
                                                           msgpack_restore)
from cnn_autoencoder_tpu_torch.utils import staging
from cnn_autoencoder_tpu_torch.utils.profiling import GLOBAL_TIMER
from chip_smoke import scaled_checkpoint
from tests.test_torch_turbo import (  # noqa: F401 (a fixture)
    _assert_u8_close, small_checkpoint)

FLAGSHIP = "benchmarks/bench_flagship.msgpack"


@pytest.fixture(scope="module")
def cores(small_checkpoint):
    """{name: (JAX core, port core)}."""
    return {name: (jcodec.CAECodecCore(jax_from_state_dict(path)),
                   tcodec.CAECodecCore(autoencoder_from_state_dict(
                       path, device="cpu"), device="cpu"))
            for name, path in (("flagship", FLAGSHIP),
                               ("small", small_checkpoint))}


def _image(h, w, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    img = (np.sin(yy / 9.0 + seed) + np.cos(xx / 11.0))[:, :, None] * 55 + 128
    img = img + np.random.RandomState(seed).randn(h, w, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def test_tables_equal(cores):
    for jcore, tcore in cores.values():
        for key in ("cdf", "cdf_length", "offset", "medians"):
            np.testing.assert_array_equal(getattr(tcore, key),
                                          getattr(jcore, key))


@pytest.mark.parametrize("name,h,w,batch", [("flagship", 64, 64, 1),
                                            ("small", 64, 64, 2),
                                            ("small", 50, 38, 2),
                                            ("flagship", 40, 72, 2)])
def test_round_trip_matches_jax(cores, name, h, w, batch):
    """Symbols, frames and decode both ways; odd sizes reflect-pad."""
    jcore, tcore = cores[name]
    tiles = np.stack([_image(h, w, seed) for seed in range(batch)])
    sym_j = jcore.fetch_symbols(jcore.encode_tiles_device(jnp.asarray(tiles)))
    sym_t = tcore.fetch_symbols(tcore.encode_tiles_device(tiles))
    assert sym_t.dtype == sym_j.dtype == np.int8
    np.testing.assert_array_equal(sym_t, sym_j)

    frames_t = tcore.encode_tiles(tiles)
    assert frames_t == jcore.encode_tiles(tiles)
    assert all(f[:16] == struct.pack(">QQ", h, w) for f in frames_t)
    sym_d, true_hw = tcore.entropy_decode(frames_t)
    np.testing.assert_array_equal(sym_d, sym_t)
    assert true_hw == [(h, w)] * batch

    rec_t = tcore.decode_tiles(frames_t)
    rec_j = jcore.decode_tiles(frames_t)
    assert rec_t.shape == tiles.shape and rec_t.dtype == np.uint8
    _assert_u8_close(rec_t, rec_j)
    np.testing.assert_array_equal(tcore.decode_tiles(frames_t), rec_t)


@pytest.mark.parametrize("name,h,w", [("small", 64, 64), ("small", 50, 38),
                                      ("flagship", 40, 72)])
def test_host_and_tensor_tiles_code_alike(cores, name, h, w, monkeypatch):
    """The 'cae' core: host tiles and the same tiles as a tensor give
    byte-identical frames and the same pixels; the pixels come back through
    ``fetch_pixels`` (its stage and its raw bytes), unstaged on the CPU."""
    def no_staging(device):
        raise AssertionError("staged on the CPU")

    monkeypatch.setattr(staging, "staging", no_staging)
    tcore = cores[name][1]
    tiles = np.stack([_image(h, w, seed) for seed in (2, 3)])
    frames = tcore.encode_tiles(tiles)
    assert tcore.encode_tiles(torch.from_numpy(tiles)) == frames
    GLOBAL_TIMER.reset()
    rec = tcore.decode_tiles(frames)
    assert rec.shape == tiles.shape and rec.dtype == np.uint8
    assert GLOBAL_TIMER._count == {"decompress/d2h_pixels": 1}
    link = GLOBAL_TIMER.link_bytes()
    assert link["d2h"] == rec.nbytes and link["d2h_staged"] == 0
    sym, _ = tcore.entropy_decode(frames)
    np.testing.assert_array_equal(
        rec, tcore.decode_tiles_device(sym)[:, :h, :w].numpy())


def test_int8_fetch_overflow_matches_jax(small_checkpoint):
    """Latents past int8 range come back as int32 (the wide copy), in both
    packages, and their frames (bypass-coded escapes) are byte-identical."""
    state = scaled_checkpoint(100.0, small_checkpoint)
    jcore = jcodec.CAECodecCore(jax_from_state_dict(state))
    tcore = tcodec.CAECodecCore(autoencoder_from_state_dict(
        state, device="cpu"), device="cpu")
    tiles = np.stack([_image(32, 32, 1), _image(32, 32, 2)])
    sym_j = jcore.fetch_symbols(jcore.encode_tiles_device(jnp.asarray(tiles)))
    sym_t = tcore.fetch_symbols(tcore.encode_tiles_device(tiles))
    assert sym_t.dtype == sym_j.dtype == np.int32
    assert np.abs(sym_t).max() > 127
    np.testing.assert_array_equal(sym_t, sym_j)
    frames = tcore.encode_tiles(tiles)
    assert frames == jcore.encode_tiles(tiles)
    np.testing.assert_array_equal(tcore.entropy_decode(frames)[0], sym_t)
    _assert_u8_close(tcore.decode_tiles(frames), jcore.decode_tiles(frames))


@pytest.mark.parametrize("lo,hi,dtype", [(-128, 127, np.int8),
                                         (-129, 5, np.int16),
                                         (0, 32767, np.int16),
                                         (-40000, 0, np.int32)])
def test_upload_type(cores, lo, hi, dtype):
    """Decoded symbols go up in the narrowest lossless type, as the JAX
    codec uploads them, and decode the same from any type."""
    _, tcore = cores["small"]
    sym = np.zeros((1, 16, 2, 2), np.int32)
    sym.flat[0], sym.flat[1] = lo, hi
    assert tcodec.narrowest(sym).dtype == dtype
    np.testing.assert_array_equal(tcodec.narrowest(sym), sym)
    small = np.random.RandomState(0).randint(-3, 4, (1, 16, 2, 2))
    np.testing.assert_array_equal(
        tcore.decode_tiles_device(small.astype(np.int32)).numpy(),
        tcore.decode_tiles_device(small.astype(np.int8)).numpy())


def test_decode_latents_device(cores):
    jcore, tcore = cores["small"]
    y = (np.random.RandomState(1).randn(2, 8, 8, 16) * 2).astype(np.float32)
    rec_t = tcore.decode_latents_device(y).numpy()
    _assert_u8_close(rec_t, np.asarray(jcore.decode_latents_device(y)))
    np.testing.assert_array_equal(
        tcore.decode_latents_device(y, rec_level=tcore.level).numpy(), rec_t)
    with pytest.raises(ValueError, match="multiscale"):
        tcore.decode_latents_device(y, rec_level=1)


def test_garbage_frames_raise(cores):
    """An untrusted header raises ValueError before it sizes anything; a
    garbage or cut payload decodes to symbols of the right shape."""
    _, tcore = cores["small"]
    rng = np.random.RandomState(3)
    for buf in (b"", rng.bytes(8), rng.bytes(256),
                struct.pack(">QQ", 1 << 40, 1 << 40) + rng.bytes(64),
                struct.pack(">QQ", 1 << 16, 1 << 16) + rng.bytes(64),
                struct.pack(">QQ", 0, 32) + rng.bytes(8)):
        with pytest.raises(ValueError):
            tcore.entropy_decode([buf])
    with pytest.raises(ValueError, match="one tile size"):
        tcore.entropy_decode([struct.pack(">QQ", 32, 32),
                              struct.pack(">QQ", 32, 16)])
    frame = tcore.encode_tiles(_image(32, 32, 9)[None])[0]
    cut = frame[:16 + (len(frame) - 16) // 2]
    sym, hw = tcore.entropy_decode([cut, struct.pack(">QQ", 32, 32)
                                    + rng.bytes(40)])
    assert sym.shape == (2, 16, 8, 8) and hw == [(32, 32)] * 2


def test_cae_codec_abi_with_offset(small_checkpoint):
    """The 'cae' codec object with an edge ``offset``: the JAX codec's bytes,
    its config, and configs that open in either package."""
    img = _image(24, 20, seed=4)
    codec = tcodec.ConvolutionalAutoencoder(small_checkpoint, device="cpu",
                                            offset=3)
    jax_codec = jcodec.ConvolutionalAutoencoder(small_checkpoint, offset=3)
    buf = codec.encode(img)
    assert buf == jax_codec.encode(img)
    assert buf[:16] == struct.pack(">QQ", 30, 26)
    rec = codec.decode(buf)
    assert rec.shape == img.shape and rec.dtype == np.uint8
    _assert_u8_close(rec, jax_codec.decode(buf))
    out = np.empty_like(img)
    assert codec.decode(buf, out=out) is out
    np.testing.assert_array_equal(out, rec)

    config = codec.get_config()
    assert config == {"id": "cae", "checkpoint": small_checkpoint,
                      "offset": 3} == jax_codec.get_config()
    again = get_codec(config, device="cpu")
    assert isinstance(again, tcodec.ConvolutionalAutoencoder)
    np.testing.assert_array_equal(again.decode(buf), rec)
    assert isinstance(jax_get_codec(config), jcodec.ConvolutionalAutoencoder)


def test_cae_bn_configs_and_frames_cross(small_checkpoint):
    """'cae_bn' configs written by either package open in the other, and
    frames are byte-identical and decode exactly in both."""
    params = load_checkpoint(small_checkpoint)["fact_ent"]["params"]
    model = autoencoder_from_state_dict(small_checkpoint, device="cpu")
    ours = tcodec.ConvolutionalAutoencoderBottleneck(
        16, fact_ent={"params": model.fact_ent.params()})
    theirs = jcodec.ConvolutionalAutoencoderBottleneck(16, fact_ent=params)
    assert ours.filters == theirs.filters == [3, 3, 3, 3]
    for key in ("cdf", "cdf_length", "offset", "medians"):
        np.testing.assert_array_equal(getattr(ours, key),
                                      getattr(theirs, key))
    # the serialized parameters are the same arrays either way
    got = msgpack_restore(base64.b64decode(ours.fact_ent_checkpoint))
    ref = msgpack_restore(base64.b64decode(theirs.fact_ent_checkpoint))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])

    port_from_jax = get_codec(theirs.get_config())
    jax_from_port = jax_get_codec(ours.get_config())
    y = (np.random.RandomState(2).randn(6, 5, 16) * 3).astype(np.float32)
    y[0, 0, 0], y[1, 2, 3] = 400.0, -250.0          # escapes
    frame = ours.encode(y)
    for codec in (theirs, port_from_jax, jax_from_port):
        assert codec.encode(y) == frame
    want = theirs.decode(frame)
    for codec in (ours, port_from_jax, jax_from_port):
        np.testing.assert_array_equal(codec.decode(frame), want)
    np.testing.assert_array_equal(
        want, np.round(y - ours.medians) + ours.medians)


def test_garbage_cae_bn_frames_raise(small_checkpoint):
    model = autoencoder_from_state_dict(small_checkpoint, device="cpu")
    codec = tcodec.ConvolutionalAutoencoderBottleneck(
        16, fact_ent=model.fact_ent.params())
    rng = np.random.RandomState(7)
    for buf in (b"", rng.bytes(10),
                struct.pack(">QQ", 1 << 40, 1 << 40) + rng.bytes(64),
                struct.pack(">QQ", 5, 0) + rng.bytes(8)):
        with pytest.raises(ValueError):
            codec.decode(buf)
    with pytest.raises(ValueError, match="fact_ent"):
        tcodec.ConvolutionalAutoencoderBottleneck(16)


def test_default_device_without_card_raises(small_checkpoint, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcodec.ConvolutionalAutoencoder(small_checkpoint)
    model = autoencoder_from_state_dict(small_checkpoint, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcodec.CAECodecCore(model)
