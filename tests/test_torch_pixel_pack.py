"""The port's bit-plane packer (``coding/pixel_pack.py``) against the JAX
package's on the same seeded tiles: words, widths and used counts equal to
JAX's ``pack_pixels_device``, the C++ unpack and its numpy version giving
the tiles back, the head length, the under-sized fetch refused, and the
codec's packed fetch (both of its copy branches) equal to a raw fetch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.coding import pixel_pack as jpack
from cnn_autoencoder_tpu_torch.coding.pixel_pack import (
    _unpack_numpy, head_words, pack_pixels_device,
    pack_pixels_device_with_head, unpack_pixels_host)
from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore

from tests.test_torch_turbo import FLAGSHIP


def _tiles(kind, b=2, p=32, c=3, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "noise":
        return rng.randint(0, 256, (b, p, p, c)).astype(np.uint8)
    if kind == "checker":   # saturated: mod-256 wraparound
        t = np.zeros((b, p, p, c), np.uint8)
        t[:, ::2, ::2] = 255
        t[:, 1::2, 1::2] = 255
        return t
    yy, xx = np.mgrid[0:p, 0:p]
    base = np.sin(yy / 17.0) * 60 + np.cos(xx / 23.0) * 50 + 128
    noise = {"smooth": 0.0, "grain": 3.0}[kind]
    return np.clip(base[None, :, :, None] + rng.randn(b, p, p, c) * noise,
                   0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind,shape", [("smooth", (3, 32, 32, 3)),
                                        ("grain", (2, 64, 64, 3)),
                                        ("noise", (2, 32, 32, 3)),
                                        ("checker", (1, 32, 32, 3)),
                                        ("grain", (2, 16, 24, 1))])
def test_pack_equals_jax_and_unpacks(kind, shape):
    tiles = _tiles(kind, *shape[:2], c=shape[3])[:, :, :shape[2]]
    tiles = np.ascontiguousarray(tiles)
    words, widths, total = pack_pixels_device(torch.from_numpy(tiles))
    jw, jwidths, jtotal = jpack.pack_pixels_device(jnp.asarray(tiles))
    assert words.dtype == torch.int32 and widths.dtype == torch.uint8
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(jw))
    np.testing.assert_array_equal(widths.numpy(), np.asarray(jwidths))
    assert int(total) == int(jtotal)
    used = words.numpy()[:int(total)]
    np.testing.assert_array_equal(
        unpack_pixels_host(used, widths.numpy(), tiles.shape), tiles)
    np.testing.assert_array_equal(
        _unpack_numpy(used, widths.numpy(), tiles.shape), tiles)
    # never much past raw size (uniform noise is the worst case)
    assert int(total) * 4 <= tiles.size * 1.01


def test_head_words_as_jax():
    for nb in (1, 96, 1000, 98304):
        assert head_words(nb) == jpack.head_words(nb)


def test_truncated_words_detected():
    """An under-sized fetch is reported, not zero-filled."""
    tiles = _tiles("grain", 1, 64)
    words, widths, total = pack_pixels_device(torch.from_numpy(tiles))
    with pytest.raises(ValueError, match="truncated"):
        unpack_pixels_host(words.numpy()[:int(total) // 4], widths.numpy(),
                           tiles.shape)


def test_tiles_not_whole_blocks_refused():
    with pytest.raises(ValueError, match="multiple of 128"):
        pack_pixels_device(torch.zeros((1, 5, 5, 3), dtype=torch.uint8))


def test_packed_fetch_equals_raw_fetch():
    """``decode_packed`` then ``fetch_pixels`` (the head holds every used
    word, one copy): the pixels of the raw fetch, packed as JAX's packer
    packs them."""
    core = CAECodecCore(autoencoder_from_state_dict(FLAGSHIP, device="cpu"),
                        device="cpu")
    sym = core.fetch_symbols(core.encode_tiles_device(_tiles("grain", 2,
                                                             64)))
    raw = core.decode_tiles_device(sym).numpy()
    packed = core.decode_packed(sym)
    head, words, _, total = packed
    assert int(total) <= head.shape[0]
    np.testing.assert_array_equal(CAECodecCore.fetch_pixels(packed,
                                                            raw.shape), raw)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(
        jpack.pack_pixels_device(jnp.asarray(raw))[0]))


def test_packed_fetch_of_a_batch_past_its_head():
    """Noise packs at 8 bits a value, past the head's 6: the tail comes in
    a second copy and the tiles come back whole."""
    tiles = _tiles("noise", 5, 128)
    packed = pack_pixels_device_with_head(torch.from_numpy(tiles))
    assert int(packed[3]) > packed[0].shape[0]
    np.testing.assert_array_equal(
        CAECodecCore.fetch_pixels(packed, tiles.shape), tiles)
