"""The port's general and image codecs against the JAX package's, on the
CPU: for each config the same bytes, the same config, and chunks that
decode in both packages; ``get_codec`` opens every codec id of the JAX
registry in a fresh interpreter without JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import cnn_autoencoder_tpu.storage.image_codecs  # noqa: F401 (registers)
from cnn_autoencoder_tpu.storage import blosc_frame as jax_blosc_frame
from cnn_autoencoder_tpu.storage.codecs import get_codec as jax_get_codec
from cnn_autoencoder_tpu_torch.storage import blosc_frame
from cnn_autoencoder_tpu_torch.storage.codecs import get_codec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = [
    {"id": "zlib", "level": 1}, {"id": "zlib", "level": 9},
    {"id": "gzip", "level": 5}, {"id": "bz2", "level": 1},
    {"id": "bz2", "level": 9}, {"id": "lzma", "preset": 1},
    {"id": "lzma", "preset": 6},
    {"id": "blosc", "cname": "zlib", "clevel": 5, "shuffle": 1,
     "blocksize": 0},
    {"id": "blosc", "cname": "lz4", "clevel": 1, "shuffle": 0,
     "blocksize": 4096},
    {"id": "blosc", "cname": "zlib", "clevel": 9, "shuffle": 2,
     "blocksize": 1000},
]
IMAGE_CONFIGS = [{"id": "imagecodecs_jpeg", "level": 90},
                 {"id": "imagecodecs_jpeg", "level": 40},
                 {"id": "imagecodecs_jpeg2k", "level": 80}]


def _image(h=48, w=40, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    img = (np.sin(yy / 7.0) + np.cos(xx / 5.0))[:, :, None] * 60 + 128
    img = img + np.random.RandomState(seed).randn(h, w, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("config", CONFIGS + IMAGE_CONFIGS,
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_codec_matches_jax(config):
    ours, theirs = get_codec(config), jax_get_codec(config)
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.get_config() == theirs.get_config()
    img = _image()
    buf = ours.encode(img)
    assert buf == theirs.encode(img)
    got = ours.decode(buf)
    np.testing.assert_array_equal(got, theirs.decode(buf))
    if config["id"].startswith("imagecodecs"):
        assert got.shape == img.shape
    else:
        np.testing.assert_array_equal(got, img.reshape(-1))
    out = np.empty(img.size, np.uint8)
    assert ours.decode(buf, out=out) is out
    np.testing.assert_array_equal(out, got.reshape(-1))
    assert get_codec(ours.get_config()).get_config() == ours.get_config()


@pytest.mark.parametrize("n,typesize,blocksize", [(0, 1, 0), (7, 1, 0),
                                                  (100000, 4, 0),
                                                  (70001, 3, 8192),
                                                  (5000, 1, 100)])
def test_blosc_frame_matches_jax(n, typesize, blocksize):
    """The stdlib blosc1 frame: the same bytes at any type size and block
    size (memcpy frames for data that does not compress), decoded by
    both."""
    rng = np.random.RandomState(n)
    data = (np.repeat(rng.randint(0, 4, max(1, n // 8)), 8)[:n]
            .astype(np.uint8).tobytes())
    if n == 7:
        data = rng.bytes(n)
    frame = blosc_frame.compress(data, typesize=typesize, blocksize=blocksize)
    assert frame == jax_blosc_frame.compress(data, typesize=typesize,
                                             blocksize=blocksize)
    assert blosc_frame.decompress(frame) == data
    assert jax_blosc_frame.decompress(frame) == data


def test_corrupt_blosc_frames_raise():
    frame = blosc_frame.compress(b"\x01\x02" * 5000, typesize=2)
    for bad in (frame[:10], frame[:-5],
                frame[:2] + bytes([frame[2] & 0x1F | (1 << 5)]) + frame[3:]):
        with pytest.raises(ValueError):
            blosc_frame.decompress(bad)


_FRESH = r"""
import json
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
from cnn_autoencoder_tpu_torch.storage.codecs import get_codec
names = []
for config in [{"id": "cae", "checkpoint": sys.argv[1], "offset": 0},
               {"id": "cae_tpu", "checkpoint": sys.argv[1],
                "num_streams": 64}]:
    names.append(type(get_codec(config, device="cpu")).__name__)
for config in [json.loads(sys.argv[2]), {"id": "zlib", "level": 1},
               {"id": "imagecodecs_jpeg", "level": 90},
               {"id": "imagecodecs_jpeg2k", "level": 80}]:
    names.append(type(get_codec(config)).__name__)
print(" ".join(names))
"""


def test_fresh_reader_opens_every_id():
    """A reader that imported no codec module opens 'cae', 'cae_tpu',
    'cae_bn' (a config the JAX package wrote) and the general and image
    codecs' configs by id, with JAX blocked."""
    from cnn_autoencoder_tpu.storage.cae_codec import \
        ConvolutionalAutoencoderBottleneck
    from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
    path = "benchmarks/bench_flagship.msgpack"
    bn = ConvolutionalAutoencoderBottleneck(
        48, fact_ent=load_checkpoint(path)["fact_ent"]["params"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _FRESH, path, json.dumps(bn.get_config())],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [
        "ConvolutionalAutoencoder", "ConvolutionalAutoencoderTurbo",
        "ConvolutionalAutoencoderBottleneck", "Zlib", "Jpeg", "Jpeg2k"]
