"""The slice as a whole: the port's 'cae_tpu' codec (plain versions, on the
CPU) against the JAX package's.  Equal symbols, byte-identical frames,
decode across the two packages both ways, the codec ABI, and what the port
refuses."""

import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.models.entropy import aux_loss_fn
from cnn_autoencoder_tpu.models.factory import build_model
from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.storage.turbo_codec import \
    CAETurboCore as JaxTurboCore
from cnn_autoencoder_tpu.storage.turbo_codec import \
    ConvolutionalAutoencoderTurbo as JaxTurboCodec
from cnn_autoencoder_tpu.training.checkpoint import save_checkpoint
from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.storage.codecs import get_codec
from cnn_autoencoder_tpu_torch.storage.turbo_codec import (
    TURBO_FLAG, CAETurboCore, ConvolutionalAutoencoderTurbo, is_turbo_frame)

FLAGSHIP = "benchmarks/bench_flagship.msgpack"


@pytest.fixture(scope="module")
def small_checkpoint(tmp_path_factory):
    """The JAX turbo tests' model (fitted quantiles), saved by the JAX
    package."""
    m = build_model(jax.random.PRNGKey(0), input_size=(32, 32),
                    channels_org=3, channels_net=8, channels_bn=16,
                    compression_level=2, K=4, r=3, act_layer_type="GDN")
    p = m.variables["fact_ent"]["params"]
    g = jax.jit(jax.grad(lambda q, pp: aux_loss_fn({**pp, "quantiles": q},
                                                   4)))
    q = p["quantiles"]
    for _ in range(200):
        q = q - 0.1 * g(q, p)
    m.variables["fact_ent"]["params"] = {**p, "quantiles": q}
    chk = dict(m.config)
    chk.update(m.variables)
    path = str(tmp_path_factory.mktemp("ckpt") / "small.msgpack")
    save_checkpoint(path, chk)
    return path


@pytest.fixture(scope="module")
def cores(small_checkpoint):
    """{name: (JAX core, port core)} at 64 streams."""
    out = {}
    for name, path in (("flagship", FLAGSHIP), ("small", small_checkpoint)):
        out[name] = (JaxTurboCore(jax_from_state_dict(path), num_streams=64),
                     CAETurboCore(autoencoder_from_state_dict(
                         path, device="cpu"), num_streams=64, device="cpu"))
    return out


def _image(h, w, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    img = (np.sin(yy / 9.0) + np.cos(xx / 11.0))[:, :, None] * 55 + 128
    img = img + np.random.RandomState(seed).randn(h, w, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def _assert_u8_close(a, b):
    diff = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b))
    assert np.mean(diff != 0) < 5e-3 and diff.max() <= 1


@pytest.mark.parametrize("name,h,w,batch", [("flagship", 64, 64, 1),
                                            ("small", 64, 64, 2),
                                            ("small", 50, 38, 2)])
def test_round_trip_matches_jax(cores, name, h, w, batch):
    jcore, tcore = cores[name]
    tiles = np.stack([_image(h, w, seed) for seed in range(batch)])

    sym_j = jcore.base.fetch_symbols(
        jcore.base.encode_tiles_device(jnp.asarray(tiles)))
    sym_t = tcore.latent_symbols(tiles).numpy()
    np.testing.assert_array_equal(sym_t, sym_j)

    frames_j = jcore.encode_tiles(tiles)
    frames_t = tcore.encode_tiles(tiles)
    assert all(is_turbo_frame(f) for f in frames_t)
    assert frames_t == frames_j
    th, tw = struct.unpack(">QQ", frames_t[0][:16])
    assert (th & ~TURBO_FLAG, tw) == (h, w)

    rec_j = jcore.decode_tiles(frames_t)        # port frames in JAX
    rec_t = tcore.decode_tiles(frames_j)        # JAX frames in the port
    assert rec_t.shape == tiles.shape and rec_t.dtype == np.uint8
    _assert_u8_close(rec_t, rec_j)
    np.testing.assert_array_equal(
        tcore.symbols_from_frames(frames_j, 64, h, w).numpy(), sym_t)


@pytest.mark.parametrize("name,streams", [("small", 16), ("small", 1024),
                                          ("small", 2048),
                                          ("flagship", 2048)])
def test_frames_match_jax_at_stream_counts(cores, name, streams):
    """Frames byte-identical to the JAX codec's at S = 16, 1024 and 2048
    (above the old kernels' 1024), decoded both ways."""
    jmodel = cores[name][0].model
    tmodel = cores[name][1].model
    jcore = JaxTurboCore(jmodel, num_streams=streams)
    tcore = CAETurboCore(tmodel, num_streams=streams, device="cpu")
    tiles = np.stack([_image(64, 64, seed) for seed in (3, 4)])
    frames_t = tcore.encode_tiles(tiles)
    assert frames_t == jcore.encode_tiles(tiles)
    assert all(struct.unpack(">H", f[17:19])[0] == streams
               for f in frames_t)
    sym_t = tcore.latent_symbols(tiles).numpy()
    np.testing.assert_array_equal(
        tcore.symbols_from_frames(frames_t, streams, 64, 64).numpy(), sym_t)
    _assert_u8_close(tcore.decode_tiles(frames_t),
                     jcore.decode_tiles(frames_t))


def test_capacity_overflow_recompacts_only(cores, monkeypatch):
    """A first capacity that overflows: the frames equal those of a first
    capacity that fits, the state pass ran once per batch, and only the
    compaction ran again."""
    from cnn_autoencoder_tpu_torch.storage import turbo_codec
    _, tcore = cores["small"]
    tiles = np.stack([_image(64, 64, seed) for seed in (5, 6)])
    calls = {"encode_states": 0, "rans_compact": 0}

    def counted(name):
        fn = getattr(turbo_codec, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in calls:
        monkeypatch.setattr(turbo_codec, name, counted(name))
    want = tcore.encode_tiles(tiles)
    assert calls == {"encode_states": 1, "rans_compact": 1}
    retries = tcore.capacity_retries
    # an entropy estimate far too low: the first capacity holds little
    # more than the flush words
    monkeypatch.setattr(tcore, "expected_bits", 1e-3)
    assert tcore.encode_tiles(tiles) == want
    assert calls["encode_states"] == 2 and calls["rans_compact"] > 2
    assert tcore.capacity_retries - retries == calls["rans_compact"] - 2


def test_codec_abi(small_checkpoint):
    codec = ConvolutionalAutoencoderTurbo(small_checkpoint, num_streams=32,
                                          device="cpu")
    img = _image(32, 32, seed=5)
    buf = codec.encode(img)
    rec = codec.decode(buf)
    assert rec.shape == img.shape and rec.dtype == np.uint8
    out = np.empty_like(img)
    assert codec.decode(buf, out=out) is out
    np.testing.assert_array_equal(out, rec)

    config = codec.get_config()
    assert config == {"id": "cae_tpu", "checkpoint": small_checkpoint,
                      "num_streams": 32}
    assert config == JaxTurboCodec(small_checkpoint,
                                   num_streams=32).get_config()
    codec2 = get_codec(config, device="cpu")
    assert isinstance(codec2, ConvolutionalAutoencoderTurbo)
    np.testing.assert_array_equal(codec2.decode(buf), rec)


def test_decode_mixed_batch_and_foreign_stream_count(cores):
    """Frames of other sizes and stream counts than the reader's decode in
    one call; mixed shapes come back as a list, in order."""
    jcore, tcore = cores["small"]
    a = _image(32, 32, seed=1)
    b = _image(48, 40, seed=2)
    frame_a = tcore.encode_tiles(a[None])[0]
    frame_b = JaxTurboCore(jcore.model, num_streams=16).encode_tiles(
        b[None])[0]
    recs = tcore.decode_tiles([frame_b, frame_a, frame_b])
    assert isinstance(recs, list) and [r.shape for r in recs] == \
        [b.shape, a.shape, b.shape]
    np.testing.assert_array_equal(recs[1],
                                  tcore.decode_tiles([frame_a])[0])
    _assert_u8_close(recs[0], jcore.decode_tiles([frame_b])[0])


def _corruptions(frame):
    """(label, corrupt buffer) pairs, each of which must raise."""
    s = struct.unpack(">H", frame[17:19])[0]
    bad_h = bytearray(frame)
    bad_h[:8] = struct.pack(">Q", TURBO_FLAG | (1 << 40))
    return [
        ("short", frame[:10]),
        ("truncated header", frame[:20]),
        ("host format", struct.pack(">QQ", 32, 32) + frame[16:]),
        ("implausible size", bytes(bad_h)),
        ("version 3", frame[:16] + struct.pack(">BH", 3, s) + frame[19:]),
        ("version 9", frame[:16] + struct.pack(">BH", 9, s) + frame[19:]),
        ("zero streams", frame[:16] + struct.pack(">BH", 4, 0)
         + frame[19:]),
        ("payload cut", frame[:-4]),
        ("odd length", frame[:19] + struct.pack(">I", 5) + frame[23:]),
    ]


def test_corrupt_frames_raise(cores):
    _, tcore = cores["small"]
    frame = tcore.encode_tiles(_image(32, 32)[None])[0]
    for label, buf in _corruptions(frame):
        with pytest.raises(ValueError):
            tcore.decode_tiles([buf])
            pytest.fail(f"{label} did not raise")


def test_escapes_raise(cores, small_checkpoint):
    _, tcore = cores["small"]
    sym = tcore.latent_symbols(_image(32, 32)[None])
    sym[0, 3, 0, 0] = int(tcore.tables.offset[3]) - 5
    with pytest.raises(ValueError, match="escapes"):
        tcore.frames_from_symbols(sym, [(32, 32)])

    # a model whose latent leaves every table
    model = autoencoder_from_state_dict(small_checkpoint, device="cpu")
    with torch.no_grad():
        model.encoder.down_1.conv_down.weight.mul_(1e3)
    core = CAETurboCore(model, num_streams=32, device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        core.encode_tiles(_image(32, 32)[None])


def test_default_device_without_card_raises(small_checkpoint, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autoencoder_from_state_dict(small_checkpoint)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConvolutionalAutoencoderTurbo(small_checkpoint)
    model = autoencoder_from_state_dict(small_checkpoint, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CAETurboCore(model)


def test_kernel_wrappers_take_only_cuda_tensors():
    from cnn_autoencoder_tpu_torch.ops.kernels import kernel_wrappers
    from cnn_autoencoder_tpu_torch.ops.kernels.conv_gdn_kernel import (
        conv_gdn_cuda, conv_gdn_train_cuda)
    from cnn_autoencoder_tpu_torch.ops.kernels.gdn_kernel import (
        gdn_cuda, gdn_train_bwd_cuda, gdn_train_fwd_cuda)
    from cnn_autoencoder_tpu_torch.ops.kernels.rans_kernel import (
        EncodeState, compact_cuda, decode_interleaved_cuda,
        encode_states_cuda)
    x = torch.zeros(4, 8)
    xb = x.to(torch.bfloat16)
    i = torch.zeros(1, 2, 4, dtype=torch.int32)
    q = torch.zeros(1, 8, dtype=torch.uint16)
    state = EncodeState(torch.zeros(1, 2, 4, dtype=torch.uint16),
                        torch.zeros(1, 2, dtype=torch.int32),
                        torch.zeros(1, 4, dtype=torch.int32),
                        torch.zeros(1, 1, dtype=torch.int32))
    conv_args = (torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 8),
                 torch.eye(8), torch.ones(8))
    calls = [lambda: gdn_cuda(x, torch.eye(8), torch.ones(8)),
             lambda: gdn_train_fwd_cuda(xb, torch.eye(8), torch.ones(8)),
             lambda: gdn_train_bwd_cuda(xb, xb, xb, torch.eye(8)),
             lambda: conv_gdn_cuda(*conv_args),
             lambda: conv_gdn_train_cuda(*conv_args),
             lambda: encode_states_cuda(i, i[0], i[0], i[0], i[0, 0]),
             lambda: compact_cuda(state, 64),
             lambda: decode_interleaved_cuda(q, i[0], i[0], 2)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert {fn.kernel_name for fn in kernel_wrappers()} == {
        "gdn_fwd", "gdn_train_fwd", "gdn_train_bwd", "conv_gdn_fwd",
        "conv_gdn_train_fwd", "rans_encode_states", "rans_compact",
        "rans_decode"}
    assert all(fn.launches == 0 for fn in kernel_wrappers())


def test_port_imports_without_jax():
    """The port (and chip_smoke.py) import with JAX blocked and load no
    module of the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import cnn_autoencoder_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'cnn_autoencoder_tpu'\n"
        "       or m.startswith('cnn_autoencoder_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
