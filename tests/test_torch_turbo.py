"""The slice as a whole: the port's 'cae_tpu' codec (plain versions, on the
CPU) against the JAX package's.  Equal symbols, byte-identical frames (v4,
and the host frames of the escape and capacity fallbacks), decode across
the two packages both ways (v4, v3, host and mixed batches), the codec
ABI, and corrupt frames."""

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

from chip_smoke import scaled_checkpoint, v3_frame_bytes, v3_frames

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
        ("implausible size", bytes(bad_h)),
        ("implausible host size", struct.pack(">QQ", 1 << 40, 32)
         + frame[16:]),
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
    """A batch with escapes no longer raises: it is written as host 'cae'
    frames byte-identical to the JAX core's, which decode in both packages
    (the port's fallback codes the symbols it holds; the JAX core runs its
    encoder again)."""
    jcore, tcore = cores["small"]
    tiles = np.stack([_image(32, 32, seed) for seed in (0, 1)])
    sym = tcore.latent_symbols(tiles)
    sym[0, 3, 0, 0] = int(tcore.tables.offset[3]) - 5
    sym[1, 5, 2, 1] = 5000
    before = tcore.host_fallbacks
    frames = tcore.frames_from_symbols(sym, [(32, 32)] * 2)
    assert tcore.host_fallbacks == before + 1
    assert not any(is_turbo_frame(f) for f in frames)
    assert frames == jcore.base.entropy_encode(sym.numpy(), [(32, 32)] * 2)
    np.testing.assert_array_equal(tcore.base.entropy_decode(frames)[0],
                                  sym.numpy())

    # a model whose latent leaves the tables: whole tiles escape
    state = scaled_checkpoint(100.0, small_checkpoint)
    jscaled = JaxTurboCore(jax_from_state_dict(state), num_streams=32)
    core = CAETurboCore(autoencoder_from_state_dict(state, device="cpu"),
                        num_streams=32, device="cpu")
    frames = core.encode_tiles(tiles)
    assert core.host_fallbacks == 1 and core.capacity_retries == 0
    want = jscaled.encode_tiles(tiles)
    assert not any(is_turbo_frame(f) for f in want)
    assert frames == want
    rec = core.decode_tiles(frames)
    _assert_u8_close(rec, jscaled.decode_tiles(frames))
    np.testing.assert_array_equal(rec, core.base.decode_tiles(frames))


def test_six_capacities_then_host_frames(cores):
    """With the entropy estimate at 0 the first capacity is 2S + 64 words
    and six doublings stay below what the tiles need: the JAX core writes
    host frames, and so does the port, byte for byte."""
    jcore0, tcore0 = cores["small"]
    jcore = JaxTurboCore(jcore0.model, num_streams=16)
    tcore = CAETurboCore(tcore0.model, num_streams=16, device="cpu")
    jcore.expected_bits = tcore.expected_bits = 0.0
    tiles = np.stack([_image(128, 128, seed) for seed in (7, 8)])
    want = jcore.encode_tiles(tiles)
    assert not any(is_turbo_frame(f) for f in want)
    frames = tcore.encode_tiles(tiles)
    assert frames == want
    assert tcore.capacity_retries == 5 and tcore.host_fallbacks == 1
    # the same tiles fit a real first capacity
    tcore.expected_bits = tcore0.expected_bits
    assert all(is_turbo_frame(f) for f in tcore.encode_tiles(tiles))
    _assert_u8_close(tcore.decode_tiles(frames), jcore.decode_tiles(frames))


def _v3_frames(core, tiles, s):
    """Frame v3 of ``tiles`` built as the JAX package's v3 test builds it:
    the encoder's symbols, ``encode_device`` (per-stream buffers) and the
    length table.  ``core`` is a JAX or a port core."""
    hw = [tiles.shape[1:3]] * len(tiles)
    if not isinstance(core, JaxTurboCore):
        return v3_frames(core, core.latent_symbols(tiles), hw, s)
    from cnn_autoencoder_tpu.coding.device_rans import (encode_device,
                                                        pack_streams)
    sym = core.base.fetch_symbols(core.base.encode_tiles_device(
        jnp.asarray(tiles)))
    b, _, lh, lw = sym.shape
    packed = pack_streams(jnp.asarray(sym.reshape(b, -1)), s)
    cap = 2 * packed.shape[1] + 8
    bufs, lengths, esc = encode_device(packed, core._get_ch_map(lh, lw, s),
                                       core.tables, cap)
    assert int(esc) == 0
    return v3_frame_bytes(bufs, lengths, cap, s, hw)


@pytest.mark.parametrize("name,h,w,s", [("small", 32, 32, 64),
                                        ("small", 50, 38, 100),
                                        ("flagship", 64, 64, 1024)])
def test_jax_v3_frames_decode(cores, name, h, w, s):
    """v3 frames the JAX package builds decode in the port to the
    reconstruction of their v4 twins; the port's v3 writer builds the same
    bytes, and the JAX package decodes them."""
    jcore, tcore = cores[name]
    tiles = np.stack([_image(h, w, seed) for seed in (2, 3)])
    v3 = _v3_frames(JaxTurboCore(jcore.model, num_streams=s), tiles, s)
    assert _v3_frames(tcore, tiles, s) == v3
    v4 = tcore.encode_tiles(tiles)
    np.testing.assert_array_equal(
        tcore.symbols_from_frames_v3(v3, s, h, w),
        tcore.latent_symbols(tiles))
    np.testing.assert_array_equal(tcore.decode_tiles(v3),
                                  tcore.decode_tiles(v4))
    _assert_u8_close(jcore.decode_tiles(v3), tcore.decode_tiles(v3))


def test_mixed_formats_decode_in_order(cores):
    """One decode batch of v4, host, v3 and other-size frames comes back in
    index order, each tile as its own format decodes alone, and as the JAX
    core decodes the batch."""
    jcore, tcore = cores["small"]
    a = np.stack([_image(32, 32, seed) for seed in (4, 5)])
    b = _image(40, 24, seed=6)[None]
    v4 = tcore.encode_tiles(a)
    host = tcore.base.encode_tiles(a)
    v3 = _v3_frames(tcore, a, 64)
    other = tcore.encode_tiles(b)
    batch = [v4[0], host[1], v3[0], other[0], host[0], v3[1], v4[1]]
    recs = tcore.decode_tiles(batch)
    assert isinstance(recs, list) and len(recs) == len(batch)
    alone = [tcore.decode_tiles([f])[0] for f in batch]
    for got, want in zip(recs, alone):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(recs, jcore.decode_tiles(batch)):
        _assert_u8_close(got, want)
    # one size: stacked, in order
    same = [host[1], v3[0], v4[1]]
    stacked = tcore.decode_tiles(same)
    assert isinstance(stacked, np.ndarray) and stacked.shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(stacked, np.stack(
        [alone[1], alone[2], alone[6]]))


def test_v3_guards(cores):
    """The v3 reader checks its untrusted length table before it sizes a
    buffer: a truncated table, a table past the payload, an odd payload
    and a skewed table raise; balanced short streams decode."""
    _, tcore = cores["small"]

    def frame(s, table, payload, h=64, w=64):
        return (struct.pack(">QQ", h | TURBO_FLAG, w)
                + struct.pack(">BH", 3, s) + table + payload)

    bad = {
        "truncated": frame(1024, b"\x00" * 16, b""),
        "corrupt": frame(8, struct.pack(">8I", 0xFFFFFFF0, *[0] * 7),
                         b"\x00" * 64),
        "corrupt odd": frame(2, struct.pack(">2I", 2, 2), b"\x00" * 5),
        "skew": frame(1024, struct.pack(">I", 8192) + b"\x00" * 4092,
                      b"\x00" * 8192),
    }
    for match, buf in bad.items():
        with pytest.raises(ValueError, match=match.split()[0]):
            tcore.decode_tiles([buf])
    s, words = 1024, 3
    ok = frame(s, struct.pack(">%dI" % s, *([2 * words] * s)),
               b"\x00" * (2 * words * s))
    assert tcore.decode_tiles([ok]).shape == (1, 64, 64, 3)


@pytest.mark.parametrize("lh,lw,s,cap", [(4, 4, 64, 40), (3, 5, 100, 8),
                                         (8, 8, 1024, 24)])
def test_encode_decode_device_match_jax(lh, lw, s, cap):
    """The port's v3 writer and reader equal the JAX package's on seeded
    symbols (flagship tables), escapes and overflowing capacities
    included."""
    from cnn_autoencoder_tpu.coding import device_rans as jrans
    from cnn_autoencoder_tpu_torch.coding import device_rans as trans
    from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
    params = {k: np.asarray(v) for k, v in
              load_checkpoint(FLAGSHIP)["fact_ent"]["params"].items()}
    jt = jrans.bake_device_tables(params, (3, 3, 3, 3))
    tt = trans.bake_device_tables(params, (3, 3, 3, 3))
    cmap = trans.stream_channel_map(48, (lh, lw), s)
    off, length = tt.offset.numpy()[cmap], tt.length.numpy()[cmap]
    rng = np.random.RandomState(lh * s)
    sym = np.stack([off + length // 3 + rng.randint(0, 1 + length // 3)
                    for _ in range(2)]).astype(np.int32)
    sym[0, 0, 0] = off[0, 0] - 3
    bj, lj, ej = jrans.encode_device(jnp.asarray(sym), jnp.asarray(cmap),
                                     jt, cap)
    bt, lt, et = trans.encode_device(torch.from_numpy(sym),
                                     torch.from_numpy(cmap), tt, cap)
    assert bt.dtype == torch.uint16
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert int(et) == int(ej) == 1
    t = cmap.shape[0]
    np.testing.assert_array_equal(
        trans.decode_device(bt, torch.from_numpy(cmap), tt, t).numpy(),
        np.asarray(jrans.decode_device(bj, jnp.asarray(cmap), jt, t)))


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
        F32_BF16X1, F32_BF16X3, PALLAS_BF16, conv_gdn_cuda,
        conv_gdn_train_cuda)
    from cnn_autoencoder_tpu_torch.ops.kernels.gdn_kernel import (
        gdn_bf16_cuda, gdn_bf16_f32pool_cuda, gdn_cuda, gdn_train_bwd_cuda,
        gdn_train_fwd_bf16_f32pool_cuda, gdn_train_fwd_cuda,
        gdn_train_fwd_f32_cuda)
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
    conv_args_b = (conv_args[0].to(torch.bfloat16),) + conv_args[1:]
    gdn_args = (torch.eye(8), torch.ones(8))
    calls = [lambda: gdn_cuda(x, *gdn_args),
             lambda: gdn_cuda(xb, *gdn_args),
             lambda: gdn_bf16_cuda(xb, *gdn_args),
             lambda: gdn_bf16_f32pool_cuda(xb, *gdn_args),
             lambda: gdn_train_fwd_cuda(xb, *gdn_args),
             lambda: gdn_train_fwd_f32_cuda(x, *gdn_args),
             lambda: gdn_train_fwd_bf16_f32pool_cuda(xb, *gdn_args),
             lambda: gdn_train_bwd_cuda(xb, xb, xb, torch.eye(8)),
             lambda: conv_gdn_cuda(*conv_args),
             lambda: conv_gdn_cuda(*conv_args_b),
             lambda: conv_gdn_cuda(*conv_args_b, PALLAS_BF16),
             lambda: conv_gdn_cuda(*conv_args, F32_BF16X1),
             lambda: conv_gdn_cuda(*conv_args, F32_BF16X3),
             lambda: conv_gdn_train_cuda(*conv_args),
             lambda: conv_gdn_train_cuda(*conv_args_b),
             lambda: conv_gdn_train_cuda(*conv_args, F32_BF16X1),
             lambda: conv_gdn_train_cuda(*conv_args, F32_BF16X3),
             lambda: encode_states_cuda(i, i[0], i[0], i[0], i[0, 0]),
             lambda: compact_cuda(state, 64),
             lambda: decode_interleaved_cuda(q, i[0], i[0], 2)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert {fn.kernel_name for fn in kernel_wrappers()} == {
        "gdn_fwd", "gdn_fwd_bf16", "gdn_fwd_bf16_f32pool", "gdn_train_fwd",
        "gdn_train_fwd_f32", "gdn_train_fwd_bf16_f32pool", "gdn_train_bwd",
        "conv_gdn_fwd", "conv_gdn_fwd_pallas_bf16", "conv_gdn_fwd_bf16",
        "conv_gdn_fwd_bf16x1",
        "conv_gdn_fwd_bf16x3", "conv_gdn_train_fwd", "conv_gdn_train_fwd_bf16",
        "conv_gdn_train_fwd_bf16x1", "conv_gdn_train_fwd_bf16x3",
        "rans_encode_states",
        "rans_compact", "rans_decode"}
    assert all(fn.launches == 0 for fn in kernel_wrappers())


def test_port_imports_without_jax():
    """The port (and chip_smoke.py) import with JAX blocked and load no
    module of the JAX package; every module is imported (the host coder,
    the CAE, general and image codecs among them) and none builds or loads
    a library at import."""
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
        "need = ['coding.rans', 'coding._rans_py', 'storage.cae_codec',\n"
        "        'storage.blosc_frame', 'storage.image_codecs',\n"
        "        'ops.msssim', 'criteria.ratedist', 'utils.torch_import']\n"
        "assert all(p.__name__ + '.' + m in sys.modules for m in need)\n"
        "from cnn_autoencoder_tpu_torch.coding import rans\n"
        "from cnn_autoencoder_tpu_torch.ops.kernels import build\n"
        "assert rans._lib is None and build._lib is None\n"
        "assert 'PIL' not in sys.modules\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
