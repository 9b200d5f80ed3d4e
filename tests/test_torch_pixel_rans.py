"""The port's rANS pixel transport (``coding/pixel_rans.py``, the coded
paths of ``storage/cae_codec.py`` and ``storage/turbo_codec.py``, the
transport branches of ``pipeline/tiles.py``) against the JAX package's on
the CPU, with the same seeded tiles, where K5 and K6 take their plain
versions:

* the predictors, the calibration (tables, predictor, bits a value,
  capacities) and the host C++ words equal to JAX's in both predictor
  modes, each package decoding the other's words;
* the device residual words (K6's plain versions) equal to JAX's
  ``encode_residuals_device`` without Pallas, from the same tables;
* the queue compaction and expansion, the overflow fallbacks and the
  refit after three overflows;
* the 'cae' and 'cae_tpu' pipelines with each switch forced: chunks equal
  to the untransported pipeline's and (coded upload) to the JAX package's
  stores, pixels equal to a raw fetch; the overlapped round trip with
  persisted transports equal to the sequential pair, and finishing when
  batch 0's encode comes last.

The tiles are 64^2 RGB (a coded tile must beat its 2 * 1024 flush words),
through the flagship, whose reconstructions the plane predictor codes; the
source tiles take the hybrid predictor."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.coding import pixel_rans as jpr
from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.pipeline import tiles as jtiles
from cnn_autoencoder_tpu.storage.cae_codec import CAECodecCore as JCore
from cnn_autoencoder_tpu.storage.turbo_codec import CAETurboCore as JTurbo
from cnn_autoencoder_tpu_torch.coding import _rans_py
from cnn_autoencoder_tpu_torch.coding.pixel_rans import (
    STREAMS, PixelRansTransport, RansFetchResult, _quantize_freqs_optimal,
    compact_host, compact_queues_device, decode_residuals_device,
    encode_residuals_device, expand_queues_device, residual_hist_host,
    residual_zigzag_device, unzigzag_unpredict_device)
from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.pipeline import tiles as ttiles
from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
from cnn_autoencoder_tpu_torch.utils.profiling import GLOBAL_TIMER

from chip_smoke import synth_histology
from tests.test_torch_turbo import FLAGSHIP

P = 64                    # tile side
SWITCHES = ("CAE_TPU_CODED_UPLOAD", "CAE_TPU_PACKED_FETCH",
            "CAE_TPU_FETCH_CODEC")


@pytest.fixture(autouse=True)
def _no_switches(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _noise(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape,
                                               dtype=np.uint8)


def _smooth2d(shape, seed=0):
    """Rows that follow the row above with much variation along each: the
    plane predictor codes them tighter than the hybrid (the JAX package's
    test content)."""
    rng = np.random.RandomState(seed)
    b, p, q, c = shape
    cols = rng.randint(0, 200, size=(b, 1, q, c)).astype(np.float64)
    drift = np.cumsum(rng.randint(-2, 3, size=(b, p, 1, c)), axis=1)
    return np.clip(cols + drift + 28, 0, 255).astype(np.uint8)


def _smooth_image(h, w, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.sin(yy / 19.0) * 60 + np.cos(xx / 29.0) * 50 + 128
    return np.clip(base[:, :, None] + rng.randn(h, w, 3) * 2.0, 0,
                   255).astype(np.uint8)


def _u16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _pair(tiles, mode=None):
    """(JAX transport, port transport) calibrated from ``tiles``, by the
    predictor ``mode`` or (None) the one that codes them tighter."""
    jt, tt = jpr.PixelRansTransport(), PixelRansTransport("cpu")
    if mode is None:
        jt.calibrate_from_tiles(tiles)
        tt.calibrate_from_tiles(tiles)
    else:
        jt.calibrate(jpr.residual_hist_host(tiles, mode), mode)
        tt.calibrate(residual_hist_host(tiles, mode), mode)
    return jt, tt


@pytest.fixture(scope="module")
def model():
    return autoencoder_from_state_dict(FLAGSHIP, device="cpu")


# -- transforms, calibration, words -------------------------------------------


@pytest.mark.parametrize("mode", [0, 1])
def test_predictors_equal_jax(mode):
    """Device, host C++ and numpy predictors agree with JAX's device
    transform, and the device inverse gives the tiles back."""
    tiles = _noise((2, 9, 17, 3), 21)
    z = residual_zigzag_device(torch.from_numpy(tiles), mode).numpy()
    np.testing.assert_array_equal(z, np.asarray(jpr.residual_zigzag_device(
        jnp.asarray(tiles), mode)))
    np.testing.assert_array_equal(_rans_py.pixel_predict_zigzag(tiles, mode),
                                  z)
    np.testing.assert_array_equal(
        residual_hist_host(tiles, mode), np.bincount(z.reshape(-1),
                                                     minlength=256))
    np.testing.assert_array_equal(unzigzag_unpredict_device(
        torch.from_numpy(z), mode).numpy(), tiles)
    np.testing.assert_array_equal(_rans_py.pixel_unpredict(z, mode), tiles)


@pytest.mark.parametrize("content,mode", [("noise", 0), ("smooth2d", 1),
                                          ("histology", 0)])
def test_calibration_equals_jax(content, mode):
    """Adaptive calibration picks the same predictor (the hybrid on noisy
    content, the plane on 2-D smooth content) with the same table, bits a
    value, capacities and gates."""
    shape = (2, 32, 64, 3)
    tiles = {"noise": lambda: _noise(shape, 26),
             "smooth2d": lambda: _smooth2d(shape, 25),
             "histology": lambda: synth_histology(64, 64, 1).reshape(
                 2, 32, 64, 3)}[content]()
    jt, tt = _pair(tiles)
    assert tt.pred_mode == jt.pred_mode == mode
    np.testing.assert_array_equal(tt.freq, jt.freq)
    np.testing.assert_array_equal(tt.start, jt.start)
    assert tt.bits_per_value == jt.bits_per_value
    n = P * P * 3
    for fn in ("capacity", "worthwhile"):
        assert getattr(tt, fn)(n) == getattr(jt, fn)(n), fn
    for fn in ("pooled_head_words", "worthwhile_fetch",
               "estimate_coded_words"):
        assert getattr(tt, fn)(n, 16) == getattr(jt, fn)(n, 16), fn
    np.testing.assert_array_equal(tt.dec_lut.numpy(),
                                  np.asarray(jt.dec_lut).reshape(1, -1))


def test_quantize_freqs_equal_jax():
    rng = np.random.RandomState(7)
    mag = np.abs(rng.randn(200_000) * 8.5)
    hists = [np.bincount(np.minimum((mag * 2).astype(np.int64), 255),
                         minlength=256),
             np.zeros(256, np.int64), np.eye(256, dtype=np.int64)[0] * 10**7]
    for hist in hists:
        f = _quantize_freqs_optimal(hist)
        assert f.sum() == 4096 and f.min() >= 1 and f.dtype == np.int32
        np.testing.assert_array_equal(f, jpr._quantize_freqs_optimal(hist))


@pytest.mark.parametrize("mode,shape", [(0, (2, 16, 64, 2)),
                                        (1, (2, 16, 64, 2)),
                                        (0, (1, 8, 60, 3)),
                                        (1, (2, 12, 77, 1))])
def test_host_words_equal_jax(mode, shape):
    """The host C++ coder's words (``pixel_rans_encode``) equal the JAX
    package's and the numpy version's, ragged tiles (n not a multiple of
    S) included; each package's host decode gives the tiles back from the
    other's words."""
    tiles = (_smooth2d if mode else _noise)(shape, 40 + shape[-1])
    jt, tt = _pair(tiles, mode)
    cap = tt.capacity(int(np.prod(shape[1:]))) + 4096
    q, tot = tt.encode_host(tiles, cap)
    jq, jtot = jt.encode_host(tiles, cap)
    np.testing.assert_array_equal(tot, jtot)
    np.testing.assert_array_equal(q, jq)
    one = (1,) + shape[1:]
    for i in range(shape[0]):
        words = q[i, :tot[i]]
        np.testing.assert_array_equal(words, _rans_py.pixel_rans_encode(
            tiles[i:i + 1], tt.freq, tt.start, STREAMS, mode))
        np.testing.assert_array_equal(
            jt.decode_host(words, int(tot[i]), one)[0], tiles[i])
        np.testing.assert_array_equal(
            tt.decode_host(jq[i], int(jtot[i]), one)[0], tiles[i])
        np.testing.assert_array_equal(_rans_py.pixel_rans_decode(
            words, tt.freq, tt.start, one, STREAMS, mode)[0], tiles[i])


@pytest.mark.parametrize("mode", [0, 1])
def test_device_words_equal_jax(mode):
    """``encode_residuals_device`` (K6's plain versions here) writes the
    words and true totals of JAX's without Pallas, from the same tables;
    the host decodes them, and ``decode_residuals_device`` (K5's plain
    version) decodes the host's words back to the tiles."""
    shape = (3, 16, 64, 2)
    tiles = (_smooth2d if mode else _noise)(shape, 2)
    jt, tt = _pair(tiles, mode)
    n = int(np.prod(shape[1:]))
    cap = tt.capacity(n)
    words, totals = encode_residuals_device(torch.from_numpy(tiles),
                                            tt.tables, cap, mode)
    jw, jtot = jpr.encode_residuals_device(jnp.asarray(tiles), jt.tables,
                                           jt.enc_tables, cap, False, mode)
    np.testing.assert_array_equal(totals.numpy(), np.asarray(jtot))
    assert totals.max() <= cap and words.shape == (3, cap)
    w16 = _u16(words)
    for i in range(shape[0]):
        t = int(totals[i])
        np.testing.assert_array_equal(w16[i, :t],
                                      np.asarray(jw)[i, :t].astype(np.uint16))
        np.testing.assert_array_equal(
            tt.decode_host(w16[i], t, (1,) + shape[1:])[0], tiles[i])
    q, _ = tt.encode_host(tiles, cap)
    np.testing.assert_array_equal(decode_residuals_device(
        torch.from_numpy(q), tt.dec_lut, shape, mode).numpy(), tiles)


def test_compaction_and_expansion():
    """``compact_host`` then ``expand_queues_device`` gives every tile's
    words back (a last tile at full capacity reads the zero tail), with
    JAX's offsets and words; ``compact_queues_device`` equals JAX's head."""
    rng = np.random.RandomState(11)
    cap = 4096
    totals = np.array([100, cap, 0, 777], np.int32)
    queues = np.zeros((4, cap), np.uint16)
    for i, t in enumerate(totals):
        queues[i, :t] = rng.randint(1, 1 << 16, t, np.uint16)
    flat, offs = compact_host(queues, totals, cap)
    jflat, joffs = jpr.compact_host(queues, totals, cap)
    np.testing.assert_array_equal(offs, joffs)
    assert flat.shape == (totals.sum(),)
    np.testing.assert_array_equal(flat, jflat[:totals.sum()])
    rows = _u16(expand_queues_device(torch.from_numpy(flat),
                                     torch.from_numpy(offs), cap))
    for i, t in enumerate(totals):
        np.testing.assert_array_equal(rows[i, :t], queues[i, :t])
    with pytest.raises(ValueError, match="exceeds"):
        compact_host(queues, totals, cap - 1)
    head = compact_queues_device(torch.from_numpy(queues),
                                 torch.from_numpy(totals), 6000)
    jhead = jpr.compact_queues_device(jnp.asarray(queues.astype(np.int32)),
                                      jnp.asarray(totals), 6000)
    np.testing.assert_array_equal(_u16(head),
                                  np.asarray(jhead).astype(np.uint16))


def test_live_tables_guard_and_explicit_tables_need_the_predictor():
    tiles = _smooth2d((1, 16, 64, 2), 28)
    tr = PixelRansTransport("cpu")
    tr.calibrate_from_tiles(tiles)
    snap = tr.snapshot()
    cap = tr.capacity(16 * 64 * 2)
    with pytest.raises(ValueError, match="mode"):
        tr.encode_host(tiles, cap, snap.freq, snap.start)
    q, t = tr.encode_host(tiles, cap, snap.freq, snap.start, snap.pred_mode)
    with pytest.raises(ValueError, match="mode"):
        tr.decode_host(q[0], int(t[0]), tiles.shape, snap.freq, snap.start)
    for _ in range(3):
        tr.note_overflow()
    assert not tr.calibrated() and tr.snapshot() is None
    with pytest.raises(RuntimeError, match="uncalibrated"):
        tr.encode_host(tiles, cap)
    # a snapshot taken before the invalidation still codes and decodes
    np.testing.assert_array_equal(tr.decode_host(
        q[0], int(t[0]), tiles.shape, snap.freq, snap.start,
        snap.pred_mode), tiles)


# -- the codec cores ----------------------------------------------------------


def _batch(n=4, seed=0):
    img = _smooth_image(P, P * n, seed)
    return np.stack([img[:, i * P:(i + 1) * P] for i in range(n)])


def test_fetch_overflow_returns_raw_and_refits_after_three(model):
    """A transport calibrated on flat content has too small a budget for a
    real reconstruction: the fetch returns the device's raw pixels, byte
    for byte, and counts an overflow; the third invalidates the table.
    One tile past its own budget inside a pooled head that holds the batch
    takes the raw pixels too."""
    core = CAECodecCore(model, device="cpu")
    sym = core.fetch_symbols(core.encode_tiles_device(_noise((2, P, P, 3),
                                                             11)))
    raw = core.decode_tiles_device(sym).numpy()
    tr = PixelRansTransport("cpu")
    tr.calibrate_from_tiles(np.full((1, P, P, 3), 7, np.uint8))
    assert tr.worthwhile(P * P * 3)
    for k in range(1, 4):
        res = core.decode_tiles_device(sym, transport=tr)
        assert isinstance(res, RansFetchResult)
        np.testing.assert_array_equal(
            CAECodecCore.fetch_pixels(res, raw.shape, tr), raw)
        assert tr._overflows == (k if k < 3 else 1)
    assert not tr.calibrated()

    # (the model smooths any tile, so this batch is coded directly)
    rec = np.concatenate([_batch(3), _noise((1, P, P, 3), 12)])
    tr = PixelRansTransport("cpu")
    tr.calibrate_from_tiles(rec[:3])
    snap, n = tr.snapshot(), P * P * 3
    cap = tr.capacity(n)
    words, totals = encode_residuals_device(torch.from_numpy(rec),
                                            snap.tables, cap, snap.pred_mode)
    assert totals.max() > cap >= totals[:3].max()
    res = RansFetchResult(compact_queues_device(
        words, totals, tr.pooled_head_words(n, 4))[None], totals,
        torch.from_numpy(rec), cap, snap.freq, snap.start, snap.pred_mode)
    np.testing.assert_array_equal(
        CAECodecCore.fetch_pixels(res, rec.shape, tr), rec)
    assert tr._overflows == 1


@pytest.mark.parametrize("underpredict", [False, True])
def test_fetch_head_predicted_slice_both_branches(model, underpredict):
    """The totals and a predicted slice of the head come in one copy; an
    under-prediction fetches the tail in a second; both give the raw
    fetch's pixels."""
    core = CAECodecCore(model, device="cpu")
    sym = core.fetch_symbols(core.encode_tiles_device(_batch(4)))
    raw = core.decode_tiles_device(sym).numpy()
    tr = PixelRansTransport("cpu")
    tr.calibrate_from_tiles(raw)
    res = core.decode_tiles_device(sym, transport=tr)
    assert int(res.totals.max()) <= res.capacity
    if underpredict:
        tr.bits_per_value = 0.01
    GLOBAL_TIMER.reset()
    np.testing.assert_array_equal(
        CAECodecCore.fetch_pixels(res, raw.shape, tr), raw)
    copies = [n for name, n in GLOBAL_TIMER._count.items()
              if name == "decompress/d2h_pixels"]
    assert copies == [2 if underpredict else 1]
    assert "decompress/host_rans_px" in GLOBAL_TIMER.totals()


def test_coded_upload_overflow_uploads_raw(model):
    """A tile past the upload transport's capacity sends the batch raw,
    with the same frames, and counts an overflow."""
    core = CAETurboCore(model, device="cpu")
    tiles = _noise((2, P, P, 3), 13)
    tr = PixelRansTransport("cpu")
    tr.calibrate_from_tiles(np.full((1, P, P, 3), 9, np.uint8))
    assert tr.worthwhile(P * P * 3)
    assert core.encode_tiles(tiles, up_transport=tr) == core.encode_tiles(
        tiles)
    assert tr._overflows == 1
    q, totals = tr.encode_host(tiles, tr.capacity(P * P * 3))
    assert (totals == -1).all()


# -- the pipelines ------------------------------------------------------------


def _chunks(arr):
    return {ij: arr.read_chunk_raw(ij) for ij in arr.chunk_ids()}


@pytest.fixture(scope="module")
def pipes(model):
    """{'cae': (port core, compress, decompress, JAX core, JAX compress),
    'cae_tpu': ...}: the flagship at 1024 streams."""
    jm = jax_from_state_dict(FLAGSHIP)
    return {
        "cae": (CAECodecCore(model, device="cpu"),
                ttiles.compress_pixels_to_cae, ttiles.decompress_cae_array,
                JCore(jm), jtiles.compress_pixels_to_cae),
        "cae_tpu": (CAETurboCore(model, device="cpu"),
                    ttiles.compress_pixels_to_cae_turbo,
                    ttiles.decompress_cae_turbo_array, JTurbo(jm),
                    jtiles.compress_pixels_to_cae_turbo)}


def _fresh(core):
    for attr in ("_up_transport", "_fetch_transport"):
        if hasattr(core, attr):
            delattr(core, attr)
    return core


@pytest.mark.parametrize("kind", ["cae", "cae_tpu"])
def test_coded_upload_pipeline_equals_raw_and_jax(pipes, tmp_path,
                                                  monkeypatch, kind):
    """``CAE_TPU_CODED_UPLOAD=1``: chunks byte-equal to the same pipeline
    without it and to the JAX package's store with it; the upload crosses
    coded (fewer link bytes than the raw tiles)."""
    core, compress, _, jcore, jcompress = pipes[kind]
    img = _smooth_image(2 * P, 3 * P, 3)
    monkeypatch.setenv("CAE_TPU_CODED_UPLOAD", "0")
    raw = compress(_fresh(core), img, str(tmp_path / "raw.zarr"),
                   patch_size=P, batch_tiles=2)
    monkeypatch.setenv("CAE_TPU_CODED_UPLOAD", "1")
    GLOBAL_TIMER.reset()
    coded = compress(core, img, str(tmp_path / "coded.zarr"), patch_size=P,
                     batch_tiles=2)
    h2d = GLOBAL_TIMER.link_bytes()["h2d"]
    tr = core._up_transport
    assert tr.calibrated() and tr.pred_mode == 0
    assert h2d < img.size
    jarr = jcompress(jcore, img, str(tmp_path / "jax.zarr"), patch_size=P,
                     batch_tiles=2)
    assert jcore._up_transport.pred_mode == 0
    np.testing.assert_array_equal(jcore._up_transport.freq, tr.freq)
    assert _chunks(coded) == _chunks(raw) == _chunks(jarr)


@pytest.mark.parametrize("kind,codec,content", [
    ("cae", "rans", "smooth"), ("cae", "pack", "histology"),
    ("cae_tpu", "rans", "histology"), ("cae_tpu", "pack", "smooth")])
def test_coded_fetch_pipeline_equals_raw_fetch(pipes, tmp_path, monkeypatch,
                                               kind, codec, content):
    """``CAE_TPU_PACKED_FETCH=1`` with ``CAE_TPU_FETCH_CODEC`` ``rans`` or
    ``pack``: the decoded image byte-equal to the raw fetch's; the rANS
    fetch calibrates the plane predictor on the reconstructions and codes
    every batch (the copies and the host decode in their own stages)."""
    core, compress, decompress, _, _ = pipes[kind]
    img = (_smooth_image(2 * P, 3 * P, 5) if content == "smooth"
           else synth_histology(2 * P, 3 * P, 2))
    arr = compress(_fresh(core), img, str(tmp_path / "a.zarr"),
                   patch_size=P, batch_tiles=2)
    raw = decompress(arr, core=core, batch_tiles=2)
    monkeypatch.setenv("CAE_TPU_PACKED_FETCH", "1")
    monkeypatch.setenv("CAE_TPU_FETCH_CODEC", codec)
    GLOBAL_TIMER.reset()
    coded = decompress(arr, core=core, batch_tiles=2)
    np.testing.assert_array_equal(coded, raw)
    stages = GLOBAL_TIMER.totals()
    assert "decompress/d2h_pixels" in stages
    if codec == "rans":
        tr = core._fetch_transport
        assert tr.calibrated() and tr.pred_mode == 1
        assert GLOBAL_TIMER._count["decompress/host_rans_px"] == 3
    else:
        assert not hasattr(core, "_fetch_transport")
        assert "decompress/host_unpack_px" in stages


def test_midcall_invalidation_refits(pipes, tmp_path, monkeypatch):
    """A third overflow that drops the fetch table in the middle of a
    decompress refits it from that batch's raw pixels, so later batches go
    coded again; the image equals the raw fetch's."""
    core, compress, decompress, _, _ = pipes["cae"]
    img = _smooth_image(P, 6 * P, 3)
    arr = compress(_fresh(core), img, str(tmp_path / "m.zarr"),
                   patch_size=P, batch_tiles=1)
    raw = decompress(arr, core=core, batch_tiles=1)
    stale = PixelRansTransport("cpu")
    stale.calibrate_from_tiles(np.full((1, P, P, 3), 7, np.uint8))
    stale_bits = stale.bits_per_value
    stale._overflows = 2
    core._fetch_transport = stale
    monkeypatch.setenv("CAE_TPU_PACKED_FETCH", "1")
    np.testing.assert_array_equal(decompress(arr, core=core,
                                             batch_tiles=1), raw)
    assert stale.calibrated() and stale.bits_per_value != stale_bits


def test_roundtrip_with_persisted_transports(model, tmp_path, monkeypatch):
    """Both transports forced on: a core whose transports persist over two
    images gives, on each, the chunks and pixels of the sequential pair on
    another core (``tests/test_roundtrip_pipelined.py:84``)."""
    monkeypatch.setenv("CAE_TPU_PACKED_FETCH", "1")
    monkeypatch.setenv("CAE_TPU_CODED_UPLOAD", "1")
    seq = CAETurboCore(model, device="cpu")
    rt = CAETurboCore(model, device="cpu")
    for i, seed in enumerate((1, 2)):
        img = _smooth_image(2 * P, 2 * P, seed)
        arr = ttiles.compress_pixels_to_cae_turbo(
            seq, img, str(tmp_path / f"seq{i}.zarr"), patch_size=P,
            batch_tiles=1)
        rec = ttiles.decompress_cae_turbo_array(arr, core=seq, batch_tiles=1)
        arr_rt, rec_rt = ttiles.roundtrip_cae_turbo(
            rt, img, str(tmp_path / f"rt{i}.zarr"), patch_size=P,
            batch_tiles=1)
        assert _chunks(arr_rt) == _chunks(arr), f"image {i}"
        np.testing.assert_array_equal(rec_rt, rec)
        for attr in ("_up_transport", "_fetch_transport"):
            np.testing.assert_array_equal(getattr(rt, attr).freq,
                                          getattr(seq, attr).freq)


def test_roundtrip_finishes_when_batch_0_encodes_last(model, tmp_path,
                                                     monkeypatch):
    """Batch 0's encode is held until the five others have encoded (their
    decode jobs would fill the decode pool if they waited for the fetch
    calibration, as the JAX schedule's do): the call finishes within its
    time limit, with the pixels of a raw fetch."""
    monkeypatch.setenv("CAE_TPU_PACKED_FETCH", "1")
    core = CAETurboCore(model, device="cpu")
    img = _smooth_image(P, 6 * P, 4)
    ref = ttiles.decompress_cae_turbo_array(
        ttiles.compress_pixels_to_cae_turbo(
            CAETurboCore(model, device="cpu"), img,
            str(tmp_path / "ref.zarr"), patch_size=P, batch_tiles=1),
        core=CAETurboCore(model, device="cpu"), batch_tiles=1)
    others_done = threading.Semaphore(0)
    encode = core.encode_tiles

    def delayed(tiles, *args, **kw):
        if np.array_equal(tiles[0], img[:, :P]):
            for _ in range(5):
                assert others_done.acquire(timeout=60)
            return encode(tiles, *args, **kw)
        out = encode(tiles, *args, **kw)
        others_done.release()
        return out

    monkeypatch.setattr(core, "encode_tiles", delayed)
    result = {}
    worker = threading.Thread(target=lambda: result.update(
        rec=ttiles.roundtrip_cae_turbo(core, img, str(tmp_path / "rt.zarr"),
                                       patch_size=P, batch_tiles=1)[1]),
        daemon=True)
    t0 = time.monotonic()
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive(), "roundtrip_cae_turbo did not finish"
    assert time.monotonic() - t0 < 120
    assert core._fetch_transport.calibrated()
    np.testing.assert_array_equal(result["rec"], ref)
