"""The port from several threads: ``utils.device.full_f32`` keeps the float32
switches off in every open block and restores them once the last block
closes, however the threads interleave; the tile pipeline's worker pool
writes the bytes of a serial run."""

import threading

import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.pipeline import tiles
from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
from cnn_autoencoder_tpu_torch.utils.device import full_f32

from tests.test_torch_turbo import _image, small_checkpoint  # noqa: F401


def _flags():
    matmul = torch.backends.cuda.matmul
    return (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
            matmul.allow_bf16_reduced_precision_reduction)


def _set_flags(flags):
    matmul = torch.backends.cuda.matmul
    (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
     matmul.allow_bf16_reduced_precision_reduction) = flags


@pytest.fixture()
def flags_on():
    """All three switches on (TF32 and reduced-precision sums allowed), and
    the process's own values restored after the test."""
    saved = _flags()
    _set_flags((True, True, True))
    try:
        yield (True, True, True)
    finally:
        _set_flags(saved)


def test_full_f32_across_two_threads(flags_on):
    """Thread A enters, thread B enters, A leaves: B's block must still run
    with the switches off, and after both leave they hold their starting
    values."""
    a_in, b_in, a_out, b_done = (threading.Event() for _ in range(4))
    seen = {}
    errors = []

    def thread_a():
        try:
            with full_f32():
                a_in.set()
                assert b_in.wait(10)
            a_out.set()
        except BaseException as exc:  # noqa: BLE001 (reported below)
            errors.append(exc)

    def thread_b():
        try:
            assert a_in.wait(10)
            with full_f32():
                b_in.set()
                assert a_out.wait(10)
                seen["inside_after_a_left"] = _flags()
            b_done.set()
        except BaseException as exc:  # noqa: BLE001 (reported below)
            errors.append(exc)

    threads = [threading.Thread(target=thread_a),
               threading.Thread(target=thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert not errors, errors
    assert b_done.is_set()
    assert seen["inside_after_a_left"] == (False, False, False)
    assert _flags() == flags_on


def test_full_f32_nests_and_restores(flags_on):
    with full_f32():
        assert _flags() == (False, False, False)
        with full_f32():
            assert _flags() == (False, False, False)
        assert _flags() == (False, False, False)
    assert _flags() == flags_on
    with pytest.raises(KeyError):
        with full_f32():
            raise KeyError("leaves the block")
    assert _flags() == flags_on


def test_many_threads_interleaved(flags_on):
    """Eight threads opening and closing blocks at random: every block sees
    the switches off, and they end at their starting values."""
    bad = []

    def worker(seed):
        rng = np.random.RandomState(seed)
        for _ in range(200):
            with full_f32():
                if _flags() != (False, False, False):
                    bad.append(_flags())
                if rng.rand() < 0.5:
                    with full_f32():
                        if _flags() != (False, False, False):
                            bad.append(_flags())

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not bad
    assert _flags() == flags_on


def test_turbo_pipeline_workers_write_serial_bytes(small_checkpoint,
                                                    tmp_path, monkeypatch):
    """``compress_pixels_to_cae_turbo`` on 4 workers writes the chunks of a
    run on one worker and of ``encode_tiles`` called batch by batch."""
    core = CAETurboCore(autoencoder_from_state_dict(small_checkpoint,
                                                    device="cpu"),
                        num_streams=64, device="cpu")
    img = _image(96, 96, seed=5)
    p = 32

    monkeypatch.setattr(tiles, "FETCH_WORKERS", 4)
    arr4 = tiles.compress_pixels_to_cae_turbo(
        core, img, str(tmp_path / "w4.zarr"), patch_size=p, batch_tiles=1)
    monkeypatch.setattr(tiles, "FETCH_WORKERS", 1)
    arr1 = tiles.compress_pixels_to_cae_turbo(
        core, img, str(tmp_path / "w1.zarr"), patch_size=p, batch_tiles=1)

    got4 = {ij: arr4.read_chunk_raw(ij) for ij in arr4.chunk_ids()}
    got1 = {ij: arr1.read_chunk_raw(ij) for ij in arr1.chunk_ids()}
    assert len(got4) == 9 and got4 == got1
    for (i, j, _), buf in got4.items():
        tile = img[i * p:(i + 1) * p, j * p:(j + 1) * p][None]
        assert core.encode_tiles(tile) == [buf]
