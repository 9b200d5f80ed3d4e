"""The staging of raw pixel copies (``utils/staging.py``): the pinned
pool's reuse and growth through an injected allocator and guards, on the
CPU; the CPU device's unstaged path; and, marked ``card`` (skipped without
a CUDA card), the staged copies and the codec's frames and pixels against
plain ``.to()`` / ``.cpu()`` at 42 tiles of 512², four threads against a
serial run, and the staged-bytes counters.  The card's tests run there
with ``python -m pytest --noconftest -m card tests/test_torch_staging.py``
(this file imports no JAX)."""

import sys
import threading

import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu_torch.utils import staging
from cnn_autoencoder_tpu_torch.utils.profiling import GLOBAL_TIMER
from cnn_autoencoder_tpu_torch.utils.staging import (PinnedPool, to_device,
                                                     to_host)

FLAGSHIP = "benchmarks/bench_flagship.msgpack"


class Guard:
    """A copy's event as the pool sees it: pending until ``done``."""

    def __init__(self, done=False):
        self.done = done
        self.waits = 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waits += 1
        self.done = True


def _pool(limit=8):
    made = []

    def alloc(nbytes):
        made.append(nbytes)
        return torch.empty(nbytes, dtype=torch.uint8)

    return PinnedPool(alloc, limit), made


def test_pool_reuses_a_buffer_only_after_its_guard():
    pool, made = _pool()
    a = pool.take(100)
    guard = Guard()
    pool.give(a, guard)
    b = pool.take(100)
    assert b is not a and made == [100, 100]
    guard.done = True
    pool.give(b)
    assert pool.take(100) is a          # the oldest ready one first
    assert pool.take(100) is b
    assert made == [100, 100] and pool.buffers == 2


def test_pool_grows_to_the_largest_request():
    pool, made = _pool()
    a = pool.take(100)
    pool.give(a)
    c = pool.take(300)                  # a is too small: let go
    assert c.numel() == 300 and made == [100, 300] and pool.buffers == 1
    pool.give(c)
    assert pool.take(50) is c           # no smaller buffer is made again
    d = pool.take(50)                   # c held: a new one, at the largest
    assert d.numel() == 300 and made == [100, 300, 300]
    assert pool.size == 300


def test_pool_at_its_limit_waits_on_the_oldest_guard():
    pool, made = _pool(limit=2)
    a, b = pool.take(10), pool.take(10)
    ga, gb = Guard(), Guard()
    pool.give(a, ga)
    pool.give(b, gb)
    assert pool.take(10) is a
    assert ga.waits == 1 and gb.waits == 0 and made == [10, 10]


def test_pool_past_its_limit_makes_a_buffer_when_all_are_held():
    pool, made = _pool(limit=1)
    a, b = pool.take(10), pool.take(10)
    assert a is not b and made == [10, 10] and pool.buffers == 2


def test_pool_never_hands_one_buffer_to_two_holders():
    """Eight threads take and give back with guards that complete later:
    no buffer is ever held twice at once, or handed out before its guard
    has completed."""
    pool, made = _pool(limit=4)
    held, lock, errors = set(), threading.Lock(), []
    pending = []

    def worker(seed):
        rng = np.random.RandomState(seed)
        for _ in range(300):
            buf = pool.take(int(rng.randint(1, 64)))
            with lock:
                if id(buf) in held:
                    errors.append("held twice")
                if any(g is not None and not g.done and b is buf
                       for b, g in pending):
                    errors.append("handed out before its guard")
                held.add(id(buf))
            guard = Guard() if rng.rand() < 0.5 else None
            with lock:
                held.discard(id(buf))
                pending.append((buf, guard))
                for _, g in pending[:-4]:
                    if g is not None:
                        g.done = True
                del pending[:-8]
            pool.give(buf, guard)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert pool.buffers <= 8 + 4 and all(n <= 63 for n in made)


@pytest.mark.parametrize("shape,dtype", [((3, 5, 7, 3), np.uint8),
                                         ((4, 9), np.int32)])
def test_cpu_device_keeps_the_plain_path(monkeypatch, shape, dtype):
    """On the CPU device nothing is staged: no copy stream or pool is made,
    and the values and the counters are those of ``.to`` / ``.cpu()``."""
    def no_staging(device):
        raise AssertionError("staged on the CPU")

    monkeypatch.setattr(staging, "staging", no_staging)
    x = np.random.RandomState(0).randint(0, 200, size=shape).astype(dtype)
    GLOBAL_TIMER.reset()
    t = to_device(x, "cpu")
    assert t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), x)
    np.testing.assert_array_equal(to_host(t), x)
    link = GLOBAL_TIMER.link_bytes()
    assert link["h2d_staged"] == link["d2h_staged"] == 0


# -- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _tiles(n, side=512, seed=0):
    """``n`` smooth tiles with noise, as a slide's are."""
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32)
    rng = np.random.RandomState(seed)
    out = np.empty((n, side, side, 3), np.uint8)
    for i in range(n):
        a, b = rng.uniform(6, 14, size=2)
        img = (np.sin(yy / a + i) + np.cos(xx / b))[:, :, None] * 55 + 128
        img = img + rng.randn(side, side, 3) * 4
        out[i] = np.clip(img, 0, 255)
    return out


@pytest.fixture(scope="module")
def card_core():
    _card()
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
    return CAETurboCore(autoencoder_from_state_dict(FLAGSHIP, device="cuda"),
                        device="cuda")


@pytest.mark.card
def test_staged_copies_match_plain_on_the_card():
    _card()
    x = _tiles(42)
    GLOBAL_TIMER.reset()
    t = to_device(x, "cuda")
    assert GLOBAL_TIMER.link_bytes()["h2d_staged"] == x.nbytes
    assert torch.equal(t, torch.from_numpy(x).to("cuda"))
    assert to_device(t, "cuda") is t
    assert GLOBAL_TIMER.link_bytes()["h2d_staged"] == x.nbytes
    np.testing.assert_array_equal(to_host(t), x)
    view = t[:, 7:300, 11:200]
    np.testing.assert_array_equal(to_host(view), view.cpu().numpy())
    assert GLOBAL_TIMER.link_bytes()["d2h_staged"] == (
        x.nbytes + view.numel())


@pytest.mark.card
def test_codec_frames_and_pixels_match_plain_on_the_card(card_core):
    """Host tiles (staged) and the same tiles already on the card (plain
    ``.to()``) give byte-identical frames; the staged pixel fetch gives the
    pixels of a plain ``.cpu()``; the staged bytes are the raw link's."""
    from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
    core = card_core
    tiles = _tiles(42, seed=1)
    GLOBAL_TIMER.reset()
    frames = core.encode_tiles(tiles)
    link = GLOBAL_TIMER.link_bytes()
    assert link["h2d_staged"] == link["h2d"] == tiles.nbytes
    GLOBAL_TIMER.reset()
    assert core.encode_tiles(torch.from_numpy(tiles).to("cuda")) == frames
    assert GLOBAL_TIMER.link_bytes()["h2d_staged"] == 0
    GLOBAL_TIMER.reset()
    rec = core.decode_tiles(frames)
    link = GLOBAL_TIMER.link_bytes()
    assert link["d2h_staged"] == link["d2h"] == rec.nbytes
    sym = core.symbols_from_frames(frames, core.num_streams, 512, 512)
    plain = core.base.decode_tiles_device(sym).cpu().numpy()
    np.testing.assert_array_equal(rec, plain)
    np.testing.assert_array_equal(
        CAECodecCore.fetch_pixels(core.base.decode_tiles_device(sym)[
            :, :500, :300]), plain[:, :500, :300])


@pytest.mark.card
def test_four_threads_match_a_serial_run_on_the_card(card_core):
    """Four threads encoding and decoding 24 batches each give exactly the
    frames and pixels of a serial run: no staging buffer is reused before
    its copy has ended."""
    core = card_core
    batches = [_tiles(42, seed=10 + i) for i in range(4)]
    frames = [core.encode_tiles(b) for b in batches]
    pixels = [core.decode_tiles(f) for f in frames]
    errors = []

    def client(i):
        for k in range(24):
            j = (i + k) % len(batches)
            if core.encode_tiles(batches[j]) != frames[j]:
                errors.append(f"client {i} batch {j}: frames differ")
            if not np.array_equal(core.decode_tiles(frames[j]), pixels[j]):
                errors.append(f"client {i} batch {j}: pixels differ")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:4]
