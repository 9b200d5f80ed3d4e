"""The port's host rANS coder (``coding/rans.py`` over ``coding/csrc/
rans.cpp``) against the JAX package's ``coding.rans`` and the port's plain
``_rans_py``, on the CPU: byte-identical streams (escapes, empty and
one-symbol streams, int32 extremes), batch equal to single, decode round
trips, truncated and garbage streams decoded in bounds, and a build that
several processes start at once."""

import os
import subprocess
import sys

import numpy as np
import pytest

from cnn_autoencoder_tpu.coding import rans as jrans
from cnn_autoencoder_tpu_torch.coding import _rans_py
from cnn_autoencoder_tpu_torch.coding import rans
from cnn_autoencoder_tpu_torch.models.entropy import update_cdf_tables
from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint

FLAGSHIP = "benchmarks/bench_flagship.msgpack"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tables():
    params = load_checkpoint(FLAGSHIP)["fact_ent"]["params"]
    t = update_cdf_tables(params, (3, 3, 3, 3))
    return t["quantized_cdf"], t["cdf_length"], t["offset"]


def _symbols(tables, n, seed, escapes=0):
    """Seeded in-table symbols over the flagship's 48 channels (channel
    i % 48), with ``escapes`` of them pushed below their table's offset
    and past its end, some to the int32 extremes."""
    _, cdf_length, offset = tables
    rng = np.random.RandomState(seed)
    idx = (np.arange(n) % 48).astype(np.int32)
    sym = (offset[idx] + rng.randint(0, 1 << 30, n)
           % (cdf_length[idx] - 2)).astype(np.int32)
    if escapes:
        at = rng.choice(n, escapes, replace=False)
        far = [-(2 ** 31), 2 ** 31 - 1, -40000, 70000]
        for k, i in enumerate(at):
            lo, hi = offset[idx[i]], offset[idx[i]] + cdf_length[idx[i]] - 2
            sym[i] = (far[k] if k < len(far) else
                      lo - 1 - rng.randint(0, 300) if k % 2 else
                      hi + rng.randint(0, 3000))
    return sym, idx


CASES = {"seeded": (3000, 0), "escapes": (3000, 40), "empty": (0, 0),
         "one": (1, 0), "one_escape": (1, 1), "extremes": (8, 4)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_streams_match_jax_and_plain(tables, case):
    n, esc = CASES[case]
    sym, idx = _symbols(tables, n, seed=len(case), escapes=esc)
    cdf, cdf_length, offset = tables
    got = rans.encode_with_indexes(sym, idx, cdf, cdf_length, offset)
    assert got == jrans.encode_with_indexes(sym, idx, cdf, cdf_length,
                                            offset)
    assert got == _rans_py.encode_with_indexes(
        sym.tolist(), idx.tolist(), cdf.tolist(), cdf_length.tolist(),
        offset.tolist())
    np.testing.assert_array_equal(
        rans.decode_with_indexes(got, idx, cdf, cdf_length, offset), sym)
    np.testing.assert_array_equal(
        jrans.decode_with_indexes(got, idx, cdf, cdf_length, offset), sym)
    np.testing.assert_array_equal(
        _rans_py.decode_with_indexes(got, idx.tolist(), cdf.tolist(),
                                     cdf_length.tolist(), offset.tolist()),
        sym)


@pytest.mark.parametrize("batch", [1, 4, 7])
def test_batch_equals_single(tables, batch):
    """The batched entries (4-way interleaved groups, the rest one by one)
    write each tile's single stream and decode it back."""
    cdf, cdf_length, offset = tables
    n = 48 * 25
    sym = np.stack([_symbols(tables, n, seed=b, escapes=3 * (b % 2))[0]
                    for b in range(batch)])
    idx = (np.arange(n) % 48).astype(np.int32)
    streams = rans.encode_batch(sym, idx, cdf, cdf_length, offset)
    assert streams == [rans.encode_with_indexes(s, idx, cdf, cdf_length,
                                                offset) for s in sym]
    assert streams == jrans.encode_batch(sym, idx, cdf, cdf_length, offset)
    np.testing.assert_array_equal(
        rans.decode_batch(streams, idx, cdf, cdf_length, offset), sym)
    assert rans.decode_batch([], idx, cdf, cdf_length, offset).shape == \
        (0, n)


def test_truncated_and_garbage_streams_decode_in_bounds(tables):
    """A cut, empty or random stream decodes to garbage symbols of the
    right shape, never crashing, and to what the JAX package's coder
    decodes from it (the same bounds-checked reads)."""
    cdf, cdf_length, offset = tables
    sym, idx = _symbols(tables, 2000, seed=5, escapes=20)
    good = rans.encode_with_indexes(sym, idx, cdf, cdf_length, offset)
    rng = np.random.RandomState(6)
    bad = [good[:k] for k in (0, 3, 4, 7, 8, 9, len(good) // 2,
                              len(good) - 1)]
    bad += [rng.bytes(k) for k in (1, 8, 64, 4096)]
    bad.append(b"\xff" * 256)
    for buf in bad:
        out = rans.decode_with_indexes(buf, idx, cdf, cdf_length, offset)
        assert out.shape == sym.shape and out.dtype == np.int32
        np.testing.assert_array_equal(
            out, jrans.decode_with_indexes(buf, idx, cdf, cdf_length,
                                           offset))
    out = rans.decode_batch(bad, idx, cdf, cdf_length, offset)
    assert out.shape == (len(bad), sym.size)


def test_num_threads():
    assert rans.num_threads() >= 1


_BUILD_CHILD = r"""
import sys
from pathlib import Path
import numpy as np
from cnn_autoencoder_tpu_torch.coding import rans
rans.BUILD_ROOT = Path(sys.argv[1])
lib = rans.load_library()
cdf = np.array([[0, 30000, 60000, 65536]], np.uint32)
sym = np.array([0, 1, 5, -3, 0], np.int32)
idx = np.zeros(5, np.int32)
buf = rans.encode_with_indexes(sym, idx, cdf, [4], [0])
assert (rans.decode_with_indexes(buf, idx, cdf, [4], [0]) == sym).all()
print("built" if rans.build_seconds > 0 else "loaded")
"""


def test_concurrent_build_gives_one_library(tmp_path):
    """Processes that start at once on an empty build directory get one
    working library: one of them compiles, the others wait on the lock and
    load its result; no temporary file is left."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD,
                               str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    said = sorted(o.strip() for o, _ in outs)
    assert said == ["built", "loaded", "loaded", "loaded"], said
    (build_dir,) = tmp_path.iterdir()
    assert sorted(f.name for f in build_dir.iterdir()) == \
        ["librans.so", "lock"]


def test_failed_build_raises(tmp_path, monkeypatch):
    """Without a working compiler the binding raises with the compiler's
    message; nothing falls back to the Python coder."""
    monkeypatch.setattr(rans, "_lib", None)
    monkeypatch.setattr(rans, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(rans, "COMMANDS", (["g++", "-DNO_SUCH",
                                            "-fno-such-flag"],))
    with pytest.raises(RuntimeError, match="build failed"):
        rans.load_library()
    monkeypatch.setattr(rans, "COMMANDS", (["no-such-compiler-xyz"],))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        rans.load_library()
