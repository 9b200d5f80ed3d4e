"""The readers of the program's stages (``spans.py``, ``metrics/*``) on a
hand-built ``Trace``: host ms a unit over every thread's ranges, idle time
under a stage where ranges overlap and where the device is busy, nothing to
read where the stage is absent, and each metric on its own reader."""

import os

import pytest

from portbench import run, spans
from portbench.trace import Trace

CTX = {"work": {"batches": 4, "steps": 2}}
NEW = {"upload_ms.encode": "upload_ms.encode.py",
       "fetch_ms.encode": "fetch_ms.encode.py",
       "frame_ms.encode": "frame_ms.encode.py",
       "idle_frame.encode": "idle_frame.py",
       "parse_ms.decode": "parse_ms.decode.py",
       "fetch_ms.decode": "fetch_ms.decode.py",
       "idle_parse.decode": "idle_parse.py",
       "optimizer_ms.train.flagship": "optimizer_ms.train.py",
       "optimizer_ms.train.residual": "optimizer_ms.train.py",
       "idle_optimizer.train.flagship": "idle_optimizer.py",
       "idle_optimizer.train.residual": "idle_optimizer.py"}


def _trace():
    """Device busy on [0, 100], [300, 400], [400, 500] and [900, 1000] us:
    gaps [100, 300] and [500, 900].  Two client threads' frames overlap
    in [150, 250] and [600, 700]; one frame lies on busy time."""
    device = [("k", 0.0, 100.0), ("Memcpy HtoD", 300.0, 400.0),
              ("k", 400.0, 500.0), ("k", 900.0, 1000.0)]
    host = [("portbench.encode_tiles", 0.0, 1000.0),
            ("compress/frame", 50.0, 250.0),     # thread 1: 150 us idle
            ("compress/frame", 150.0, 280.0),    # thread 2: 30 us more
            ("compress/frame", 320.0, 480.0),    # on busy time: none
            ("compress/frame", 600.0, 700.0),    # 100 us
            ("compress/frame", 650.0, 760.0),    # 60 us more
            ("compress/upload", 0.0, 300.0),
            ("compress/upload", 100.0, 200.0),
            ("train/optimizer", 480.0, 560.0)]   # 60 us
    return Trace(device, host, {}, 2e-3)


def _read(name, trace, ctx=CTX):
    return run.read_metric(name, trace, ctx)


def test_host_ms_sums_every_thread():
    t = _trace()
    # 200 + 130 + 160 + 100 + 110 us over 4 batches
    assert spans.host_ms(t, "compress/frame", 4) == pytest.approx(0.175)
    assert _read("frame_ms.encode", t) == pytest.approx(0.175)
    assert _read("upload_ms.encode", t) == pytest.approx(0.1)
    assert _read("optimizer_ms.train.flagship", t) == pytest.approx(0.04)


def test_idle_under_a_stage_counts_each_instant_once():
    t = _trace()
    assert spans.idle_gaps(t) == [(100.0, 300.0), (500.0, 900.0)]
    # (150 + 30) + (100 + 60) us of a 2 ms window
    assert spans.idle_share(t, "compress/frame") == pytest.approx(17.0)
    assert _read("idle_frame.encode", t) == pytest.approx(17.0)
    assert _read("idle_optimizer.train.residual", t) == pytest.approx(3.0)


def test_a_stage_on_busy_time_reads_no_idle():
    t = Trace([("k", 0.0, 100.0), ("k", 90.0, 400.0), ("k", 500.0, 600.0)],
              [("decompress/parse", 10.0, 390.0)], {}, 1e-3)
    assert spans.idle_share(t, "decompress/parse") == 0.0
    assert _read("idle_parse.decode", t) == 0.0


def test_absent_stage_reads_nothing():
    t = _trace()
    for name in ("fetch_ms.encode", "parse_ms.decode", "fetch_ms.decode",
                 "idle_parse.decode"):
        assert _read(name, t) is None, name
    assert spans.host_ms(t, "compress/frame", 0) is None
    assert spans.idle_share(Trace([], t.host, {}, 1e-3),
                            "compress/frame") is None


def test_each_new_metric_has_its_own_reader():
    for name, reader in NEW.items():
        assert run.reader_path(name) == os.path.join(
            run.HERE, "metrics", reader), name
