"""Stage timing for the tile pipeline, the codec cores and the train step,
and the device trace.

The port's copy of ``StageTimer``, ``GLOBAL_TIMER`` and ``trace`` from the
JAX package's ``utils/profiling.py``, with the stage names the pipeline
records (``pipeline/tiles.py``): ``compress/read``,
``compress/h2d+dispatch``, ``compress/d2h_sym``, ``compress/rans``,
``compress/write``, ``compress/turbo_encode``, ``decompress/fetch_total``,
``decompress/stitch``, ``decompress/rans``, ``decompress/h2d+dispatch`` and
``decompress/turbo_decode``; the pixel transport's
``compress/host_rans_up``, ``compress/host_rans_px``,
``decompress/d2h_pixels``, ``decompress/host_rans_px`` and
``decompress/host_unpack_px``; the turbo core's
(``storage/turbo_codec.py``) ``compress/upload``, ``compress/analysis``,
``compress/rans_states``, ``compress/fetch_words``, ``compress/frame``,
``compress/host_fallback``, ``decompress/parse``,
``decompress/upload_words``, ``decompress/symbols`` and
``decompress/synthesis``; and the train step's (``training/loop.py``)
``train/forward``, ``train/loss``, ``train/backward`` and
``train/optimizer``.  The link bytes each way are counted where the codec
cores copy (``h2d``, ``d2h``), and, of those, the bytes that went through
the staging buffers (``h2d_staged``, ``d2h_staged``: ``utils/staging.py``).

While a ``torch.profiler`` session records, every stage is also a profiler
range of its name, on the thread that runs it and on the trace's clock;
otherwise a stage opens no range.  ``trace`` runs ``torch.profiler``
around a block where the JAX package runs ``jax.profiler``.
"""

import collections
import contextlib
import os
import threading
import time
from typing import Dict, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as autograd_profiler


LINK_DIRECTIONS = {"d2h": 0, "h2d": 0, "d2h_staged": 0, "h2d_staged": 0}


def profiler_range(name: str):
    """A profiler range ``name``: an operation of the profiler's own, so
    what the block launches links to it."""
    return _RecordFunctionFast(name)


class StageTimer:
    """Thread-safe named stage accumulators."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._units: Dict[str, float] = {}
        self._link_bytes: Dict[str, int] = dict(LINK_DIRECTIONS)
        # bounded per stage: totals and counts stay O(#names), intervals are
        # O(#calls), so a long-lived serving process keeps only the last ones
        self._intervals: Dict[str, collections.deque] = {}

    @contextlib.contextmanager
    def stage(self, name: str, units: float = 0.0):
        """Time a block; ``units`` adds throughput accounting (e.g. MB/MP).
        While a profiler records, the block is also its range ``name``."""
        rng = (profiler_range(name)
               if autograd_profiler._is_profiler_enabled else None)
        if rng is not None:
            rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rng is not None:
                rng.__exit__(None, None, None)
            with self._lock:
                self._total[name] = self._total.get(name, 0.0) + (t1 - t0)
                self._count[name] = self._count.get(name, 0) + 1
                self._units[name] = self._units.get(name, 0.0) + units
                iv = self._intervals.get(name)
                if iv is None:
                    iv = self._intervals[name] = collections.deque(
                        maxlen=8192)
                iv.append((t0, t1))

    def busy_fraction(self, substrings, t_start: float, t_end: float):
        """Fraction of [t_start, t_end) covered by the union of recorded
        stage intervals whose name contains any of ``substrings`` (stages
        overlap on worker threads, so summed durations overcount)."""
        with self._lock:
            ivs = [iv for name, lst in self._intervals.items()
                   if any(s in name for s in substrings)
                   for iv in lst]
        ivs = [(max(a, t_start), min(b, t_end)) for a, b in ivs
               if b > t_start and a < t_end]
        if not ivs or t_end <= t_start:
            return 0.0
        ivs.sort()
        busy = 0.0
        cur_a, cur_b = ivs[0]
        for a, b in ivs[1:]:
            if a > cur_b:
                busy += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        busy += cur_b - cur_a
        return busy / (t_end - t_start)

    def report(self) -> str:
        with self._lock:
            parts = []
            for name in sorted(self._total):
                t = self._total[name]
                n = self._count[name]
                u = self._units[name]
                s = f"{name}: {t:.3f}s/{n}x"
                if u > 0 and t > 0:
                    s += f" ({u / t:.1f} u/s)"
                parts.append(s)
        return " | ".join(parts)

    def totals(self) -> Dict[str, float]:
        """{stage: seconds} snapshot."""
        with self._lock:
            return dict(self._total)

    def add_link_bytes(self, direction: str, nbytes: int):
        """Account bytes shipped over the host<->device link
        (``direction``: 'd2h' or 'h2d', or 'd2h_staged' / 'h2d_staged' for
        the part of them that went through staging buffers)."""
        with self._lock:
            self._link_bytes[direction] = (
                self._link_bytes.get(direction, 0) + int(nbytes))

    def link_bytes(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._link_bytes)

    def reset(self):
        with self._lock:
            self._total.clear()
            self._count.clear()
            self._units.clear()
            self._link_bytes = dict(LINK_DIRECTIONS)
            self._intervals.clear()


# process-global timer the tile pipeline records into
GLOBAL_TIMER = StageTimer()


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block (host operations, and the
    card's kernels and copies where there is a card) when ``trace_dir`` or
    ``CAE_TPU_TRACE`` names a directory: one ``*.pt.trace.json`` file
    there, which TensorBoard's profiler plugin and Perfetto load.  Without a
    directory the block runs untraced."""
    trace_dir = trace_dir or os.environ.get("CAE_TPU_TRACE")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
