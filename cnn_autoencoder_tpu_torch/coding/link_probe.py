"""Cached host<->device link probes that gate the coded pixel transports.

The port's copy of the JAX package's ``coding/link_probe.py``.  The coded
transports (``coding/pixel_rans.py``, ``coding/pixel_pack.py``) trade host
CPU and device work for link bytes, so they pay off only when the link, not
compute, bounds the pipeline.  The probes time one direction each with a
fresh payload, the result is cached for a minute, and the transport gates
read it.

Threshold: with raw bytes N, coded bytes f*N and a host codec half at rate
R, the pipelined steady state is max(wire, host) a batch, so coding wins
iff N/bw > max(f*N/bw, N/R), that is iff bw < R.  The defaults sit under
one host thread's C++ codec rates (the fused decode, then the encode, in
MB of pixel channels a second); faster links ship raw.

Switches, as in the JAX package:

* CAE_TPU_PACKED_FETCH = auto|0|1: code the device-to-host pixel fetch
  (decompress);
* CAE_TPU_CODED_UPLOAD = auto|0|1: code the host-to-device pixel upload
  (compress);
* CAE_TPU_PACKED_THRESHOLD_MBPS: the slow-link cutoff of both directions.

``auto`` (the default) probes a CUDA device's link and is off on a CPU
device, which has no link to save.  The probes time pageable copies of
float32 payloads, as the pipeline's copies are.  An upload lands by a
reduction on the device and a synchronize, never by a copy back, which
would queue behind the other direction's transfer.
"""

import contextlib
import os
import threading
import time

import numpy as np
import torch

from ..utils.device import resolve_device

_PROBE_TTL_S = 60.0
_PROBE_MB = 4
_DEFAULT_MBPS = {"d2h": 190.0, "h2d": 160.0}

_cache = {"t": 0.0, "d2h": float("inf"), "h2d": float("inf")}


def _threshold(direction: str) -> float:
    env = os.environ.get("CAE_TPU_PACKED_THRESHOLD_MBPS")
    return float(env) if env else _DEFAULT_MBPS[direction]


def _payload(mb: int, dev: torch.device, seed: float) -> torch.Tensor:
    """A float32 payload of ``mb`` MB computed on ``dev``."""
    n = mb * 1024 * 1024 // 4
    d = torch.arange(n, dtype=torch.float32, device=dev) + seed
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return d


def probe_link_mbps(force: bool = False, mb: int = _PROBE_MB, device=None):
    """(d2h MB/s, h2d MB/s) of ``device``'s link (``None``: the card),
    cached for a minute.  ``mb`` sizes the payload: the gates use a small
    one, a benchmark a bigger one for a steadier figure."""
    now = time.monotonic()
    if not force and now - _cache["t"] < _PROBE_TTL_S:
        return _cache["d2h"], _cache["h2d"]
    dev = resolve_device(device)
    d = _payload(mb, dev, now % 97.0)
    t0 = time.perf_counter()
    h = d.to("cpu", copy=True).numpy()
    d2h = mb / max(1e-9, time.perf_counter() - t0)
    src = torch.from_numpy(h + 1.0)
    t0 = time.perf_counter()
    up = src.to(dev, copy=True)
    up.sum()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    h2d = mb / max(1e-9, time.perf_counter() - t0)
    _cache.update(t=now, d2h=d2h, h2d=h2d)
    return d2h, h2d


def probe_link_duplex_mbps(mb: int = 8, device=None):
    """Both directions at once: (d2h MB/s, h2d MB/s).

    Two threads start at a barrier, one fetching ``mb`` MB to the host, one
    uploading ``mb`` MB; each direction's rate is returned.  Against
    ``probe_link_mbps``'s solo rates, ratios near 1 each way mean a
    full-duplex link (an overlapped round trip approaches the larger
    direction's wall), lower ones a shared budget.  On a CUDA device each
    direction runs on a stream of its own and waits only for that stream,
    so neither direction's timing includes the other's transfer.  Not
    cached.  A caller that picks an overlapped schedule from measured runs
    compares runs of one image size and one probe band (the JAX package's
    bench compares the best of each over all its runs)."""
    dev = resolve_device(device)
    src = _payload(mb, dev, time.monotonic() % 89.0)
    host = torch.from_numpy(np.arange(src.numel(), dtype=np.float32)
                            + np.float32(time.monotonic() % 83.0))
    cuda = dev.type == "cuda"
    streams = ({k: torch.cuda.Stream(dev) for k in ("d2h", "h2d")}
               if cuda else {})
    barrier = threading.Barrier(2)
    out, errors = {}, []

    def run(direction, copy):
        ctx = (torch.cuda.stream(streams[direction]) if cuda
               else contextlib.nullcontext())
        try:
            with ctx:
                barrier.wait()
                t0 = time.perf_counter()
                copy()
                if cuda:
                    streams[direction].synchronize()
                out[direction] = mb / max(1e-9, time.perf_counter() - t0)
        except Exception as exc:  # raised below, after both threads end
            errors.append(exc)
            barrier.abort()

    threads = [
        threading.Thread(target=run, args=(
            "d2h", lambda: src.to("cpu", copy=True))),
        threading.Thread(target=run, args=(
            "h2d", lambda: host.to(dev, copy=True).sum()))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out["d2h"], out["h2d"]


def _gated(env: str, direction: str, device) -> bool:
    mode = os.environ.get(env, "auto")
    if mode in ("0", "1"):
        return mode == "1"
    if resolve_device(device).type != "cuda":
        return False  # no link to save
    d2h, h2d = probe_link_mbps(device=device)
    return (d2h if direction == "d2h" else h2d) < _threshold(direction)


def coded_fetch_enabled(device=None) -> bool:
    """Whether decompress paths code the pixel fetch from ``device``."""
    return _gated("CAE_TPU_PACKED_FETCH", "d2h", device)


def coded_upload_enabled(device=None) -> bool:
    """Whether compress paths code the pixel upload to ``device``."""
    return _gated("CAE_TPU_CODED_UPLOAD", "h2d", device)
