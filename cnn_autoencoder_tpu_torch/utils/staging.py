"""Raw host <-> device copies through page-locked staging buffers, on a copy
stream of the device.

``to_device``: a host numpy array bound for a CUDA device is copied into a
reused page-locked buffer, then sent by DMA on the device's copy stream; the
caller's current stream waits on that copy's event before it reads the
result.  ``to_host``: a CUDA tensor is sent by DMA on the copy stream, once
the caller's current stream has run its work up to the call, into such a
buffer; the calling thread waits on that copy alone and copies the values
out into an array of its own, so no page-locked memory outlives the call.
Either way the copy neither holds back the kernels that other threads queue
on the current stream nor waits behind the ones queued after it, and it
runs at the link's DMA rate instead of through CUDA's pageable bounce
buffer.  Everything else (a tensor going to a device, a CPU device) moves
by ``.to`` / ``.cpu()``.  The values are the same either way.

The host copies are numpy's, which release the interpreter lock and run on
the calling thread.  Torch's ``copy_`` spreads a copy over its intra-op
threads, and client threads copying at once then contend for them: a 33 MB
copy-out took 0.47 ms alone and 23.8 ms four at once, numpy's 3.0 and
5.0 ms (an H100 machine's 8-core host).

Each CUDA device has one copy stream, made on first use, and one
``PinnedPool`` a direction.  ``GLOBAL_TIMER`` counts the bytes staged as
``h2d_staged`` and ``d2h_staged``.
"""

import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from .profiling import GLOBAL_TIMER


def _pinned(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class PinnedPool:
    """Reused page-locked host buffers of one device and direction.

    ``take(nbytes)`` hands out an idle buffer whose guard has completed,
    else a new one; ``give(buf, guard)`` takes it back with the guard of
    its last copy (a CUDA event; None when no copy is pending), and it is
    not handed out again before that guard has completed.  Buffers are made
    at the largest size asked for so far, and an idle one smaller than that
    is let go when it is next found ready, so the pool grows to the largest
    batch it has seen.  Once the pool holds ``limit`` buffers, a ``take``
    that finds none ready waits on the oldest pending guard rather than
    making another.  ``alloc(nbytes)`` makes a buffer, a one-dimensional
    uint8 tensor: page-locked memory by default."""

    def __init__(self, alloc=_pinned, limit: int = 8):
        self._alloc = alloc
        self._limit = limit
        self._lock = threading.Lock()
        self._idle: List[Tuple[torch.Tensor, object]] = []  # oldest first
        self.buffers = 0   # buffers made and not let go
        self.size = 0      # the largest request so far, in bytes

    def take(self, nbytes: int) -> torch.Tensor:
        while True:
            with self._lock:
                self.size = max(self.size, nbytes)
                i = 0
                while i < len(self._idle):
                    buf, guard = self._idle[i]
                    if guard is not None and not guard.query():
                        i += 1
                        continue
                    del self._idle[i]
                    if buf.numel() >= self.size:
                        return buf
                    self.buffers -= 1          # outgrown: let it go
                if self.buffers < self._limit or not self._idle:
                    self.buffers += 1
                    size = self.size
                    break
                pending = self._idle[0][1]
            pending.synchronize()
        return self._alloc(size)

    def give(self, buf: torch.Tensor, guard=None) -> None:
        with self._lock:
            self._idle.append((buf, guard))


class _DeviceStaging:
    """A CUDA device's copy stream and its two pools."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device=device)
        self.up = PinnedPool()
        self.down = PinnedPool()


_STAGING: Dict[torch.device, _DeviceStaging] = {}
_STAGING_LOCK = threading.Lock()


def staging(device) -> _DeviceStaging:
    """The copy stream and pools of a CUDA ``device``, made on first use."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _STAGING_LOCK:
        st = _STAGING.get(device)
        if st is None:
            st = _STAGING[device] = _DeviceStaging(device)
        return st


def to_device(x, device) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) on ``device``: staged when ``x`` is
    a host numpy array and ``device`` a CUDA device, else by ``.to``."""
    device = torch.device(device)
    if torch.is_tensor(x):
        return x.to(device)
    if device.type != "cuda":
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    st = staging(device)
    buf = st.up.take(x.nbytes)
    host = buf[:x.nbytes].numpy().view(x.dtype).reshape(x.shape)
    np.copyto(host, x)
    src = torch.from_numpy(host)
    with torch.cuda.stream(st.stream):
        # made on the copy stream and recorded for the caller's stream
        # below: the allocator hands its block out again only after the
        # caller's work on it, and the DMA waits for no kernel
        out = torch.empty_like(src, device=device)
        out.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    st.up.give(buf, done)
    compute = torch.cuda.current_stream(device)
    compute.wait_event(done)
    out.record_stream(compute)
    GLOBAL_TIMER.add_link_bytes("h2d_staged", x.nbytes)
    return out


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host numpy array of their own: staged from a
    CUDA device (a view that is not contiguous is made contiguous there
    first), else by ``.cpu()``."""
    if t.device.type != "cuda":
        return t.cpu().numpy()
    t = t.contiguous()
    st = staging(t.device)
    st.stream.wait_stream(torch.cuda.current_stream(t.device))
    nbytes = t.numel() * t.element_size()
    buf = st.down.take(nbytes)
    staged = buf[:nbytes].view(t.dtype).view(t.shape)
    with torch.cuda.stream(st.stream):
        staged.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    # t stays referenced until the copy is done, so its block is not
    # handed out while the copy stream reads it
    done.synchronize()
    out = staged.numpy().copy()
    st.down.give(buf)
    GLOBAL_TIMER.add_link_bytes("d2h_staged", nbytes)
    return out
