"""The traced run: ``torch.profiler`` over the window, reduced to what the
per-layer readers take (``metrics/*.py``), the device's busy time and the
breakdown the result line carries.

A reader gets a ``Trace``: the device events (kernels and copies) with
their names and times, the host events, the device time spent under each
profiler range of the benchmark's own (``portbench.*``), the calls of the
program's kernel wrappers that ran in the window, and the window's length.

Device time is given to a range through the profiler's own links: each
kernel or copy names the host operation that launched it, and that
operation lies inside the range on the host thread that ran it.  So a
range's device time is the time its launches ran on the device, with no
gap in between, whatever else the device ran meanwhile.  The ranges are
operations of the profiler's own (``range_op``), not annotations: a
kernel launched straight from Python, as the program's wrappers launch
theirs, links to the innermost operation, never to an annotation.

The kernel wrappers are found as the program names them: each CUDA wrapper
of ``ops/kernels`` (a ``*_cuda`` function of its modules) counts its
launches under a kernel name (``ops.kernels.kernel_wrappers``).  In the
traced window ``Probe`` runs every such call under a range of its own and
keeps the kernel name whose counter moved and the shapes of the tensors
the call was given.
"""

import contextlib
import functools
import importlib
import itertools
import pkgutil
import threading
from typing import Dict, List, Tuple

CALL = "portbench.call."
# the profiler's kinds of device activity that occupy the device
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# host activities that are not operations (their ids are the driver's)
NOT_OPS = ("cuda_runtime",)


class Trace:
    """What a traced window left: ``device`` [(name, start_us, end_us)],
    ``host`` [(name, start_us, end_us)], ``spans`` {range name: device
    us}, ``calls`` [(range name, kernel names, shapes)], ``window_s``."""

    def __init__(self, device, host, spans, window_s: float, calls=()):
        self.device = device
        self.host = host
        self.spans = spans
        self.window_s = window_s
        self.calls = list(calls)

    def span_s(self, name: str) -> float:
        """Device seconds under the ranges called ``name``."""
        return self.spans.get(name, 0.0) / 1e6

    def kernel_calls(self, kernel: str) -> List[Tuple[list, float]]:
        """(shapes, device seconds) of each wrapper call of the window that
        launched under the kernel name ``kernel``."""
        return [(shapes, self.span_s(rng)) for rng, names, shapes
                in self.calls if kernel in names]

    def launches(self) -> int:
        """Kernels the device ran (copies and fills not counted)."""
        return sum(1 for e in self.device if not _is_copy(e[0]))

    def busy_s(self) -> float:
        """The union of the device events' intervals."""
        total, end = 0.0, None
        for _, s, e in sorted(self.device, key=lambda v: v[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time and the longest idle
        gaps, each named by the innermost host event running at its
        middle."""
        by_name: Dict[str, float] = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], None
        for _, s, e in sorted(self.device, key=lambda v: v[1]):
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        named = []
        for length, s, e in gaps[:top]:
            mid = (s + e) / 2
            inner = [h for h in self.host if h[1] <= mid <= h[2]]
            who = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                   else "host idle")
            named.append([who[:80], length / 1e6])
        return {"device_ops": [[n[:80], v] for n, v in ops],
                "idle_gaps": named}


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith(("memcpy", "memset")) or "memcpy" in low


def range_op(name: str):
    """A profiler range ``name`` that counts as an operation, so that what
    is launched inside it links to it."""
    from torch._C._profiler import _RecordFunctionFast
    return _RecordFunctionFast(name)


class Spans:
    """A module's calls as a profiler range ``name``: forward pre- and
    post-hooks open and close it on the calling thread."""

    def __init__(self):
        self._local = threading.local()
        self._handles = []

    def attach(self, module, name: str) -> None:
        def pre(_m, _inp):
            rf = range_op(name)
            rf.__enter__()
            self._stack().append(rf)

        def post(_m, _inp, _out):
            self._stack().pop().__exit__(None, None, None)

        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(post)]

    def _stack(self):
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def detach(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


class Probe:
    """Every call of the program's kernel wrappers (public ``*_cuda``
    functions of ``ops/kernels``), while attached, under a profiler range
    ``portbench.call.<n>``; ``calls`` keeps (range, kernel names whose
    launch counters moved, shapes of its tensor arguments) of each call
    that launched.  Calls hold one lock, so a call's counters move by its
    own launches alone; a wrapper that calls another leaves the record to
    the inner one."""

    def __init__(self):
        self.calls: List[Tuple[str, Tuple[str, ...], list]] = []
        self._patched = []
        self._lock = threading.RLock()
        self._local = threading.local()
        self._seq = itertools.count()

    @staticmethod
    def _modules():
        from cnn_autoencoder_tpu_torch.ops import kernels
        for info in pkgutil.iter_modules(kernels.__path__):
            yield importlib.import_module(f"{kernels.__name__}.{info.name}")

    @staticmethod
    def _counts() -> Dict[str, int]:
        from cnn_autoencoder_tpu_torch.ops.kernels import kernel_wrappers
        out: Dict[str, int] = {}
        for w in kernel_wrappers():
            out[w.kernel_name] = out.get(w.kernel_name, 0) + w.launches
        return out

    def attach(self) -> None:
        for mod in self._modules():
            for name, fn in list(vars(mod).items()):
                if (name.endswith("_cuda") and not name.startswith("_")
                        and callable(fn)
                        and getattr(fn, "__module__", None) == mod.__name__):
                    setattr(mod, name, self._wrap(fn))
                    self._patched.append((mod, name, fn))

    def _wrap(self, fn):
        import torch
        probe = self

        @functools.wraps(fn)
        def call(*args, **kwargs):
            rng = f"{CALL}{next(probe._seq)}"
            with probe._lock, range_op(rng):
                depth = getattr(probe._local, "records", 0)
                before = probe._counts()
                out = fn(*args, **kwargs)
                after = probe._counts()
                moved = tuple(k for k, v in after.items()
                              if v != before.get(k, 0))
                if moved and getattr(probe._local, "records", 0) == depth:
                    shapes = [tuple(a.shape) for a in
                              list(args) + list(kwargs.values())
                              if torch.is_tensor(a)]
                    probe.calls.append((rng, moved, shapes))
                    probe._local.records = depth + 1
            return out
        return call

    def detach(self) -> None:
        for mod, name, fn in reversed(self._patched):
            wrapped = getattr(mod, name)
            # the wrapper's body counted its launches on the module's name
            if hasattr(wrapped, "launches"):
                fn.launches = wrapped.launches
            setattr(mod, name, fn)
        self._patched = []


@contextlib.contextmanager
def profiled(out: List[Trace], probe: Probe):
    """Profile the block; append its ``Trace`` to ``out``.  The caller
    synchronizes the device before the block ends."""
    import time

    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    # every host thread: the codec's clients are threads
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=acts, experimental_config=every_thread) as prof:
        t0 = time.perf_counter()
        yield
        window = time.perf_counter() - t0
    out.append(reduce(prof.profiler.kineto_results.events(), window,
                      probe.calls))


def _kind(e) -> str:
    """The profiler's kind of an event, from its device, its annotation
    flag and its name: ``kernel``, ``gpu_memcpy``, ``gpu_memset``,
    ``gpu_user_annotation``, ``cuda_runtime``, ``user_annotation`` or
    ``cpu_op``."""
    name = e.name()
    note = e.is_user_annotation()
    if str(e.device_type()).endswith("CUDA"):
        if note or name.startswith("portbench."):
            return "gpu_user_annotation"
        low = name.lower()
        if low.startswith("memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if low.startswith("memset") else "kernel"
    if name.startswith("cuda") or (name[:2] == "cu" and name[2:3].isupper()):
        return "cuda_runtime"
    return "user_annotation" if note else "cpu_op"


def reduce(events, window_s: float, calls=()) -> Trace:
    """The profiler's events (``_KinetoEvent``-like) as a ``Trace``."""
    device, host, ops, linked = [], [], [], []
    for e in events:
        kind = _kind(e)
        if kind.startswith("gpu_user") or kind in NOT_OPS:
            continue
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if kind in DEVICE_KINDS:
            device.append((e.name(), start, end))
            linked.append(e.linked_correlation_id())
        else:
            host.append((e.name(), start, end))
            ops.append((e.start_thread_id(), start, end, e.correlation_id(),
                        e.name()))
    return Trace(device, host, _span_device_us(ops, device, linked),
                 window_s, calls)


def _span_device_us(ops, device, linked) -> Dict[str, float]:
    """{range name: device us} for the ``portbench.`` ranges among the host
    ``ops`` [(thread, start, end, id, name)]: each device event counts
    under every range that holds the operation it links to."""
    within: Dict[int, Tuple[str, ...]] = {}
    by_thread: Dict[int, list] = {}
    for op in ops:
        by_thread.setdefault(op[0], []).append(op)
    for evs in by_thread.values():
        evs.sort(key=lambda o: (o[1], -o[2]))
        stack: List[Tuple[float, Tuple[str, ...]]] = []
        for _, start, end, ident, name in evs:
            while stack and stack[-1][0] <= start:
                stack.pop()
            held = stack[-1][1] if stack else ()
            if name.startswith("portbench."):
                held = held + (name,)
            if held:
                within[ident] = held
            stack.append((end, held))
    spans: Dict[str, float] = {}
    for (_, s, e), ident in zip(device, linked):
        for name in within.get(ident, ()):
            spans[name] = spans.get(name, 0.0) + (e - s)
    return spans

