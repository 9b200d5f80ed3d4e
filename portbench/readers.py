"""What the per-layer readers (``metrics/<name>.py``) share: each reader is
``read(trace, ctx) -> float or None`` over the traced window's ``Trace``
(``trace.py``) and ``ctx``: the cell's ``config`` and ``params`` and the
``work`` its traffic counted in the window.  A reader that finds nothing
to read returns None, and the metric is left out of the line.

A kernel's calls are those the program's wrappers launched under its
kernel name in the window, with the shapes they were given; the readers
add nothing of the program's routing to them.
"""

from typing import Callable, Iterable, Optional

from . import roofline
from .trace import Trace


def idle(trace: Trace) -> Optional[float]:
    """The device's idle share of the window, in %."""
    if not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def mfu(trace: Trace, flops: float) -> Optional[float]:
    """``flops`` of work done in the window over the window and the TF32
    peak, in %."""
    if flops <= 0:
        return None
    return roofline.share(flops / roofline.PEAK_FLOPS["float32"],
                          trace.window_s)


def model(ctx):
    return ctx["config"]["model"]


def call_share(trace: Trace, kernel: str,
               bound: Callable[[list], float]) -> Optional[float]:
    """A kernel's roofline share: the sum over the window's calls under
    the kernel name ``kernel`` of ``bound(shapes of the call)``, over the
    device time of those calls, in %."""
    calls = trace.kernel_calls(kernel)
    time_s = sum(t for _, t in calls)
    if not calls or time_s <= 0:
        return None
    return roofline.share(sum(bound(shapes) for shapes, _ in calls), time_s)


def work_share(trace: Trace, kernels: Iterable[str], units: int,
               unit_bound_s: float) -> Optional[float]:
    """A share for work counted by the traffic: ``units`` of work of
    ``unit_bound_s`` each, over the device time of every call under the
    kernel names ``kernels``, in %."""
    time_s = sum(t for k in kernels for _, t in trace.kernel_calls(k))
    if not units or time_s <= 0:
        return None
    return roofline.share(units * unit_bound_s, time_s)
