"""What the readers of the program's own stages share.  The program times
its stages in ``utils/profiling.py:GLOBAL_TIMER``, and while a profiler
records each stage is a range of its name (``compress/frame``,
``train/optimizer``, ...) on the thread that ran it.  So the stages are
among a ``Trace``'s host events, on the clock of its device events.

Host time inside a stage is wall time: it holds the stage's own work and
whatever it waited for, the stream or the interpreter lock.  A program
without the stage leaves nothing to read, and the readers return None.
"""

from typing import List, Optional, Tuple

from .trace import Trace


def intervals(trace: Trace, name: str) -> List[Tuple[float, float]]:
    """(start us, end us) of every host event called ``name``, on any
    thread."""
    return [(s, e) for n, s, e in trace.host if n == name]


def host_ms(trace: Trace, name: str, units: int) -> Optional[float]:
    """Host ms inside the stage ``name``, summed over its events on every
    thread, over ``units`` (the window's batches or steps)."""
    ivs = intervals(trace, name)
    if not ivs or not units:
        return None
    return sum(e - s for s, e in ivs) / 1e3 / units


def _union(ivs):
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The gaps between device events, as ``Trace.breakdown`` finds them:
    from the end of everything that ran before to the next start."""
    gaps, end = [], None
    for _, s, e in sorted(trace.device, key=lambda v: v[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def idle_share(trace: Trace, name: str) -> Optional[float]:
    """The share of the window, in %, in which no device event ran and
    some thread was inside the stage ``name``."""
    spans = _union(intervals(trace, name))
    if not spans or not trace.device:
        return None
    us, i = 0.0, 0
    for gs, ge in idle_gaps(trace):
        while i < len(spans) and spans[i][1] <= gs:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < ge:
            us += min(ge, spans[j][1]) - max(gs, spans[j][0])
            j += 1
    return 100.0 * us / 1e6 / trace.window_s
