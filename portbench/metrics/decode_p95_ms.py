"""decode_p95_ms: the 95th percentile, over every request of the traced
window, of the time from a request's submission to its pixels on the
host, in ms (a failed request counts as infinite).  Host clock, profiler
on.  A closed loop runs at the capacity of the system, where a tail swings
with the clients' share of the interpreter and the stream; so it is a
layer's metric here, and the rate is the end-to-end one."""


def read(trace, ctx):
    return ctx["work"]["p95_ms"]
