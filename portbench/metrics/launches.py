"""launches.<cell kind>: kernels the device ran a step in the traced window
(copies and fills not counted), from the profiler."""


def read(trace, ctx):
    steps = ctx["work"]["steps"]
    return trace.launches() / steps if steps else None
