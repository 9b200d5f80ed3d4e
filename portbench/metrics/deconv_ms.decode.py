"""deconv_ms.decode: device time a batch of the kernels and copies that the
decoder's transposed convolutions launched in the traced window (the range
``portbench.deconv`` that ``traffic/decode.py:trace_spans`` opens around
each call, its launches linked by the profiler), in ms."""


def read(trace, ctx):
    batches = ctx["work"]["batches"]
    ms = 1e3 * trace.span_s("portbench.deconv")
    return ms / batches if batches and ms > 0 else None
