"""frame_ms.encode: host ms a batch inside the codec's ``compress/frame``
stage (frame assembly on the host), summed over the client threads, in the
traced window.  Wall time: waits for the interpreter lock count."""

from portbench import spans


def read(trace, ctx):
    return spans.host_ms(trace, "compress/frame", ctx["work"]["batches"])
