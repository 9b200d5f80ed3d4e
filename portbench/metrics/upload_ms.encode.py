"""upload_ms.encode: host ms a batch inside the codec's ``compress/upload``
stage (the tiles' copy to the device), summed over the client threads, in
the traced window.  Wall time: a pageable copy waits there for the work
already on the stream."""

from portbench import spans


def read(trace, ctx):
    return spans.host_ms(trace, "compress/upload", ctx["work"]["batches"])
