"""fetch_ms.decode: host ms a batch inside the codec's
``decompress/d2h_pixels`` stage (the pixels' copy to the host), summed
over the client threads, in the traced window.  Wall time: the copy waits
there for the batch's synthesis and for the other clients' work on the
stream."""

from portbench import spans


def read(trace, ctx):
    return spans.host_ms(trace, "decompress/d2h_pixels",
                         ctx["work"]["batches"])
