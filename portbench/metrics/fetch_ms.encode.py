"""fetch_ms.encode: host ms a batch inside the codec's
``compress/fetch_words`` stage (each compaction tried and its blocking
copy of the words to the host), summed over the client threads, in the
traced window.  Wall time: the copy waits there for the batch's analysis
and for the other clients' work on the stream."""

from portbench import spans


def read(trace, ctx):
    return spans.host_ms(trace, "compress/fetch_words",
                         ctx["work"]["batches"])
