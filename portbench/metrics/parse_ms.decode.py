"""parse_ms.decode: host ms a batch inside the codec's ``decompress/parse``
stage (headers, grouping, the payload checks and the host word queues),
summed over the client threads, in the traced window.  Wall time: waits
for the interpreter lock count."""

from portbench import spans


def read(trace, ctx):
    return spans.host_ms(trace, "decompress/parse", ctx["work"]["batches"])
