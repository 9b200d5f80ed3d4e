"""idle_parse.<cell kind>: the share of the traced window, in %, in which
no kernel or copy ran on the device and some thread was inside the codec's
``decompress/parse`` stage (as ``idle_frame.py`` reads
``compress/frame``)."""

from portbench import spans


def read(trace, ctx):
    return spans.idle_share(trace, "decompress/parse")
