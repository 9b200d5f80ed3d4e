"""idle_optimizer.<cell kind>: the share of the traced window, in %, in
which no kernel or copy ran on the device and the train step was inside
its ``train/optimizer`` stage (as ``idle_frame.py`` reads
``compress/frame``)."""

from portbench import spans


def read(trace, ctx):
    return spans.idle_share(trace, "train/optimizer")
