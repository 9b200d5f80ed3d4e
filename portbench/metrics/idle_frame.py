"""idle_frame.<cell kind>: the share of the traced window, in %, in which
no kernel or copy ran on the device and some thread was inside the codec's
``compress/frame`` stage (the device's idle gaps, as the breakdown finds
them, against the union of the stage's ranges on every thread)."""

from portbench import spans


def read(trace, ctx):
    return spans.idle_share(trace, "compress/frame")
