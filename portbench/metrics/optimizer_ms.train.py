"""optimizer_ms.train: host ms a step inside the train step's
``train/optimizer`` stage (clipping, Adam and the parameters' update,
dispatched slot by slot), in the traced window.  Wall time: a launch that
finds the device's queue full waits there."""

from portbench import spans


def read(trace, ctx):
    return spans.host_ms(trace, "train/optimizer", ctx["work"]["steps"])
