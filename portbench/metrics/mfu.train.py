"""mfu.train: a training image's operations (``roofline.py``: forward and
backward of convolutions, transposed convolutions and GDN pools) times the
images of the traced window, over the window and the TF32 peak, in %."""

from portbench import readers, roofline


def read(trace, ctx):
    p = ctx["params"]["patch"]
    return readers.mfu(trace, ctx["work"]["images"] * roofline.train_flops(
        readers.model(ctx), p, p))
