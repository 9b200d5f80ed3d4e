"""mfu.decode: the synthesis's operations (``roofline.py``) of every tile
decoded in the traced window, over the window and the TF32 peak, in %."""

from portbench import readers, roofline


def read(trace, ctx):
    t = ctx["params"]["tile"]
    return readers.mfu(trace, ctx["work"]["tiles"] * roofline.decode_flops(
        readers.model(ctx), t, t))
