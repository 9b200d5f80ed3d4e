"""mfu.encode: the analysis transform's operations (``roofline.py``) of
every tile encoded in the traced window, over the window and the TF32 peak,
in %."""

from portbench import readers, roofline


def read(trace, ctx):
    t = ctx["params"]["tile"]
    return readers.mfu(trace, ctx["work"]["tiles"] * roofline.encode_flops(
        readers.model(ctx), t, t))
