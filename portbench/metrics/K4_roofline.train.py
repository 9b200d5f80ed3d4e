"""K4_roofline.train: the fused conv+GDN kernel's training variant, which
keeps the conv's output y for the backward (kernel name
``conv_gdn_train_fwd``): the bound of each call of the traced window at the
shapes it was given (``roofline.k4`` with ``want_y``), over those calls'
device time, in %."""

from portbench import readers, roofline


def bound(shapes):
    (b, h, w, cin), kernel = shapes[0], shapes[1]
    return roofline.bound_s(*roofline.k4(b, h, w, cin, kernel[3], True))


def read(trace, ctx):
    return readers.call_share(trace, "conv_gdn_train_fwd", bound)
