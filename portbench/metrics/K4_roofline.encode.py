"""K4_roofline.encode: the fused conv+GDN kernel's serving variant (kernel
name ``conv_gdn_fwd``): the bound of each call of the traced window at the
shapes it was given (``roofline.k4``), over those calls' device time, in
%."""

from portbench import readers, roofline


def bound(shapes):
    (b, h, w, cin), kernel = shapes[0], shapes[1]
    return roofline.bound_s(*roofline.k4(b, h, w, cin, kernel[3]))


def read(trace, ctx):
    return readers.call_share(trace, "conv_gdn_fwd", bound)
