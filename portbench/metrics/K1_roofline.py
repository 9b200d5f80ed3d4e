"""K1_roofline.<cell kind>: the GDN kernel (kernel name ``gdn_fwd``): the
bound of GDN or IGDN over the rows each call of the traced window was given
(``roofline.k1``), over those calls' device time, in %."""

from portbench import readers, roofline


def read(trace, ctx):
    return readers.call_share(
        trace, "gdn_fwd", lambda shapes: roofline.bound_s(
            *roofline.k1(*shapes[0])))
