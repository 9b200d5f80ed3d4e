"""K5_roofline: the rANS decode (kernel name ``rans_decode``) for the
batches of the traced window: each batch's words in and int32 symbols out
(``roofline.k5``), over the device time of its calls, in %."""

from portbench import readers, roofline


def read(trace, ctx):
    w = ctx["work"]
    if not w["batches"]:
        return None
    cfg = readers.model(ctx)
    t, b = ctx["params"]["tile"], ctx["params"]["batch"]
    side = t >> cfg["compression_level"]
    n = b * cfg["channels_bn"] * side * side
    payload = w["payload_bytes"] / w["batches"]
    return readers.work_share(trace, ("rans_decode",), w["batches"],
                              roofline.bound_s(*roofline.k5(n, payload)))
