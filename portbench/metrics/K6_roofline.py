"""K6_roofline: the rANS encode (kernel names ``rans_encode_states`` and
``rans_compact``: the state pass with its count, and the compaction) for
the batches of the traced window: each batch's int32 symbols in and its
frames' words out, once (``roofline.k6``), over the device time of every
call, a capacity retry's included, in %."""

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
    return readers.work_share(trace, ("rans_encode_states", "rans_compact"),
                              w["batches"],
                              roofline.bound_s(*roofline.k6(n, payload)))
