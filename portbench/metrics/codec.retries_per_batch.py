"""codec.retries_per_batch: the codec core's capacity retries and host
fallbacks (``CAETurboCore.capacity_retries + host_fallbacks``) in the
traced window, over the batches encoded."""


def read(trace, ctx):
    w = ctx["work"]
    return w["retries"] / w["batches"] if w["batches"] else None
