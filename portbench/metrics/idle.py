"""idle.<cell kind>: the share of the traced window in which no kernel or
copy ran on the device, in %."""

from portbench import readers


def read(trace, ctx):
    return readers.idle(trace)
