"""idle.replay / idle.served: the share of the profiled calls' interval in
which no operation ran on the device, in %."""


def read(ctx):
    s = ctx.summary
    return None if s is None else 100.0 * s.idle
