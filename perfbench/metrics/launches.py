"""launches.replay / .served: device kernels, copies and fills per
inference or request in the profiled sub-window."""


def read(ctx):
    s = ctx.summary
    return None if s is None else s.launches / s.units
