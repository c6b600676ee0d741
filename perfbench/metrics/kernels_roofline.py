"""kernels_roofline.replay / .served: the least time the card could take
for the model's operations (the count's sum of max(FLOPs / peak, bytes /
bandwidth)) per inference or request, over the device's busy time per
inference or request in the profiled sub-window, in %."""


def read(ctx):
    s = ctx.summary
    if s is None or s.busy_s <= 0:
        return None
    return 100.0 * ctx.bound_s * s.units / s.busy_s
