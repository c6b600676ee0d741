"""requests_per_s: requests completed inside the window over the
window."""


def read(ctx):
    w = ctx.window
    if ctx.unit != "request" or not w.in_window:
        return None
    return w.in_window / w.seconds
