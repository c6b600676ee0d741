"""infer_ms: the whole window over the inferences completed in it (ms)."""


def read(ctx):
    w = ctx.window
    if ctx.unit != "infer" or not w.completed:
        return None
    return 1e3 * w.seconds / w.completed
