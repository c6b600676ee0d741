"""peak_gib.replay / .served: ``torch.cuda.max_memory_allocated`` over the
measured window (GiB)."""


def read(ctx):
    b = ctx.window_peak_bytes
    return None if b is None else b / 2**30
