"""batch_size.served: real requests per dispatched batch in the window
(the program's ``RequestStats`` and batch count)."""


def read(ctx):
    return ctx.window.counters.get("batch_size")
