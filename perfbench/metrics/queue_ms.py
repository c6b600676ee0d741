"""queue_ms.served: mean ``RequestStats.t_queue`` of the window's requests,
the program's own enqueue-to-dispatch time (ms)."""


def read(ctx):
    t = ctx.window.counters.get("queue_s")
    return 1e3 * sum(t) / len(t) if t else None
