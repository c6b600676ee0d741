"""latency_p95_ms.served: the 95th percentile of every request's latency,
from when it was due to its logits ready (ms).  Above the server's
capacity the queue grows through the window, so it swings with the
smallest change: a per-layer reading, not a gate."""


def read(ctx):
    return ctx.window.p95_ms() if ctx.unit == "request" else None
