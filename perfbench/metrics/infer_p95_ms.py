"""infer_p95_ms: the 95th percentile of every inference's latency in the
window, call to logits synchronized (ms)."""


def read(ctx):
    return ctx.window.p95_ms() if ctx.unit == "infer" else None
