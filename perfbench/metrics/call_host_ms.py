"""call_host_ms.replay: mean host time inside ``CompiledModel.__call__``
(copy-in, replay, clones), on the benchmark's clock, without a sync (ms)."""


def read(ctx):
    t = ctx.window.counters.get("call_host_s")
    return 1e3 * sum(t) / len(t) if t else None
