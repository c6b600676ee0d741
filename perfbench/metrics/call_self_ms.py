"""call_self_ms.replay: the program's own host time in a model call: the
mean, over the ``repro.model.call`` spans that lie inside the profiled
calls' span, of each span's duration less the union of its
``repro.model.{copy_in,replay,copy_out}`` children (ms).  Nothing where
the program records no such span."""
import bisect

from perfbench.tracing import CALLS, merged

CALL = "repro.model.call"
CHILDREN = {"repro.model.copy_in", "repro.model.replay",
            "repro.model.copy_out"}


def self_ms(events) -> float | None:
    spans = [e for e in events if not e.device and e.name == CALLS]
    if not spans:
        return None
    lo, hi = spans[0].start, spans[0].end
    calls = [e for e in events if not e.device and e.name == CALL
             and lo <= e.start and e.end <= hi]
    if not calls:
        return None
    kids = sorted((e.start, e.end) for e in events
                  if not e.device and e.name in CHILDREN)
    starts = [a for a, _ in kids]
    total = 0.0
    for c in calls:
        inside = kids[bisect.bisect_left(starts, c.start):
                      bisect.bisect_right(starts, c.end)]
        covered = sum(b - a for a, b in merged(inside, c.start, c.end))
        total += c.end - c.start - covered
    return 1e3 * total / len(calls)


def read(ctx):
    return None if ctx.events is None else self_ms(ctx.events)
