"""entry_idle_ms.replay: device idle while the host is inside the
program's model call: the part of the profiled calls' idle gaps (as
``idle`` finds them) that lies inside the union of the
``repro.model.call`` spans, over the sub-window's inferences (ms).
Nothing where the program records no such span or the device none of its
operations."""
from perfbench.tracing import CALLS, gaps, merged

CALL = "repro.model.call"


def idle_ms(events, units: int) -> float | None:
    spans = [e for e in events if not e.device and e.name == CALLS]
    if not spans or units <= 0:
        return None
    lo, hi = spans[0].start, spans[0].end
    calls = merged(((e.start, e.end) for e in events
                    if not e.device and e.name == CALL), lo, hi)
    if not calls:
        return None
    idle = gaps(merged(((e.start, e.end) for e in events if e.device),
                       lo, hi), lo, hi)
    total, j = 0.0, 0
    for a, b in calls:                  # both lists sorted and disjoint
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < b:
            total += min(b, idle[k][1]) - max(a, idle[k][0])
            k += 1
    return 1e3 * total / units


def read(ctx):
    s = ctx.summary
    return None if s is None else idle_ms(ctx.events, s.units)
