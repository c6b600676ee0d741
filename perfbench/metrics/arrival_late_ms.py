"""arrival_late_ms.served: how late the open-loop generator ran: the most
any arrival of the window was submitted after it was due (ms), a stall of
the event loop that every later request pays."""


def read(ctx):
    late = ctx.window.counters.get("late_s")
    return 1e3 * max(late) if late else None
