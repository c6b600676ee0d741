"""The traced sub-window: ``torch.profiler`` around a steady stretch of a
cell's traffic, and the arithmetic that turns its events into busy time,
the idle share, launches and the breakdown.

The profiled calls sit between two idle edges (``EDGE_S`` of host sleep
with the device synchronized): a window that opened right on a replay
lost the replay's first kernel records now and then, one with edges did
not (the port's ``scripts/profile_replay_misses.py``).  Busy and idle are
taken over the calls' own interval, the benchmark's ``CALLS`` span, and
not over the edges.

The arithmetic works on plain :class:`Event` lists, so it is tested
without a card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import time
from collections import defaultdict

EDGE_S = 0.05
SPAN_PREFIX = "perfbench."
CALLS = SPAN_PREFIX + "calls"
TOP = 10


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    start: float          # seconds, one time base for host and device
    end: float
    device: bool          # ran on the device (kernel, copy, fill)


@dataclasses.dataclass
class Summary:
    """What one traced sub-window measured."""
    window_s: float       # the calls' interval
    busy_s: float         # union of device operations inside it
    launches: int         # device operations that started inside it
    units: int            # inferences or requests completed inside it
    device_ops: list      # [[name, seconds]], most time first
    idle_gaps: list       # [[host span or op, seconds]], longest first

    @property
    def idle(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, as sorted
    disjoint segments."""
    out: list[list[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(segments, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of ``[lo, hi]`` that ``segments`` (sorted, disjoint) leave
    uncovered."""
    out, at = [], lo
    for a, b in segments:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def innermost(host: list[Event], points: list[float]) -> list[str]:
    """For each of ``points`` (sorted), the name of the shortest host event
    that contains it, or ``"no host span"``."""
    order = sorted(host, key=lambda e: e.start)
    heap: list[tuple[float, float, str]] = []
    out, i = [], 0
    for p in points:
        while i < len(order) and order[i].start <= p:
            e = order[i]
            heapq.heappush(heap, (e.end - e.start, e.end, e.name))
            i += 1
        while heap and heap[0][1] <= p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "no host span")
    return out


def top(totals: dict) -> list:
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:TOP]]


def summarize(events: list[Event], units: int) -> Summary | None:
    """Busy time, launches and the breakdown over the ``CALLS`` span of
    ``events``; None where the span or any device operation is missing."""
    spans = [e for e in events if not e.device and e.name == CALLS]
    dev = [e for e in events if e.device]
    if not spans or not dev or units <= 0:
        return None
    lo, hi = spans[0].start, spans[0].end
    busy = merged(((e.start, e.end) for e in dev), lo, hi)
    ops: dict = defaultdict(float)
    for e in dev:
        d = min(e.end, hi) - max(e.start, lo)
        if d > 0:
            ops[e.name] += d
    idle = gaps(busy, lo, hi)
    labels = innermost([e for e in events if not e.device and e.name != CALLS],
                       [(a + b) / 2 for a, b in idle])
    by_host: dict = defaultdict(float)
    for (a, b), name in zip(idle, labels):
        by_host[name] += b - a
    return Summary(window_s=hi - lo, busy_s=sum(b - a for a, b in busy),
                   launches=sum(1 for e in dev if lo <= e.start < hi),
                   units=units, device_ops=top(ops), idle_gaps=top(by_host))


def kineto_events(prof) -> list[Event]:
    """The raw events of a finished ``torch.profiler.profile``: every host
    operation and range, and every device kernel, copy and fill (the
    device-side copies of the host's annotations left out)."""
    from torch.autograd import DeviceType

    out = []
    for k in prof.profiler.kineto_results.events():
        device = k.device_type() == DeviceType.CUDA
        if device and k.is_user_annotation():
            continue
        out.append(Event(k.name(), k.start_ns() * 1e-9, k.end_ns() * 1e-9,
                         device))
    return out


def span(name: str, on: bool):
    """A profiler range ``perfbench.<name>`` around a call into a layer of
    the program, while tracing; nothing otherwise."""
    if not on:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(SPAN_PREFIX + name)


def profiled(run, sync) -> list[Event]:
    """``run()`` inside ``CALLS`` under ``torch.profiler``, with the device
    synchronized and ``EDGE_S`` of idle host time on either side."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        time.sleep(EDGE_S)
        with torch.profiler.record_function(CALLS):
            run()
            sync()
        time.sleep(EDGE_S)
    return kineto_events(prof)
