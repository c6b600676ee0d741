"""The traced sub-window's arithmetic on synthetic event lists: busy time
as the union of device operations inside the calls' span, idle share,
launches, the top device operations and the idle gaps by host span."""
import pytest

from perfbench.tracing import CALLS, Event, gaps, innermost, merged, summarize


def _dev(name, a, b):
    return Event(name, a, b, True)


def _host(name, a, b):
    return Event(name, a, b, False)


def test_merged_and_gaps():
    segs = merged([(1, 3), (2, 4), (6, 7), (0, 0.5), (9, 12)], 0.25, 10)
    assert segs == [(0.25, 0.5), (1, 4), (6, 7), (9, 10)]
    assert gaps(segs, 0.25, 10) == [(0.5, 1), (4, 6), (7, 9)]
    assert gaps([], 0, 2) == [(0, 2)]


def test_innermost_takes_the_shortest_enclosing_host_event():
    host = [_host("outer", 0, 10), _host("mid", 2, 6), _host("in", 3, 4)]
    assert innermost(host, [1, 3.5, 5, 8, 11]) == [
        "outer", "in", "mid", "outer", "no host span"]


def test_summarize_busy_idle_launches_and_breakdown():
    events = [
        _host(CALLS, 10, 20),
        _host("perfbench.model_entry.call", 10, 11.5),
        _host("cudaGraphLaunch", 14.5, 15.5),
        _dev("gemm", 9, 11),          # starts before the span: clipped
        _dev("spdmm", 11, 12),
        _dev("copy", 11.5, 13),       # overlaps spdmm: counted once
        _dev("gemm", 16, 18),
        _dev("late", 21, 22),         # after the span: out
    ]
    s = summarize(events, units=2)
    # busy [10, 13] + [16, 18] = 5 of 10
    assert s.window_s == 10 and s.busy_s == 5 and s.idle == 0.5
    assert s.launches == 3          # spdmm, copy, gemm at 16
    assert s.device_ops == [["gemm", 3.0], ["copy", 1.5], ["spdmm", 1.0]]
    # gaps [13, 16] (its midpoint 14.5 inside the launch) and [18, 20]
    assert s.idle_gaps == [["cudaGraphLaunch", 3.0], ["no host span", 2.0]]


@pytest.mark.parametrize("events", [
    [_dev("gemm", 0, 1)],                       # no calls span
    [_host(CALLS, 0, 1), _host("x", 0, 1)],     # no device operation
])
def test_summarize_finds_nothing_to_read(events):
    assert summarize(events, units=3) is None


def test_summarize_needs_units():
    assert summarize([_host(CALLS, 0, 1), _dev("k", 0, 1)], units=0) is None
