"""The readers of the program's model-call spans on synthetic event
lists: ``call_self_ms`` (a call's host time outside its copy-in, replay
and copy-out, overlapping children counted once, only calls inside the
profiled calls' span) and ``entry_idle_ms`` (the part of the device's
idle gaps that lies inside any model call, however deeply nested the host
event that covers it), and both finding nothing where the program records
no such span."""
import types

import pytest

from perfbench import harness
from perfbench.tracing import CALLS, Event, summarize

METRICS = harness.PERF / "metrics"
call_self = harness.load_module(METRICS / "call_self_ms.py")
entry_idle = harness.load_module(METRICS / "entry_idle_ms.py")


def _host(name, a, b):
    return Event(name, a, b, False)


def _dev(name, a, b):
    return Event(name, a, b, True)


def _ctx(events, units=2):
    return types.SimpleNamespace(events=events,
                                 summary=summarize(events, units))


def test_self_time_counts_overlapping_children_once():
    events = [
        _host(CALLS, 0, 100),
        _host("repro.model.call", 10, 30),
        _host("repro.model.copy_in", 11, 14),
        _host("repro.model.replay", 13, 20),      # overlaps copy_in
        _host("repro.model.copy_out", 22, 25),
        _host("aten::clone", 22, 24),             # not a child: ignored
        _host("repro.model.call", 40, 50),
        _host("repro.model.replay", 41, 49),
    ]
    # (20 - 9 - 3) and (10 - 8): 8 and 2 ms-units, mean 5, in ms x 1e3
    assert call_self.self_ms(events) == pytest.approx(5e3)
    assert call_self.read(_ctx(events + [_dev("k", 41, 42)])) == \
        pytest.approx(5e3)


def test_self_time_takes_only_calls_inside_the_calls_span():
    events = [
        _host(CALLS, 10, 60),
        _host("repro.model.call", 0, 12),         # starts before the span
        _host("repro.model.call", 20, 30),
        _host("repro.model.replay", 21, 29),
        _host("repro.model.call", 55, 70),        # ends after it
    ]
    assert call_self.self_ms(events) == pytest.approx(2e3)


def test_idle_counts_whatever_host_event_is_innermost_in_the_call():
    events = [
        _host(CALLS, 0, 20),
        _host("repro.model.call", 1, 9),
        _host("repro.model.replay", 2, 8),
        _host("cudaGraphLaunch", 3, 5),           # innermost over a gap
        _host("perfbench.sync", 9, 12),
        _dev("copy", 0, 3), _dev("gemm", 5, 10), _dev("spdmm", 14, 20),
    ]
    # gaps [3, 5] (inside the call) and [10, 14] (outside it)
    s = summarize(events, 2)
    assert s.idle_gaps == [["no host span", 4.0], ["cudaGraphLaunch", 2.0]]
    assert entry_idle.read(_ctx(events)) == pytest.approx(1e3)


def test_idle_counts_only_the_part_of_a_gap_inside_a_call():
    events = [
        _host(CALLS, 0, 30),
        _host("perfbench.model_entry.call", 2, 12),
        _host("repro.model.call", 4, 11),
        _host("repro.model.copy_in", 5, 6),
        _host("repro.model.call", 16, 20),
        _host("repro.model.call", 19, 22),        # overlaps: counted once
        _dev("k", 0, 1), _dev("copy", 7, 15), _dev("k", 21, 30),
    ]
    # gaps [1, 7] and [15, 21]: 3 of the first lies in [4, 11], 5 of the
    # second in [16, 22]; over 2 inferences
    assert entry_idle.idle_ms(events, 2) == pytest.approx(4e3)
    assert entry_idle.idle_ms(events[:2] + events[-3:], 2) is None


@pytest.mark.parametrize("events", [
    [_host(CALLS, 0, 10), _host("perfbench.model_entry.call", 1, 9),
     _dev("k", 2, 3)],                            # the program has no span
    [_host("repro.model.call", 1, 9), _dev("k", 2, 3)],   # no calls span
])
def test_nothing_to_read_without_the_spans(events):
    assert call_self.self_ms(events) is None
    assert entry_idle.idle_ms(events, 1) is None
    assert call_self.read(_ctx(events)) is None
    assert entry_idle.read(_ctx(events)) is None


def test_nothing_to_read_untraced_or_without_device_records():
    untraced = types.SimpleNamespace(events=None, summary=None)
    assert call_self.read(untraced) is None
    assert entry_idle.read(untraced) is None
    host_only = [_host(CALLS, 0, 10), _host("repro.model.call", 1, 9)]
    assert entry_idle.read(_ctx(host_only)) is None
    assert call_self.read(_ctx(host_only)) == pytest.approx(8e3)
