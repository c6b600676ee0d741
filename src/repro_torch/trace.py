"""Named host ranges inside the port, on the profiler's clock.

``span(name)`` is a host range named ``repro.<name>`` while a profiler
is collecting, and one shared null context otherwise.  The ranges are
Kineto events, so they share one clock with the profiler's CUDA device
records.  They are ``torch._C._profiler._RecordFunctionFast`` ranges (the
profiler's ``cpu_op`` category), not ``torch.profiler.record_function``
ones (``user_annotation``): under the profiler a range costs 1.1 µs
against 14.8 µs (x86 host, torch 2.13), and a replayed model call opens
four, with the device idle behind the first.

The gate is the process-wide flag that ``torch.profiler`` sets on start
(``torch.autograd.profiler._is_profiler_enabled``), not the thread-local
``torch._C._autograd._profiler_enabled()``: the serving dispatch worker
reads the latter as False even while a profiler started with
``profile_all_threads=True`` records its ranges.  A range on a thread the
profiler does not record costs its call and records nothing.

Python's collections of generations 1 and 2 are ranges too
(``repro.gc.gen<N>``), opened and closed from a ``gc.callbacks`` hook that
this module installs on import; the hook does nothing while no profiler
is collecting.
"""
from __future__ import annotations

import contextlib
import gc

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro."
_OFF = contextlib.nullcontext()
_Range = torch._C._profiler._RecordFunctionFast
_gc_open = None       # the range of the collection in progress, if any


def span(name: str):
    """A profiler range ``repro.<name>`` while a profiler is collecting;
    the shared null context otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Range(PREFIX + name)


def _on_gc(phase: str, info: dict) -> None:
    # CPython runs one collection at a time, so one open range suffices
    global _gc_open
    if phase == "start":
        if info["generation"] and _profiler._is_profiler_enabled:
            _gc_open = _Range(f"{PREFIX}gc.gen{info['generation']}")
            _gc_open.__enter__()
    elif _gc_open is not None:
        rf, _gc_open = _gc_open, None
        rf.__exit__(None, None, None)


gc.callbacks.append(_on_gc)
