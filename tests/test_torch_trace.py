"""The port's spans (``repro_torch.trace``): off, ``span`` is one shared
null context and nothing calls the profiler; under ``torch.profiler`` the
compiled model's call, the serving worker's batch and Python's
collections of generations 1 and 2 are ranges, nested where the work
nests and on the thread that ran it; ``gnn_serve --trace`` writes a Chrome
trace and the spans' summary.  The card case checks that the ranges and
the device's records share one clock.  This file imports no JAX::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_trace.py
"""
import concurrent.futures
import gc
import json
import sys
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.core import DynasparseEngine, SparseCOO
from repro_torch.launch import gnn_serve
from repro_torch.models import gnn
from repro_torch.serving import (ServingConfig, ServingEngine,
                                 SharedPlanCache)

CPU = torch.device("cpu")


def _graph(dev, n=80, nnz=240, seed=5):
    rng = np.random.default_rng(seed)
    flat = np.sort(rng.choice(n * n, size=nnz, replace=False))
    return SparseCOO((n, n),
                     torch.as_tensor((flat // n).astype(np.int32), device=dev),
                     torch.as_tensor((flat % n).astype(np.int32), device=dev),
                     torch.as_tensor(np.abs(rng.normal(size=nnz))
                                     .astype(np.float32), device=dev),
                     tag="adjacency")


def _feats(i, n=80, d=12, density=0.3):
    rng = np.random.default_rng(100 + i)
    h = rng.normal(size=(n, d)) * (rng.uniform(size=(n, d)) < density)
    return h.astype(np.float32)


def _compiled(dev, n=80, nnz=240, d=12, tiles=(16, 8)):
    adj = _graph(dev, n, nnz)
    params = gnn.init_params("GCN", d, 8, 5, device=dev)
    eng = DynasparseEngine(tile_m=tiles[0], tile_n=tiles[1], literal=True,
                           device=dev)
    h = torch.as_tensor(_feats(0, n, d), device=dev)
    _, cm = gnn.compile_model("GCN", eng, adj, h, params)
    assert cm is not None
    return cm, h


def _spans(prof, prefix=trace.PREFIX):
    """``[(name, thread, start_ns, end_ns)]`` of the host ranges named
    ``prefix...``, in start order."""
    return sorted(((k.name(), k.start_thread_id(), k.start_ns(), k.end_ns())
                   for k in prof.profiler.kineto_results.events()
                   if k.device_type() == DeviceType.CPU
                   and k.name().startswith(prefix)), key=lambda s: s[2])


def _inside(inner, outer):
    return (inner[1] == outer[1] and outer[2] <= inner[2]
            and inner[3] <= outer[3])


@pytest.fixture
def record_calls(monkeypatch):
    """Every range ``repro_torch.trace`` opens from here on."""
    opened = []
    real = trace._Range

    def rec(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(trace, "_Range", rec)
    return opened


def test_off_span_is_the_shared_null_context_and_calls_nothing(
        record_calls):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("a") is trace.span("b")
    cm, h = _compiled(CPU)
    cm(h)
    cm(h)
    gc.collect(2)
    assert record_calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        cm(h)
    assert record_calls == ["repro.model.call", "repro.model.replay"]


def test_each_model_call_is_one_range_around_its_replay():
    cm, h = _compiled(CPU)
    cm(h)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            cm(h)
    spans = _spans(prof, "repro.model.")
    calls = [s for s in spans if s[0] == "repro.model.call"]
    replays = [s for s in spans if s[0] == "repro.model.replay"]
    assert len(calls) == len(replays) == 3
    assert all(_inside(r, c) for r, c in zip(replays, calls))
    # the CPU runs the body uncaptured: no copy in or out
    assert {s[0] for s in spans} == {"repro.model.call",
                                     "repro.model.replay"}


def test_served_batches_are_ranges_on_the_dispatch_worker():
    eng = DynasparseEngine(tile_m=16, tile_n=8, literal=True,
                           cache=SharedPlanCache(device=CPU), device=CPU)
    srv = ServingEngine("GCN", gnn.init_params("GCN", 12, 8, 5, device=CPU),
                        engine=eng, config=ServingConfig(max_batch=4))
    srv.register_graph("g", _graph(CPU))
    with srv, gnn_serve.profiler(CPU) as prof:
        with torch.profiler.record_function("test.main"):
            srv.serve(("g", _feats(i)) for i in range(10))
    assert srv.stats.batches == 3 and srv.stats.compiled_batches == 2
    spans = _spans(prof)
    main = _spans(prof, "test.main")[0][1]
    batches = [s for s in spans if s[0] == "repro.serving.batch"]
    assert len(batches) == srv.stats.batches
    assert len({s[1] for s in batches}) == 1 and batches[0][1] != main

    def within(name):
        """For each batch, the ranges called ``name`` nested in it."""
        return [[s for s in spans if s[0] == name and _inside(s, b)]
                for b in batches]
    assert all(len(x) == 1 for x in within("repro.serving.stack"))
    assert all(len(x) == 1 for x in within("repro.serving.split"))
    assert [len(x) for x in within("repro.serving.compile")] == [1, 0, 0]
    assert [len(x) for x in within("repro.model.call")] == [0, 1, 1]
    assert [len(x) for x in within("repro.serving.drift")] == [0, 1, 1]
    assert not any(s[0] == "repro.serving.eager" for s in spans)
    for s in spans:
        if not s[0].startswith("repro.gc."):
            assert any(_inside(s, b) for b in batches), s


@pytest.mark.parametrize("generation", [1, 2])
def test_collections_are_ranges_under_the_profiler(generation):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.collect(0)
        gc.collect(generation)
    names = {s[0] for s in _spans(prof, "repro.gc.")}
    assert f"repro.gc.gen{generation}" in names
    assert "repro.gc.gen0" not in names


def test_span_summary_self_time_and_threads():
    ev = [
        {"ph": "X", "name": "repro.serving.batch", "tid": 7, "ts": 0,
         "dur": 100},
        {"ph": "X", "name": "repro.serving.stack", "tid": 7, "ts": 5,
         "dur": 10},
        {"ph": "X", "name": "repro.model.call", "tid": 7, "ts": 20,
         "dur": 50},
        {"ph": "X", "name": "repro.model.replay", "tid": 7, "ts": 30,
         "dur": 30},
        {"ph": "X", "name": "repro.model.call", "tid": 1, "ts": 40,
         "dur": 20},                   # another thread: not a child
        {"ph": "X", "name": "aten::copy_", "tid": 7, "ts": 31, "dur": 2},
        {"ph": "M", "name": "thread_name", "tid": 7},
    ]
    s = gnn_serve.span_summary(ev, {7: "serving-dispatch_0"})
    assert s["repro.serving.batch"] == {
        "count": 1, "total_ms": 0.1, "self_ms": pytest.approx(0.04),
        "threads": ["serving-dispatch_0"]}
    assert s["repro.model.call"]["count"] == 2
    assert s["repro.model.call"]["self_ms"] == pytest.approx(0.04)
    assert s["repro.model.call"]["threads"] == ["1", "serving-dispatch_0"]
    assert s["repro.model.replay"]["self_ms"] == pytest.approx(0.03)
    assert set(s) == {"repro.serving.batch", "repro.serving.stack",
                      "repro.model.call", "repro.model.replay"}


def test_gnn_serve_trace_writes_the_trace_and_the_summary(
        tmp_path, monkeypatch, capsys):
    path = tmp_path / "serve.json"
    monkeypatch.setattr(sys, "argv", [
        "gnn_serve", "--dataset", "CO", "--scale", "0.05", "--literal",
        "--device", "cpu", "--requests", "8", "--max-batch", "4",
        "--trace", str(path)])
    gnn_serve.main()
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("[gnn_serve] {")][-1]
    stats = json.loads(line.split(" ", 1)[1])
    spans = stats["spans"]
    assert spans["repro.serving.batch"]["count"] == stats["batches"] == 2
    assert spans["repro.serving.batch"]["threads"] == ["serving-dispatch_0"]
    assert spans["repro.model.call"]["count"] == stats["compiled_batches"]
    for s in spans.values():
        assert 0 <= s["self_ms"] <= s["total_ms"] + 1e-9
    events = json.loads(path.read_text())["traceEvents"]
    assert sum(e.get("name") == "repro.serving.batch" for e in events) == 2


@pytest.mark.gpu
def test_spans_and_device_records_share_one_clock():
    """A compiled GCN replayed on a worker thread, synchronized and idle
    between calls: each call's device operations start after the range
    that launched them began (the copy-in, the graph's own operations, the
    clones) and end before the next call began, and every model range
    sits on the worker thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda", torch.cuda.current_device())
    cm, h = _compiled(dev, n=2048, nnz=20000, d=64, tiles=(64, 16))
    cm(h)                               # the capture
    cm(h)
    torch.cuda.synchronize(dev)
    prog = next(iter(cm._programs.values()))
    n_clones = 1 + sum(isinstance(v, torch.Tensor)
                       for d in prog.diags for v in d.values())
    n_calls = 6

    def work():
        with torch.profiler.record_function("test.worker"):
            for _ in range(n_calls):
                cm(h)
                torch.cuda.synchronize(dev)
                time.sleep(0.002)

    with concurrent.futures.ThreadPoolExecutor(1) as pool, \
            gnn_serve.profiler(dev) as prof:
        time.sleep(0.05)
        with torch.profiler.record_function("test.main"):
            pool.submit(work).result(timeout=120)
        time.sleep(0.05)
    events = list(prof.profiler.kineto_results.events())
    spans = _spans(prof, "repro.model.")
    worker = _spans(prof, "test.worker")[0][1]
    assert worker != _spans(prof, "test.main")[0][1]
    assert {s[1] for s in spans} == {worker}
    by = {n: [s for s in spans if s[0] == f"repro.model.{n}"]
          for n in ("call", "copy_in", "replay", "copy_out")}
    assert all(len(v) == n_calls for v in by.values()), by
    ops = sorted((k.start_ns(), k.end_ns()) for k in events
                 if k.device_type() == DeviceType.CUDA
                 and not k.is_user_annotation())
    starts = [c[2] for c in by["call"]] + [float("inf")]
    assert ops and ops[0][0] >= starts[0]
    per_call = []
    for i in range(n_calls):
        mine = [o for o in ops if starts[i] <= o[0] < starts[i + 1]]
        assert all(b <= starts[i + 1] for _, b in mine), i
        assert mine[0][0] >= by["copy_in"][i][2], i
        assert all(a >= by["replay"][i][2] for a, _ in mine[1:]), i
        assert all(a >= by["copy_out"][i][2]
                   for a, _ in mine[-n_clones:]), i
        per_call.append(len(mine))
    assert len(set(per_call)) == 1 and per_call[0] > 1 + n_clones, per_call
    assert sum(per_call) == len(ops)
