"""GNN serving launcher: async micro-batched inference over a shared cache.

``PYTHONPATH=src python -m repro_torch.launch.gnn_serve --dataset CO
--model GCN [--requests 64] [--max-batch 8] [--scale 0.05] [--literal]
[--cache-file plan.pkl] [--device cuda] [--trace serve.json]``

Fires a burst of synthetic same-graph requests through the ServingEngine
and prints a machine-readable stats line: latency percentiles, micro-batch
sizes, plan-cache hit rate, CUDA kernel launches per request and the host
wall of each phase of the process (``phases``).  With
``--cache-file`` the SharedPlanCache is loaded before serving (a restart
skips re-analysis — observe packs/analyzes stay 0) and saved after.
``--literal`` serves through the hand-written CUDA kernels (their plain
versions with ``--device cpu``).  ``--trace`` runs the serve under
``torch.profiler`` on every thread, writes a Chrome trace and adds
``spans``, the count, total and self time of each of the port's
``repro.*`` ranges and the threads they ran on, to the stats line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import threading
import time

import numpy as np


def synthetic_requests(graph_id: str, h0: np.ndarray, n: int,
                       seed: int = 0) -> list[tuple[str, np.ndarray]]:
    """``n`` requests on ``graph_id``: the dataset's features with seeded
    noise on their non-zeros (the sparsity pattern is kept)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        noise = rng.normal(0, 0.01, size=h0.shape).astype(np.float32)
        reqs.append((graph_id, (h0 + noise * (h0 != 0)).astype(np.float32)))
    return reqs


def batch_walls(requests) -> list[float]:
    """Execute wall of each micro-batch, in dispatch order (the requests of
    one batch are recorded together and share its ``t_execute``)."""
    walls, i = [], 0
    while i < len(requests):
        walls.append(requests[i].t_execute)
        i += max(1, requests[i].batch_size)
    return walls


def span_summary(events: list[dict], threads: dict) -> dict:
    """``{name: {count, total_ms, self_ms, threads}}`` of the ``repro.*``
    ranges among a Chrome trace's ``events``: a range's self time is its
    duration less the ranges nested directly in it on its thread;
    ``threads`` names each thread id (the trace's ``tid``)."""
    from repro_torch.trace import PREFIX

    spans = sorted((e for e in events if e.get("ph") == "X"
                    and str(e.get("name", "")).startswith(PREFIX)),
                   key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    out: dict = {}
    stack: list = []                    # (tid, end, name) of open ranges
    for e in spans:
        end = e["ts"] + e["dur"]
        while stack and (stack[-1][0] != e["tid"] or stack[-1][1] < end):
            stack.pop()
        ms = e["dur"] * 1e-3
        s = out.setdefault(e["name"], {"count": 0, "total_ms": 0.0,
                                       "self_ms": 0.0, "threads": set()})
        s["count"] += 1
        s["total_ms"] += ms
        s["self_ms"] += ms
        s["threads"].add(threads.get(e["tid"], str(e["tid"])))
        if stack:
            out[stack[-1][2]]["self_ms"] -= ms
        stack.append((e["tid"], end, e["name"]))
    for s in out.values():
        s["threads"] = sorted(s["threads"])
    return out


def profiler(device):
    """``torch.profiler.profile`` over the host ops of every thread, and
    the card's, on a CUDA ``device``."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    try:
        every_thread = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        raise SystemExit(
            f"gnn_serve --trace: torch {torch.__version__} lacks "
            "profile_all_threads, so the dispatch worker's ranges would "
            "not be recorded") from None
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, experimental_config=every_thread)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="CO", help="Table-IV dataset id")
    ap.add_argument("--model", default="GCN")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=0.0)
    ap.add_argument("--scale", type=float, default=0.05,
                    help="graph scale factor (1 = Table IV size)")
    ap.add_argument("--drift-threshold", type=float, default=0.25)
    ap.add_argument("--literal", action="store_true",
                    help="serve through the fused CUDA kernels")
    ap.add_argument("--cache-file", default=None,
                    help="load the shared plan cache before serving, save "
                         "after (serving-restart persistence)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain "
                         "versions of the kernels)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="profile the serve on every thread, write a "
                         "Chrome trace to PATH and summarize the port's "
                         "spans in the stats line")
    args = ap.parse_args()

    t0 = time.perf_counter()
    from repro_torch.core import DynasparseEngine
    from repro_torch.data.graphs import load_graph
    from repro_torch.device import host, resolve_device
    from repro_torch.kernels import ops
    from repro_torch.models import gnn
    from repro_torch.serving import (ServingConfig, ServingEngine,
                                     SharedPlanCache, SketchConfig)

    t_imports = time.perf_counter()
    dev = resolve_device(args.device)
    g = load_graph(args.dataset, scale=args.scale, device=dev)
    in_dim = (g.features.shape[1] if hasattr(g.features, "shape")
              else g.stats.features)
    params = gnn.init_params(args.model, in_dim, g.stats.hidden,
                             g.stats.classes, device=dev)

    t1 = time.perf_counter()
    cache = SharedPlanCache(device=dev)
    if args.cache_file and os.path.exists(args.cache_file):
        print(f"[gnn_serve] loaded cache: {cache.load(args.cache_file)}")
    t2 = time.perf_counter()
    engine = DynasparseEngine(literal=args.literal, cache=cache, device=dev)
    srv = ServingEngine(
        args.model, params, engine=engine,
        config=ServingConfig(
            max_batch=args.max_batch,
            max_delay_s=args.max_delay_ms * 1e-3,
            sketch=SketchConfig(threshold=args.drift_threshold)))
    srv.register_graph(args.dataset, g.adj)
    reqs = synthetic_requests(args.dataset, host(g.features_dense),
                              args.requests)

    ops.reset_cuda_launch_counts()
    threads = {}
    t3 = time.perf_counter()
    with (profiler(dev) if args.trace else contextlib.nullcontext()) as prof:
        try:
            outs = srv.serve(reqs)
        finally:
            if args.trace:  # the dispatch worker ends with close()
                threads = {t.native_id: t.name
                           for t in threading.enumerate()}
            srv.close()
    t4 = time.perf_counter()
    launches = sum(ops.cuda_launch_counts().values())

    stats = srv.stats.as_dict()
    stats.update({
        "dataset": args.dataset, "model": args.model,
        "vertices": g.stats.vertices, "device": str(dev),
        "cache": cache.stats.as_dict(),
        "cache_bytes": cache.bytes_used,
        "plan_hit_rate": cache.stats.hit_rate,
        "kernel_launches_per_request": launches / max(1, len(outs)),
        "dispatch": srv.dispatch_stats(),
        "phases": {"imports": t_imports - t0, "graph": t1 - t_imports,
                   "cache_load": t2 - t1,
                   "requests": t3 - t2, "serve": t4 - t3,
                   "batch_execute": batch_walls(srv.stats.requests)},
    })
    if args.trace:
        prof.export_chrome_trace(args.trace)
        with open(args.trace) as f:
            trace = json.load(f)
        stats["spans"] = span_summary(trace["traceEvents"], threads)
    print("[gnn_serve] " + json.dumps(stats))

    if args.cache_file:
        print(f"[gnn_serve] saved cache: {cache.save(args.cache_file)}")


if __name__ == "__main__":
    main()
