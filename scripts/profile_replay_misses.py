#!/usr/bin/env python3
"""How often ``torch.profiler`` misses a kernel's record in a profiled
CUDA-graph replay, and whether the replay or the profiler loses it, on
one NVIDIA card.

Run from the root of a checkout::

    python3 scripts/profile_replay_misses.py [--n 200] [--out FILE]
        [--ways window,warmed,edges]

It builds what ``chip_smoke.py::drive_mesh_compiled`` profiles: GCN on the
FL stand-in (89,250 vertices) through a literal engine on a mesh of four
shards of the card, compiled into one CUDA graph (two ``gemm`` and eight
``spdmm_fused`` launches a replay).  Then, for each way of profiling
(``window``: a profiler window around one replay alone, as
``profile_replay`` had it; ``warmed``: the profiler's schedule, dropping
a warm-up replay's records first; ``edges``:
:func:`chip_smoke.replay_rows`, idle host time inside the window on
either side of the replay), ``--n`` profiled replays, their inputs
alternating between the features ``h`` and ``2 h``, the replay before
each (the window's previous one, or the warm-up) taking the other input.
Each profiled replay's output is held bitwise against an unprofiled
replay of the same input: a kernel that did not run would leave its
buffer as the replay before wrote it, so the output would not match.
Each window's launches by kernel name are compared with the capture's
record; a miss is logged with the kernels missing and the port's rows of
the window.  The
graph's kernel nodes are also counted without the profiler, from a graph
of the same body captured for the purpose and read through libcuda's
graph calls.

It prints one line per miss, the card's name and power limit, and last
one JSON object with the counts (also written to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _libcuda():
    """libcuda (one instance in the process, so the graph torch captured
    is a handle it knows)."""
    import ctypes
    for name in ("libcuda.so.1", "libcuda.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


def graph_kernels(torch, cm, h) -> dict | None:
    """The kernel nodes of a CUDA graph of ``cm``'s replay body captured
    for the purpose, counted from the graph itself through libcuda
    (``cuGraphGetNodes``; each kernel node's function named by
    ``cuFuncGetName``): ``{kernel name: nodes}``, or None where this
    torch keeps no graph or libcuda cannot name a function."""
    import collections
    import ctypes

    lib = _libcuda()
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    if lib is None or not hasattr(graph, "raw_cuda_graph"):
        return None
    static = h.clone()
    side = torch.cuda.Stream(h.device)
    side.wait_stream(torch.cuda.current_stream(h.device))
    with torch.cuda.stream(side):
        cm.run(cm.payload, static)
    torch.cuda.current_stream(h.device).wait_stream(side)
    with torch.cuda.graph(graph):
        cm.run(cm.payload, static)
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if lib.cuGraphGetNodes(raw, None, ctypes.byref(n)):
        return None
    nodes = (ctypes.c_void_p * n.value)()
    lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n))
    out = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:                      # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func first, the CUkernel at byte 56
        params = (ctypes.c_void_p * 16)()
        if lib.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params):
            return None
        name = ctypes.c_char_p()
        if params[0] and not lib.cuFuncGetName(ctypes.byref(name),
                                               ctypes.c_void_p(params[0])):
            out[name.value.decode(errors="replace")] += 1
        elif params[7] and not lib.cuKernelGetName(
                ctypes.byref(name), ctypes.c_void_p(params[7])):
            out[name.value.decode(errors="replace")] += 1
        else:
            out["(unnamed)"] += 1
    return dict(out)


def by_port_name(kernels: dict, names) -> dict:
    """``graph_kernels``' nodes of each of the port's kernel ``names``
    (demangled or mangled names: ``<name>_kernel`` within them)."""
    return {k: sum(c for key, c in kernels.items()
                   if re.search(rf"(?<![A-Za-z_]){k}_kernel", key))
            for k in names}


def window_rows(torch, fn, warm):
    """A profiler window around one call of ``fn`` alone (what
    ``chip_smoke.py::profile_replay`` did before ``replay_rows``)."""
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = cs.synced_wall(torch, fn)
    return cs.device_rows(prof), wall


def warmed_rows(torch, fn, warm):
    """The profiler's schedule with a warm-up call of ``warm`` whose
    records it drops (``schedule(wait=0, warmup=1, active=1)``), then
    one call of ``fn``."""
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        cs.synced_wall(torch, warm)
        prof.step()
        _, wall = cs.synced_wall(torch, fn)
        prof.step()
    return cs.device_rows(prof), wall


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_replay_misses: needs an NVIDIA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ways", default="window,warmed,edges",
                    help="comma list of the ways of profiling to count")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core import DynasparseEngine
    from repro_torch.data.graphs import load_graph
    from repro_torch.kernels import _build, gemm, ops, spdmm, spmm
    from repro_torch.launch.mesh import DataMesh
    from repro_torch.models import gnn

    card = cs.card_line()
    dev = torch.device("cuda", 0)
    _build.library()
    mods = {"gemm": gemm, "spdmm": spdmm, "spmm": spmm}
    fl = load_graph("FL", device=dev)
    eager = cs.drive(torch, gnn, ops, DynasparseEngine, "main path", "GCN",
                     fl, 128, dev, mods)
    m4 = cs.drive_mesh(torch, gnn, ops, DynasparseEngine,
                       "GCN-FL mesh 4 halo", "GCN", fl, dev, eager,
                       DataMesh((dev,) * cs.MESH_SHARDS), mods)
    h = fl.features_dense
    _, cm = gnn.compile_model("GCN", m4["engine"], fl.adj, h,
                              eager["params"])
    inputs = (h, 2 * h)
    want = [cm(x) for x in inputs]
    sig = (tuple(h.shape), str(h.dtype))
    per_call = cm.capture_launches[sig]
    prog = cm._programs[sig]
    scaled = bool(torch.equal(want[1], 2 * want[0]))
    try:
        kernels = graph_kernels(torch, cm, h)
    except (AttributeError, OSError, RuntimeError) as e:
        cs.log(f"graph nodes not read: {type(e).__name__}: {e}")
        kernels = None
    nodes = None if kernels is None else by_port_name(kernels, per_call)
    cs.log(f"captured launches a replay {per_call}; the port's kernel nodes "
           f"of a graph of the same body, read from the graph {nodes} "
           f"({None if kernels is None else sum(kernels.values())} kernel "
           f"nodes in all); replay of 2 h == 2 x replay of h: {scaled}")
    out = dict(card=card, n=args.n, per_call=per_call, graph_nodes=nodes,
               graph_kernels=kernels, methods={})
    ways = {"window": window_rows, "warmed": warmed_rows,
            "edges": lambda torch, fn, warm: cs.replay_rows(torch, fn)}
    for method in args.ways.split(","):
        rows_of = ways[method]
        misses, wrong, empty = [], 0, 0
        for i in range(args.n):
            x, other = inputs[i % 2], inputs[1 - i % 2]
            # the replay before the profiled one (the warm-up where there
            # is one) takes the other input
            if method != "warmed":
                cm(other)
            rows, _ = rows_of(torch, lambda: cm(x), lambda: cm(other))
            wrong += not torch.equal(prog.logits, want[i % 2])
            if not rows:
                empty += 1
                continue
            seen = cs.launches_by_name(rows, per_call)
            if seen != per_call:
                missing = {k: per_call[k] - seen.get(k, 0) for k in per_call
                           if seen.get(k, 0) != per_call[k]}
                port = sorted((key[:70], c) for _, c, key in rows
                              if re.search(r"(gemm|spdmm|spmm)\w*_kernel",
                                           key))
                misses.append(dict(i=i, missing=missing, port_rows=port))
                cs.log(f"{method} {i}: missing {missing}; the port's rows "
                       f"{port}")
        out["methods"][method] = dict(misses=len(misses), wrong_outputs=wrong,
                                      empty_windows=empty, detail=misses)
        cs.log(f"{method}: {len(misses)} of {args.n} profiled replays miss "
               f"a kernel's record; outputs not bitwise the unprofiled "
               f"replay's: {wrong}; windows with no device rows: {empty}")
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(card)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
