#!/usr/bin/env python3
"""Where the SpMM triple walk's time goes, on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 scripts/spmm_walk_ablation.py

It records the ``spmm_fused`` call of GIN's first aggregation on the Cora
stand-in (CO at full size, literal engine, block 8: the call that
``chip_smoke.py`` times), builds variants of
``src/repro_torch/kernels/csrc/spmm_fused.cu`` that each leave out or add
one part of the walk, and times every variant on that call in a CUDA graph
and eagerly, beside ``torch.sparse.mm`` of the adjacency, in one process:
the list in order, then reversed.

- ``walk``: the source as it is;
- ``a_columns``: the Y row of every non-zero A column is fetched and
  multiplied, not only the live ones (same result);
- ``dense``: every (triple, k) item, every block multiplied in full (same
  result);
- ``masks_only``: the walk reads every triple's descriptors and masks and
  does its run bookkeeping, canvas loads and stores, but fetches and
  multiplies no item;
- ``skeleton``: ``masks_only`` without the mask reads;
- ``masks_launch``: the first launch only (every warp of the walk returns
  at once).

The variants that compute the function are held bitwise against
``walk``.  It prints one line per timing, the card's name and power limit,
and last one JSON object with every time.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "spmm_fused.cu"

# the lines of the source that the variants replace
LIVE = ("return t0 + lane < E ? (unsigned)(p.a_masks[a] & p.y_masks[y]) "
        ": 0u;")
ITEMS = "const unsigned mask = lane < n ? live : 0u;"
SHARE = "if (warp >= p.shares) return;"
VARIANTS = {
    "walk": {},
    "a_columns": {LIVE: "return t0 + lane < E ? (unsigned)p.a_masks[a] : 0u;"},
    "dense": {LIVE: "return t0 + lane < E ? (B == 32 ? kFull "
                    ": (1u << (B % 32)) - 1u) : 0u;"},
    # `live` is still read, but no mask has a bit at or above B
    "masks_only": {ITEMS: "const unsigned mask = B < 32 && (live >> (B % 32))"
                          " != 0u ? live : 0u;"},
    "skeleton": {LIVE: "return 0u;"},
    "masks_launch": {SHARE: "return;"},
}
EXACT = ("walk", "a_columns", "dense")
LIBRARY = "torch.sparse.mm"


def start_builds(out_dir: Path) -> dict:
    """One ``nvcc`` process per variant, all started together."""
    from repro_torch.kernels import _build
    text = SOURCE.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits.items():
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in "
                                   f"{SOURCE.name} exactly once")
            src = src.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.CFLAGS, "-shared", str(cu), "-o",
             str(out_dir / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def load_builds(procs: dict, out_dir: Path) -> dict:
    from repro_torch.kernels import _build
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        fn = lib.spmm_fused_f32
        fn.argtypes = _build.SIGNATURES["spmm_fused_f32"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("spmm_walk_ablation: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as smoke
    from repro_torch.core import DynasparseEngine
    from repro_torch.data.graphs import load_graph
    from repro_torch.kernels import _build, gemm, spdmm, spmm
    from repro_torch.models import gnn

    card = smoke.card_line()
    smoke.log(f"card: {card}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}")
    dev = torch.device("cuda", 0)
    out_dir = ROOT / "build" / "spmm_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = start_builds(out_dir)

    co = load_graph("CO", device=dev)
    h = co.features_dense
    params = gnn.init_params("GIN", h.shape[1], 16, co.stats.classes,
                             seed=0, device=dev)
    engine = DynasparseEngine(literal=True, device=dev)
    with smoke.Recorder({"gemm": gemm, "spdmm": spdmm, "spmm": spmm}) as rec:
        gnn.run_inference("GIN", engine, co.adj, h, params, device=dev)
    args, kw = rec.calls["spmm_fused"][0]
    kw = {k: v for k, v in kw.items() if k != "pred"}
    call = smoke.spmm_items(args) | smoke.run_stats(
        smoke.runs_of("spmm_fused", args, kw))
    smoke.log(f"GIN-CO l1-agg: {smoke.shape_of('spmm_fused', args, kw)}; "
              f"{call}")
    libs = load_builds(procs, out_dir)
    library = smoke.library_call(torch, "spmm_fused", co, args)

    def launcher(name):
        if name == LIBRARY:
            return library
        z = kw["z"].clone()
        lib = libs[name]

        def fn():
            _build._LIB = lib
            return spmm.spmm_fused(*args, **{**kw, "z": z})
        return fn

    own = _build.library()
    times = {name: {"graph_ms": [], "ms": []} for name in [*libs, LIBRARY]}
    want = None
    try:
        order = [*libs, LIBRARY]
        for name in order + order[::-1]:
            fn = launcher(name)
            g_ms, e_ms = smoke.graph_ms(torch, fn), smoke.device_ms(torch, fn)
            times[name]["graph_ms"].append(g_ms)
            times[name]["ms"].append(e_ms)
            note = ""
            if name in EXACT:
                _build._LIB = libs[name]
                got = spmm.spmm_fused(*args, **{**kw, "z": kw["z"].clone()})
                torch.cuda.synchronize()
                want = got if want is None else want
                if not torch.equal(got, want):
                    raise AssertionError(f"variant {name} is not bitwise "
                                         "equal to the walk")
                note = "  bitwise equal to walk"
            smoke.log(f"{name}: graph {g_ms:.4f} ms  eager {e_ms:.4f} ms"
                      + note)
    finally:
        _build._LIB = own
    print(card)
    print(json.dumps({"call": call, "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
