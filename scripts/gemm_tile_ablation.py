#!/usr/bin/env python3
"""Tile and pipeline variants of the dense GEMM kernels, on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 scripts/gemm_tile_ablation.py

It builds variants of ``src/repro_torch/kernels/csrc/gemm.cu`` and its
tile product ``sgemm_sm90.cuh``, each a text edit at a fixed anchor line,
and times every variant's ``gemm`` and ``gemm_batch`` on the shapes that
``chip_smoke.py`` times, each call in a CUDA graph of ten calls (no host
time between them), beside ``torch.matmul`` / ``torch.bmm`` and the
batched scatter kernel's older 64 x 64 tile, in one process: the list in
order, then reversed.  Operands are seeded normal values on the card.

- ``committed``: the sources as they are;
- ``bk8``: the 128 x 128 tile walks K in chunks of 8, not 16;
- ``iorder``: the fmafs of a step of k run row by row (i outer, j
  inner), not column by column;
- ``own_body``: ``gemm_kernel`` takes its operands straight from its
  parameters, not through the batched body it shares with
  ``gemm_batch_kernel``;
- ``wide64``: n > 64 takes the 128 x 64 tile too (each x tile read once
  per column tile, three thread blocks an SM);
- ``one_block``: the 128 x 128 tile without a minimum of two thread
  blocks an SM (the cap of 128 registers lifted);
- ``narrow_rows``: the narrow tiles give each thread a whole row (8 or
  16 columns, 128 rows a tile), not four columns.

Every variant keeps the summation order, so each is held bitwise against
``committed`` on every call.  It prints one line per timing, the card's
name and power limit, and last one JSON object with every time.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
SOURCES = ("gemm.cu", "sgemm_sm90.cuh")

# the lines of the sources that the variants replace
WIDE = ("gemm.cu", "return pick(Wide<128, 16>{});")
ORDER = ("sgemm_sm90.cuh", """#pragma unroll
      for (int j = 0; j < 4 * CB; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);""")
BODY = ("gemm.cu", """  if (skipped(pred, when)) return;
  __shared__ typename Tile::Smem s;
  batched_tile<Tile, VEC>(x, y, z, m, k, n, s);""")
MINB = ("sgemm_sm90.cuh",
        "static constexpr int MIN_BLOCKS = BN_ == 128 ? 2 : 3;")

VARIANTS = {
    "committed": [],
    "bk8": [(*WIDE, "return pick(Wide<128, 8>{});")],
    "iorder": [(*ORDER, """#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * CB; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);""")],
    "own_body": [(*BODY, """  if (skipped(pred, when)) return;
  __shared__ typename Tile::Smem s;
  int row0, col0;
  tile_origin<Tile>(n, row0, col0);
  Tile::template tile<VEC>(x, y, z, m, k, n, row0, col0, s);""")],
    "wide64": [(*WIDE, "return pick(Wide<64>{});")],
    "one_block": [(*MINB,
                   "static constexpr int MIN_BLOCKS = BN_ == 128 ? 1 : 3;")],
    "narrow_rows": [("gemm.cu", "return pick(Narrow<8>{});",
                     "return pick(Narrow<8, 1>{});"),
                    ("gemm.cu", "return pick(Narrow<16>{});",
                     "return pick(Narrow<16, 1>{});")],
}
# (label, kernel, T, m, k, n): compiled GCN-FL's layer-1 update and logits
# layer, GIN-CO's dense shape (its overflow fallback and per-task tiles),
# the dense queue's batch, and the layer-1 update as a batch of one
CALLS = [
    ("gemm l1-update", "gemm", 1, 89250, 500, 128),
    ("gemm logits", "gemm", 1, 89250, 128, 7),
    ("gemm GIN-CO", "gemm", 1, 2708, 2708, 16),
    ("gemm_batch dense queue", "gemm_batch", 8, 11264, 500, 128),
    ("gemm_batch l1-update", "gemm_batch", 1, 89250, 500, 128),
]


def start_builds(out_dir: Path) -> dict:
    """One ``nvcc`` process per variant (``gemm.cu`` alone), all started
    together."""
    from repro_torch.kernels import _build
    texts = {f: (CSRC / f).read_text() for f in SOURCES}
    procs = {}
    for name, edits in VARIANTS.items():
        src = dict(texts)
        for f, old, new in edits:
            if src[f].count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in {f} "
                                   "exactly once")
            src[f] = src[f].replace(old, new)
        vdir = out_dir / name
        shutil.rmtree(vdir, ignore_errors=True)
        vdir.mkdir(parents=True)
        for f, text in src.items():
            (vdir / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.CFLAGS, "-shared",
             str(vdir / "gemm.cu"), "-o", str(vdir / "gemm.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def load_builds(procs: dict, out_dir: Path) -> dict:
    from repro_torch.kernels import _build
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        lib = ctypes.CDLL(str(out_dir / name / "gemm.so"))
        for fn in ("gemm_tiled", "gemm_batch_f32"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
        for line in out.splitlines():
            if "registers" in line or "spill stores" in line:
                print(f"  {name} ptxas: {line.strip()}", flush=True)
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gemm_tile_ablation: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as smoke
    from repro_torch.kernels import _build, gemm

    card = smoke.card_line()
    smoke.log(f"card: {card}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}")
    dev = torch.device("cuda", 0)
    out_dir = ROOT / "build" / "gemm_ablation"
    procs = start_builds(out_dir)
    own = _build.library()
    libs = load_builds(procs, out_dir)

    gen = torch.Generator(device=dev).manual_seed(0)
    operands = {}
    for label, kname, T, m, k, n in CALLS:
        shape_x = (m, k) if kname == "gemm" else (T, m, k)
        shape_y = (k, n) if kname == "gemm" else (T, k, n)
        operands[label] = (torch.randn(shape_x, generator=gen, device=dev),
                           torch.randn(shape_y, generator=gen, device=dev))

    def launcher(name, label):
        kname = next(c[1] for c in CALLS if c[0] == label)
        x, y = operands[label]
        if name == "library":
            op = torch.matmul if kname == "gemm" else torch.bmm
            return lambda: op(x, y)
        if name == "old_tile":         # the scatter kernel's 64 x 64 tile
            x3 = x if x.ndim == 3 else x[None]
            y3 = y if y.ndim == 3 else y[None]
            z = torch.empty((x3.shape[0] * x3.shape[1], y3.shape[2]),
                            device=dev)
            rows = torch.arange(x3.shape[0], dtype=torch.int32, device=dev)
            cols = torch.zeros_like(rows)
            return lambda: gemm.gemm_batch_scatter(x3, y3, rows, cols, z)
        lib = libs[name]
        fn = getattr(gemm, kname)

        def run():
            _build._LIB = lib
            return fn(x, y)
        return run

    names = [*libs, "library", "old_tile"]
    times = {n: {c[0]: [] for c in CALLS} for n in names}
    for label, *_ in CALLS:
        want = None
        for name in libs:
            got = launcher(name, label)()
            torch.cuda.synchronize()
            if want is None:
                want = got
            elif not torch.equal(got, want):
                raise AssertionError(f"{name} differs from committed on "
                                     f"{label}")
        _build._LIB = own
        old = launcher("old_tile", label)()
        if not torch.equal(old, want.reshape(old.shape)):
            raise AssertionError(f"the older tile differs on {label}")
    smoke.log("every variant and the older 64 x 64 tile equal committed "
              "bitwise on every call")
    for order in (names, names[::-1]):
        for name in order:
            for label, kname, T, m, k, n in CALLS:
                t = smoke.graph_ms(torch, launcher(name, label))
                _build._LIB = own
                times[name][label].append(t)
                flops = 2.0 * T * m * k * n
                smoke.log(f"  {name:11s} {label:24s} {t:.4f} ms "
                          f"({flops / t / 1e9:.2f} TFLOP/s)")
    _build._LIB = own
    print(card)
    print(json.dumps({"card": card, "graph_ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
