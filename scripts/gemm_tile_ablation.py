#!/usr/bin/env python3
"""Tile and pipeline variants of the dense GEMM kernels, on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 scripts/gemm_tile_ablation.py

It builds variants of ``src/repro_torch/kernels/csrc/gemm.cu`` and its
tile product ``sgemm_sm90.cuh``, each a text edit at a fixed anchor line,
and times every variant's ``gemm``, ``gemm_batch`` and
``gemm_batch_scatter`` on the shapes that ``chip_smoke.py`` times, each
call in a CUDA graph of ten calls (no host time between them), beside
``torch.matmul`` / ``torch.bmm`` and, on the ``gemm`` and ``gemm_batch``
calls, the committed scatter kernel on the same operands (identity tile
rows, column 0), in one process: the list in order, then reversed.
Operands are seeded normal values on the card.

- ``committed``: the sources as they are;
- ``bk8``: the 128 x 128 tile walks K in chunks of 8, not 16;
- ``iorder``: the fmafs of a step of k run row by row (i outer, j
  inner), not column by column;
- ``own_body``: ``gemm_kernel`` takes its operands straight from its
  parameters, not through the batched body it shares with
  ``gemm_batch_kernel``;
- ``early_origin``: the scatter reads its tile's canvas origin (``rows``,
  ``cols``) before the product, not after it;
- ``wide64``: n > 64 takes the 128 x 64 tile too (each x tile read once
  per column tile, three thread blocks an SM);
- ``one_block``: the 128 x 128 tile without a minimum of two thread
  blocks an SM (the cap of 128 registers lifted);
- ``narrow_rows``: the narrow tiles give each thread a whole row (8 or
  16 columns, 128 rows a tile), not four columns, in chunks of 32 (128
  rows of 64 do not fit the 48 KB of static shared memory);
- ``narrow_bk32``: the narrow tiles walk K in chunks of 32, not 64
  (twice the chunks, each a round trip to memory);
- ``narrow_half``: narrow thread blocks of 64 threads, not 128 (16 rows
  a tile at n <= 16, so twice the blocks in flight);
- ``narrow_half_bk128``: narrow blocks of 64 threads walking K in chunks
  of 128.

Every variant keeps the summation order, so each, and the scatter kernel
on the dense calls, is held bitwise against ``committed`` on every
call.  It prints one line per timing, the card's
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
  batched_tile<Tile, VEC>(x, y, DenseOut<TOut>{z, n}, m, k, n, s);""")
ORIGIN = ("gemm.cu", "CanvasOut{z, rows, cols, m, n, ldz}")
MINB = ("sgemm_sm90.cuh",
        "static constexpr int MIN_BLOCKS = BN_ == 128 ? 2 : 3;")
NARROW = ("sgemm_sm90.cuh",
          "static constexpr int THREADS = 128, BM = THREADS / CG, BN = NP, "
          "BK = 64;")


def narrow(threads: int, bk: int) -> list:
    return [(*NARROW, f"static constexpr int THREADS = {threads}, "
             f"BM = THREADS / CG, BN = NP, BK = {bk};")]



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
  Tile::template tile<VEC>(x, y, DenseOut<TOut>{z, n}, m, k, n, row0, col0,
                           s);""")],
    "early_origin": [(*ORIGIN, "DenseOut<float>{z + (int64_t)rows[blockIdx.y] "
                      "* m * ldz + (int64_t)cols[blockIdx.y] * n, ldz}")],
    "wide64": [(*WIDE, "return pick(Wide<64>{});")],
    "one_block": [(*MINB,
                   "static constexpr int MIN_BLOCKS = BN_ == 128 ? 1 : 3;")],
    "narrow_rows": [("gemm.cu", "return pick(Narrow<8>{});",
                     "return pick(Narrow<8, 1>{});"),
                    ("gemm.cu", "return pick(Narrow<16>{});",
                     "return pick(Narrow<16, 1>{});"), *narrow(128, 32)],
    "narrow_bk32": narrow(128, 32),
    "narrow_half": narrow(64, 64),
    "narrow_half_bk128": narrow(64, 128),
}
# (label, kernel, T, m, k, n): compiled GCN-FL's layer-1 update and logits
# layer, GIN-CO's dense shape (its overflow fallback and per-task tiles),
# the dense queue's batch, the layer-1 update as a batch of one, and the
# scatter on GCN-FL's dense queue and on compiled GIN-CO's largest
# block-skip launch (l1-mlp1's dense queue: one 384-row tile, K 2708)
CALLS = [
    ("gemm l1-update", "gemm", 1, 89250, 500, 128),
    ("gemm logits", "gemm", 1, 89250, 128, 7),
    ("gemm GIN-CO", "gemm", 1, 2708, 2708, 16),
    ("gemm_batch dense queue", "gemm_batch", 8, 11264, 500, 128),
    ("gemm_batch l1-update", "gemm_batch", 1, 89250, 500, 128),
    ("scatter dense queue", "gemm_batch_scatter", 8, 11264, 500, 128),
    ("scatter GIN-CO l1-mlp1", "gemm_batch_scatter", 1, 384, 2708, 16),
]
ENTRIES = ("gemm_tiled", "gemm_batch_f32", "gemm_batch_scatter_f32")


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
        for fn in ENTRIES:
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
        for line in out.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill stores" in line):
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

    def scatter_args(x, y):
        """Identity tile rows, column 0, on a canvas of the stacked rows."""
        x3 = x if x.ndim == 3 else x[None]
        y3 = y if y.ndim == 3 else y[None]
        z = torch.empty((x3.shape[0] * x3.shape[1], y3.shape[2]),
                        device=dev)
        rows = torch.arange(x3.shape[0], dtype=torch.int32, device=dev)
        return x3, y3, rows, torch.zeros_like(rows), z

    def launcher(name, label):
        kname = next(c[1] for c in CALLS if c[0] == label)
        x, y = operands[label]
        if name == "library":
            op = torch.matmul if kname == "gemm" else torch.bmm
            return lambda: op(x, y)
        if name == "scatter" or kname == "gemm_batch_scatter":
            args = scatter_args(x, y)
            lib = own if name == "scatter" else libs[name]

            def run():
                _build._LIB = lib
                return gemm.gemm_batch_scatter(*args)
            return run
        lib = libs[name]
        fn = getattr(gemm, kname)

        def run():
            _build._LIB = lib
            return fn(x, y)
        return run

    names = [*libs, "library", "scatter"]
    times = {n: {c[0]: [] for c in CALLS} for n in names}
    for label, kname, *_ in CALLS:
        want = None
        for name in libs:
            got = launcher(name, label)()
            torch.cuda.synchronize()
            if want is None:
                want = got.clone()
            elif not torch.equal(got, want):
                raise AssertionError(f"{name} differs from committed on "
                                     f"{label}")
        if kname != "gemm_batch_scatter":
            got = launcher("scatter", label)()
            if not torch.equal(got, want.reshape(got.shape)):
                raise AssertionError(f"the scatter kernel differs on {label}")
        _build._LIB = own
    smoke.log("every variant, and the scatter kernel on the dense calls, "
              "equal committed bitwise on every call")
    for order in (names, names[::-1]):
        for name in order:
            for label, kname, T, m, k, n in CALLS:
                if name == "scatter" and kname == "gemm_batch_scatter":
                    continue           # the committed row is that kernel
                t = smoke.graph_ms(torch, launcher(name, label))
                _build._LIB = own
                times[name][label].append(t)
                flops = 2.0 * T * m * k * n
                smoke.log(f"  {name:17s} {label:24s} {t:.4f} ms "
                          f"({flops / t / 1e9:.2f} TFLOP/s)")
    _build._LIB = own
    print(card)
    print(json.dumps({"card": card, "graph_ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
