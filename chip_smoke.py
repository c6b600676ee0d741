#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(``nvcc``, ``sm_90a``), then:

1. drives the main path — GCN on the Flickr stand-in (FL) at full size,
   hidden 128, ``DynasparseEngine(literal=True)`` with the VCK5000 model —
   through ``run_inference`` twice (cold: plan, pack, lower; warm: cache
   hits), with every kernel's launch count set to 0 just before and read
   just after, and holds the logits against the port's own ``literal=False``
   run (COO ``index_add_`` + ``torch.matmul``, TF32 off);
2. drives GIN on the Cora stand-in (CO) at full size the same way: its
   first aggregation is the path's SpMM kernel;
3. holds every kernel against its plain PyTorch version on the operands the
   two paths gave it (recorded in a third, uncounted run of each path) and
   times kernel, plain version and one library call with CUDA events;
4. prints the kernel summary as one JSON line, the card's name and power
   limit, and, last, ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero.  Without a card, or
outside a checkout, it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM3 bandwidth.  The kernels run FP32 FMA on the CUDA cores.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# kernel vs plain version: f32, the summation order differs
KERNEL_TOL = dict(rtol=2e-5, atol=2e-4)
# literal (fused kernels) vs literal=False logits: f32 end to end
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)

KERNELS = {
    "gemm_batch_scatter": dict(
        module="gemm", source="src/repro_torch/kernels/csrc/"
        "gemm_batch_scatter.cu", replaces="src/repro/kernels/gemm.py:94"),
    "spdmm_fused": dict(
        module="spdmm", source="src/repro_torch/kernels/csrc/spdmm_fused.cu",
        replaces="src/repro/kernels/spdmm.py:111"),
    "spmm_fused": dict(
        module="spmm", source="src/repro_torch/kernels/csrc/spmm_fused.cu",
        replaces="src/repro/kernels/spmm.py:56"),
}


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int = 5, inner: int = 3) -> float:
    """Median device time of ``fn`` (CUDA events around ``inner``
    back-to-back calls, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


class Recorder:
    """Wraps the kernel wrappers of ``repro_torch.kernels.{gemm,spdmm,spmm}``
    for one run and keeps each call's operands, with the canvas ``z`` as it
    was before the call (the kernels update it in place)."""

    def __init__(self, mods):
        self.mods = mods
        self.calls: dict[str, list] = {name: [] for name in KERNELS}
        self._orig = {}

    def __enter__(self):
        for name, spec in KERNELS.items():
            mod = self.mods[spec["module"]]
            fn = getattr(mod, name)
            self._orig[name] = fn

            def rec(*args, _name=name, _fn=fn, **kw):
                if _name == "gemm_batch_scatter":
                    saved = (args[:4] + (args[4].clone(),), dict(kw))
                else:
                    saved = (args, {**kw, "z": kw["z"].clone()})
                self.calls[_name].append(saved)
                return _fn(*args, **kw)
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for name, spec in KERNELS.items():
            setattr(self.mods[spec["module"]], name, self._orig[name])


def runs_of(name: str, args, kw):
    if name == "gemm_batch_scatter":
        return None
    runs = kw.get("runs")
    if runs is None:
        from repro_torch.kernels.formats import run_starts
        runs = run_starts(args[4], args[5])
    return runs


def work_of(name: str, args, kw) -> tuple[float, float]:
    """(bytes, FLOPs) the call needs, from this call's own descriptors:
    each input read once (the pool blocks and operand slices the entries
    reference, the descriptors, the canvas blocks of runs that hold no
    ``first`` flag), each output block written once."""
    import numpy as np
    if name == "gemm_batch_scatter":
        x, y, _rows, _cols, _z = args
        t, m, k = x.shape
        n = y.shape[2]
        nbytes = 4 * (t * m * k + t * k * n + t * m * n) + 8 * t
        return nbytes, 2.0 * t * m * n * k
    B = kw["block_size"]
    runs = runs_of(name, args, kw).cpu().numpy()
    n_runs = len(runs) - 1
    first = args[6].cpu().numpy()
    n_entries = len(first)
    no_first = int((np.add.reduceat(first, runs[:-1]) == 0).sum())
    n_a = int(args[2].unique().numel())
    if name == "spdmm_fused":
        bn = kw["bn"]
        ncs = args[1].shape[1] // bn
        y_keys = args[3].long() * ncs + args[5].long()
        n_y = int(y_keys.unique().numel())
        nbytes = 4 * (n_a * B * B + n_y * B * bn + 5 * n_entries + n_runs
                      + 1 + (n_runs + no_first) * B * bn)
        return nbytes, 2.0 * n_entries * B * B * bn
    n_y = int(args[3].unique().numel())
    nbytes = 4 * ((n_a + n_y) * B * B + 5 * n_entries + n_runs + 1
                  + (n_runs + no_first) * B * B)
    return nbytes, 2.0 * n_entries * B ** 3


def shape_of(name: str, args, kw) -> str:
    if name == "gemm_batch_scatter":
        x, y, _r, _c, z = args
        return (f"x {tuple(x.shape)} y {tuple(y.shape)} "
                f"z {tuple(z.shape)}")
    n_runs = int(runs_of(name, args, kw).shape[0]) - 1
    return (f"pool {tuple(args[0].shape)} operand {tuple(args[1].shape)} "
            f"entries {int(args[2].shape[0])} runs {n_runs} "
            f"z {tuple(kw['z'].shape)}")


def drive(torch, tgnn, ops, engine_cls, name: str, model: str, g, hidden,
          dev, mods):
    """Cold + warm ``run_inference`` with launch counts, the
    ``literal=False`` comparison and an uncounted recording run."""
    h = g.features_dense
    params = tgnn.init_params(model, h.shape[1], hidden, g.stats.classes,
                              seed=0, device=dev)
    engine = engine_cls(literal=True, device=dev)
    log(f"== {name}: {model} on {g.stats.name} (V={g.stats.vertices}, "
        f"adjacency nnz={g.adj.nnz}, features {tuple(h.shape)}, "
        f"hidden {hidden}, classes {g.stats.classes})")
    ops.reset_cuda_launch_counts()
    for phase in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, report = tgnn.run_inference(model, engine, g.adj, h, params,
                                            device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = {k: v for k, v in engine.cache.stats.as_dict().items() if v}
        log(f"  {phase}: wall {wall:.4f} s  launches "
            f"{ops.cuda_launch_counts()}  cache {stats}")
    launches = ops.cuda_launch_counts()
    for (kname, rep), meta in zip(report.kernels, report.meta):
        M, K, N = meta["M"], meta["K"], meta["N"]
        log(f"  kernel {kname:10s} STQ {rep.n_stq:3d} (SpDMM {rep.n_spdmm}, "
            f"SpMM {rep.n_spmm})  DTQ {rep.n_dtq:3d}  M×K×N {M}×{K}×{N} "
            f"(unpadded dense 2MKN {2.0 * M * K * N:.4g} FLOP)")
    if not (logits.shape == (g.stats.vertices, g.stats.classes)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{name}: logits {tuple(logits.shape)} not "
                             "finite / wrong shape")
    plain_engine = engine_cls(literal=False, device=dev)
    ref, _ = tgnn.run_inference(model, plain_engine, g.adj, h, params,
                                device=dev)
    err = (logits - ref).abs()
    bound = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * ref.abs()
    log(f"  logits vs literal=False: max abs {err.max().item():.3e}, "
        f"max |ref| {ref.abs().max().item():.3e}, tolerance {LOGIT_TOL}")
    if bool((err > bound).any()):
        raise AssertionError(f"{name}: literal logits disagree with the "
                             "literal=False run")
    with Recorder(mods) as rec:
        again, _ = tgnn.run_inference(model, engine, g.adj, h, params,
                                      device=dev)
    torch.cuda.synchronize()
    if not torch.equal(again, logits):
        raise AssertionError(f"{name}: a repeated run is not bitwise equal")
    log(f"  repeated run bitwise equal; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_warm(torch, tgnn, model, engine, g.adj, h, params, dev)
    return launches, rec.calls


def profile_warm(torch, tgnn, model, engine, adj, h, params, dev):
    """One more warm run, uncounted: the synchronized host wall of each
    engine kernel's plan and execute phases, and under ``torch.profiler``
    the device time by CUDA kernel name, whose sum against the run's wall
    gives the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []

    def timed(phase, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            walls.append((phase, time.perf_counter() - t0))
            return out
        return run

    engine.plan = timed("plan", engine.plan)
    engine.execute = timed("execute", engine.execute)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, report = tgnn.run_inference(model, engine, adj, h, params,
                                           device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del engine.plan, engine.execute
    names = [n for n, _ in report.kernels]
    log("  profiled warm run (profiler on), plan / execute per kernel: "
        + ", ".join(f"{n} {1e3 * walls[2 * i][1]:.2f} / "
                    f"{1e3 * walls[2 * i + 1][1]:.2f} ms"
                    for i, n in enumerate(names))
        + f"; whole run {1e3 * wall:.2f} ms")
    rows = []
    for e in prof.key_averages():       # device-side rows only: no double count
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    busy_ms = sum(r[0] for r in rows) / 1e3
    if not rows:
        log("  profiler recorded no device time: idle share not measured")
        return
    log(f"  device busy {busy_ms:.3f} ms of {1e3 * wall:.2f} ms wall: idle "
        f"share {1 - busy_ms / (1e3 * wall):.4f}")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")


def check_kernel(torch, mods, name, calls, library):
    """Every recorded call against the plain version; the first call is
    timed.  Returns the summary entry of this kernel."""
    mod = mods[KERNELS[name]["module"]]
    kernel, plain = getattr(mod, name), getattr(mod, name + "_plain")

    def run(fn, args, kw):
        if name == "gemm_batch_scatter":
            return fn(*args[:4], args[4].clone())
        return fn(*args, **{**kw, "z": kw["z"].clone()})

    worst = 0.0
    for i, (args, kw) in enumerate(calls):
        got = run(kernel, args, kw)
        want = run(plain, args, kw)
        torch.cuda.synchronize()
        err = (got - want).abs()
        limit = KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * want.abs()
        rel = (err / want.abs().clamp_min(1e-30)).max().item()
        log(f"  {name} call {i}: {shape_of(name, args, kw)}  max abs "
            f"{err.max().item():.3e}  max rel {rel:.3e}  tolerance "
            f"{KERNEL_TOL}")
        if bool((err > limit).any()):
            raise AssertionError(f"{name} call {i} disagrees with its plain "
                                 "version")
        worst = max(worst, err.max().item())

    args, kw = calls[0]
    z = args[4].clone() if name == "gemm_batch_scatter" else kw["z"].clone()
    if name == "gemm_batch_scatter":
        k_fn = lambda: kernel(*args[:4], z)
        p_fn = lambda: plain(*args[:4], z)
    else:
        kw_t = {**kw, "z": z}
        k_fn = lambda: kernel(*args, **kw_t)
        p_fn = lambda: plain(*args, **kw_t)
    ms = device_ms(torch, k_fn)
    plain_ms = device_ms(torch, p_fn)
    library_ms = device_ms(torch, library) if library is not None else None
    nbytes, flops = work_of(name, args, kw)
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS
    bound_ms = 1e3 * max(t_bytes, t_ops)
    log(f"  {name} timed on call 0: kernel {ms:.4f} ms  plain "
        f"{plain_ms:.4f} ms  library "
        f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}  bound "
        f"{bound_ms:.4f} ms ({nbytes:.4g} B, {flops:.4g} FLOP)")
    return {"name": name, "route": "cuda",
            "source": KERNELS[name]["source"],
            "replaces": KERNELS[name]["replaces"],
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def adjacency_csr(torch, adj):
    idx = torch.stack([adj.rows.long(), adj.cols.long()])
    coo = torch.sparse_coo_tensor(idx, adj.vals, adj.shape).coalesce()
    return coo.to_sparse_csr()


def summarize(torch, mods, paths):
    """One summary entry per kernel: its worst error against the plain
    version over every recorded call, and the times of its first recorded
    call on the first path that launched it (the main path, or GIN-CO's
    first aggregation for the SpMM kernel) beside the library call and the
    bound.  ``launches`` is that path's count (cold + warm run);
    ``launches_by_path`` gives every path's."""
    log("== kernels against their plain versions")
    csrs = [adjacency_csr(torch, g.adj) for _, g, _, _ in paths]
    summary = []
    for name in KERNELS:
        order = [(p, csr) for p, csr in zip(paths, csrs)
                 if p[2].get(name, 0) > 0]
        calls = [(label, g, csr, c) for (label, g, _, cs), csr in order
                 for c in cs[name]]
        if not calls:
            raise AssertionError(f"no recorded call of {name}")
        label, g, csr, (args, kw) = calls[0]
        library = None
        if name == "gemm_batch_scatter":
            library = lambda a=args: torch.bmm(a[0], a[1])
        else:
            # the adjacency aggregation as one sparse-times-dense call
            y = args[1] if name == "spdmm_fused" else g.features_dense
            if y.shape[0] >= csr.shape[1]:
                library = lambda c=csr, yy=y[: csr.shape[1]]: \
                    torch.sparse.mm(c, yy)
        entry = check_kernel(torch, mods, name, [c for *_, c in calls],
                             library)
        by_path = {p_label: launches.get(name, 0)
                   for p_label, _, launches, _ in paths}
        entry.update(path=label, launches=by_path[label],
                     launches_by_path=by_path)
        summary.append(entry)
        torch.cuda.empty_cache()
    return summary


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import DynasparseEngine
    from repro_torch.data.graphs import load_graph
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import gemm, spdmm, spmm
    from repro_torch.models import gnn

    mods = {"gemm": gemm, "spdmm": spdmm, "spmm": spmm}
    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({_build.BUILD_INFO.get('path')}, cached="
        f"{_build.BUILD_INFO.get('cached')})")
    for line in _build.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    fl = load_graph("FL", device=dev)
    log(f"FL stand-in generated in {time.perf_counter() - t0:.2f} s")
    fl_launches, fl_calls = drive(torch, gnn, ops, DynasparseEngine,
                                     "main path", "GCN", fl, 128, dev, mods)
    for k in ("gemm_batch_scatter", "spdmm_fused"):
        if fl_launches.get(k, 0) <= 0:
            raise AssertionError(f"main path launched no {k} kernel")

    co = load_graph("CO", device=dev)
    co_launches, co_calls = drive(torch, gnn, ops, DynasparseEngine,
                                     "SpMM path", "GIN", co, 16, dev, mods)
    if co_launches.get("spmm_fused", 0) <= 0:
        raise AssertionError("GIN on CO launched no spmm_fused kernel")

    summary = summarize(torch, mods,
                        [("GCN-FL", fl, fl_launches, fl_calls),
                         ("GIN-CO", co, co_launches, co_calls)])
    keys = ("name", "route", "source", "replaces", "path", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in summary]}), flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
