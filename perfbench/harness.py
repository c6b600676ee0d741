"""One run of one cell, driven by ``BENCHMARK.json`` and the files it
names.

A cell is found by its name in ``BENCHMARK.json``: its configuration file,
its traffic mix (``traffic/<traffic>.json``, whose ``driver`` names
``traffic/<driver>.py``), its limits (``workloads/<cell>.json``) and each
metric's reader (``metrics/<name before the first dot>.py``, a ``read``
function that returns a number or None).  Adding a cell, a mix, a
configuration or a metric adds files and entries; nothing here changes.

A run: the inputs from the seed on the device, the driver's set-up and
warm-up (``setup_s`` ends there), the measured window, with ``--trace 1``
a profiled sub-window after it, the device's peak read, the program
freed, and only then the reference's comparison of the window's sampled
answers.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from perfbench import check, counts, graphs, tracing
from perfbench.window import Sampler, Window, sync

PERF = Path(__file__).resolve().parent
ROOT = PERF.parent
PROFILE_S = 0.5                         # the traced sub-window
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict                          # its entry in BENCHMARK.json
    cfg: dict
    mix: dict
    limits: dict


@dataclasses.dataclass
class Context:
    """What a metric's reader may read: everything a run measured, so a
    reader added later needs no change here."""
    cell: Cell
    unit: str                           # "infer" or "request"
    setup_s: float
    window: Window
    window_peak_bytes: int | None
    events: list | None                 # the profiled sub-window's events
    summary: tracing.Summary | None     # ... and what they add up to
    sizes: dict                         # n, edges, features as run
    flops: int                          # one inference, the count's
    bound_s: float                      # one inference, the count's


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = benchmark() if bench is None else bench
    spec = {w["name"]: w for w in bench["workloads"]}.get(name)
    if spec is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_spec = {c["name"]: c for c in bench["configs"]}[spec["config"]]
    return Cell(name=name, spec=spec, cfg=load_json(ROOT / cfg_spec["file"]),
                mix=load_json(PERF / "traffic" / f"{spec['traffic']}.json"),
                limits=load_json(PERF / "workloads" / f"{name}.json")[
                    "limits"])


def load_module(path: Path):
    key = "perfbench._" + "_".join(path.relative_to(PERF).with_suffix(
        "").parts).replace("-", "_").replace(".", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def metrics_for(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones: those that list it, or that list no cells and move an
    end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def read_metrics(specs: list[dict], ctx: Context) -> dict:
    out = {}
    for m in specs:
        base = m["name"].split(".")[0]
        v = load_module(PERF / "metrics" / f"{base}.py").read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_loaded() -> list[str]:
    """Modules of JAX or of the JAX package this process holds, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device: torch.device, peak: int | None) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": peak}


def peak_bytes(device: torch.device) -> int | None:
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        device="cuda", scale: float = 1.0, t0: float | None = None) -> dict:
    """One run of ``workload``; the result line as a dict.  ``scale`` and a
    CPU ``device`` are for rehearsals on the host only."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = benchmark()
    cell = load_cell(workload, bench)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    driver = load_module(PERF / "traffic" / f"{cell.mix['driver']}.py")
    inputs = graphs.make_inputs(cell.cfg, seed, cell.mix["pool"], dev, scale)
    drv = driver.Driver(cell.cfg, cell.mix, inputs, dev, seed)
    sync(dev)
    setup_s = time.perf_counter() - t0

    peak = peak_bytes(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sampler = Sampler(seed)
    win = drv.window(seconds, sampler)
    window_peak = peak_bytes(dev)
    events = summary = None
    if traced:
        units = []
        events = tracing.profiled(lambda: units.append(
            drv.profile(PROFILE_S)), lambda: sync(dev))
        summary = tracing.summarize(events, units[0])
    if dev.type == "cuda":
        peak = max(peak, int(torch.cuda.max_memory_allocated(dev)))
    drv.close()
    del drv
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    values = check.readings(cell.cfg, inputs, sampler.kept)
    checks = check.verdict(values, cell.limits)
    n, e, f = graphs.sizes(cell.cfg["graph"], scale)
    sizes = dict(n=n, edges=e, features=f)
    ctx = Context(cell=cell, unit=driver.Driver.unit, setup_s=setup_s,
                  window=win, window_peak_bytes=window_peak, events=events,
                  summary=summary, sizes=sizes,
                  flops=counts.flops(cell.cfg, **sizes),
                  bound_s=counts.bound_s(cell.cfg, **sizes))
    result = {
        "correct": win.failed == 0 and check.passed(checks),
        "attempted": win.attempted,
        "failed": win.failed,
        "metrics": read_metrics(metrics_for(bench, workload, traced), ctx),
        "device": device_info(dev, peak),
    }
    if traced:
        result["device"].update(
            busy_s=summary.busy_s if summary else 0.0,
            window_s=summary.window_s if summary else 0.0)
        if summary:
            result["breakdown"] = {"device_ops": summary.device_ops,
                                   "idle_gaps": summary.idle_gaps}
    result["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"])
                            else None, "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def report(result: dict) -> int:
    """Print the compared numbers on standard error and the result as the
    last line of standard output; refuse to print if JAX or the JAX
    package was loaded."""
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: the process holds {bad}: no result",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0
