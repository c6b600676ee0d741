"""Render the dry-run and roofline tables from ``launch/dryrun.py``'s cell
files: the counterpart of the reference's ``repro/launch/report.py``.

``python -m repro_torch.launch.report --out results/dryrun_torch``.
Given the same rows, the tables are the reference's, except that the
compute-bound note names the H100's tensor cores and the headings name
each mesh by its shape.  Every number is a count at H100 constants
(``launch/roofline.py``), not a timing.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

ORDER_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(out_dir: Path) -> list[dict]:
    rows = []
    for p in sorted(out_dir.glob("*.json")):
        rows.append(json.loads(p.read_text()))
    return rows


def fmt_t(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def dryrun_table(rows: list[dict], mesh: str) -> str:
    out = ["| arch | shape | status | compile | peak/dev GB | per-chip GFLOPs"
           " | AG GB | AR GB | RS GB | A2A GB | CP GB |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['status']} | "
                       f"— | — | — | — | — | — | — | — |")
            continue
        c = r["collectives"]
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['compile_s']}s | "
            f"{r['memory']['peak_per_device_gb']} | "
            f"{r['cost']['flops'] / 1e9:.0f} | "
            f"{c['all-gather'] / 1e9:.2f} | {c['all-reduce'] / 1e9:.2f} | "
            f"{c['reduce-scatter'] / 1e9:.2f} | "
            f"{c['all-to-all'] / 1e9:.2f} | "
            f"{c['collective-permute'] / 1e9:.2f} |")
    return "\n".join(out)


def roofline_table(rows: list[dict], mesh: str = "single") -> str:
    out = ["| arch | shape | compute | memory | collective | bottleneck | "
           "MODEL_FLOPS | useful/HLO | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh or r["status"] != "ok":
            continue
        t = r["roofline"]
        note = _note(r)
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_t(t['compute_s'])} | "
            f"{fmt_t(t['memory_s'])} | {fmt_t(t['collective_s'])} | "
            f"**{t['dominant'].replace('_s', '')}** | "
            f"{r['model_flops']:.2e} | {r['useful_flops_ratio']:.3f} | "
            f"{note} |")
    return "\n".join(out)


def _note(r: dict) -> str:
    t = r["roofline"]
    dom = t["dominant"]
    if dom == "memory_s":
        return ("raise arithmetic intensity: larger per-chip tile / fewer "
                "remat passes / bf16 masters")
    if dom == "collective_s":
        return ("reduce cross-chip payload: overlap FSDP gathers, int8 "
                "grad-reduce, TP-local layouts")
    return ("compute-bound: near roofline; H100 tensor-core utilization is "
            "the lever")


def pick_hillclimb(rows: list[dict]) -> list[dict]:
    """worst roofline fraction / most collective-bound / most
    paper-representative (MoE = the dynamic-sparsity dispatch arch)."""
    ok = [r for r in rows if r["status"] == "ok" and r["mesh"] == "single"]

    def frac(r):
        t = r["roofline"]
        return t["compute_s"] / max(t["total_bound_s"], 1e-30)

    worst = min(ok, key=frac)
    coll = max(ok, key=lambda r: r["roofline"]["collective_s"]
               / max(r["roofline"]["total_bound_s"], 1e-30))
    moe = [r for r in ok if r["arch"].startswith("deepseek-v2-236b")
           and r["shape"] == "train_4k"][0]
    picks = []
    for r in (worst, coll, moe):
        if r not in picks:
            picks.append(r)
    return picks


def cells_table(rows: list[dict]) -> str:
    """One line per (arch, shape) with both meshes side by side (single /
    multi): status, per-device peak GB, TFLOPs, all-gather and
    reduce-scatter GB, and the dominant roofline term."""
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in rows}
    out = ["| arch | shape | status | peak/dev GB | TFLOP/dev | AG GB | "
           "RS GB | dominant |", "|---|---|---|---|---|---|---|---|"]

    def cols(r):
        if r is None or r["status"] != "ok":
            return ("—",) * 5
        c = r["collectives"]
        return (f"{r['memory']['peak_per_device_gb']:.1f}",
                f"{r['cost']['flops'] / 1e12:.1f}",
                f"{c['all-gather'] / 1e9:.1f}",
                f"{c['reduce-scatter'] / 1e9:.2f}",
                r["roofline"]["dominant"].replace("_s", ""))

    for arch, shape in dict.fromkeys((r["arch"], r["shape"]) for r in rows):
        pair = [by.get((arch, shape, m)) for m in ("single", "multi")]
        status = " / ".join(r["status"] if r else "missing" for r in pair)
        vals = zip(*(cols(r) for r in pair))
        out.append(f"| {arch} | {shape} | {status} | "
                   + " | ".join(" / ".join(v) for v in vals) + " |")
    return "\n".join(out)


def mesh_heading(kind: str) -> str:
    """A mesh named by its shape and device count."""
    from repro_torch.launch.dryrun import MESHES
    shape, names = MESHES[kind]
    return (f"{' x '.join(map(str, shape))} mesh over "
            f"({', '.join(names)}), {math.prod(shape)} devices")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--what", default="all",
                    choices=("all", "dryrun", "roofline", "picks",
                             "cells"))
    args = ap.parse_args(argv)
    rows = load(Path(args.out))
    key = lambda r: (r["arch"], ORDER_SHAPES.index(r["shape"]), r["mesh"])
    rows.sort(key=key)
    if args.what in ("all", "dryrun"):
        print(f"### Dry-run — {mesh_heading('single')}\n")
        print(dryrun_table(rows, "single"))
        print(f"\n### Dry-run — {mesh_heading('multi')}\n")
        print(dryrun_table(rows, "multi"))
    if args.what in ("all", "roofline"):
        print(f"\n### Roofline ({mesh_heading('single')}, per device, "
              "counts at H100 constants)\n")
        print(roofline_table(rows))
    if args.what == "cells":
        print(f"### Cells — single ({mesh_heading('single')}) / multi "
              f"({mesh_heading('multi')}), the busiest device\n")
        print(cells_table(rows))
    if args.what in ("all", "picks"):
        print("\n### Hillclimb picks\n")
        for r in pick_hillclimb(rows):
            t = r["roofline"]
            print(f"- {r['arch']} x {r['shape']}: dominant={t['dominant']} "
                  f"compute={fmt_t(t['compute_s'])} "
                  f"bound={fmt_t(t['total_bound_s'])} "
                  f"fraction={t['compute_s'] / max(t['total_bound_s'], 1e-30):.3f}")


if __name__ == "__main__":
    main()
