"""Quickstart: dynamic sparsity-exploiting GNN inference (the paper's core)
on the PyTorch port: the counterpart of ``examples/quickstart.py``.

Runs 2-layer GCN inference on synthetic Cora through the DynasparseEngine:
per-kernel density measurement -> Analyzer (STQ/DTQ) -> Scheduler -> result,
printing the runtime decisions and the estimated VCK5000 hardware time.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import VCK5000, DynasparseEngine
from repro_torch.data.graphs import load_graph
from repro_torch.models import gnn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    g = load_graph("CO", device=args.device)   # |V|=2708, Table IV densities
    h = g.features_dense
    params = gnn.init_params("GCN", h.shape[1], g.stats.hidden,
                             g.stats.classes, device=args.device)

    engine = DynasparseEngine(hw=VCK5000, device=args.device)
    logits, report = gnn.run_inference("GCN", engine, g.adj, h, params,
                                       device=args.device)

    print(f"logits: {tuple(logits.shape)}, finite: "
          f"{bool(torch.isfinite(logits).all())}")
    print(f"{'kernel':<12} {'STQ':>4} {'DTQ':>4} {'SpDMM':>6} {'SpMM':>5} "
          f"{'makespan':>12}")
    for name, rep in report.kernels:
        print(f"{name:<12} {rep.n_stq:>4} {rep.n_dtq:>4} {rep.n_spdmm:>6} "
              f"{rep.n_spmm:>5} {rep.makespan * 1e6:>10.1f}us")
    tot = report.total
    print(f"\nend-to-end hardware time (perf model): "
          f"{report.hardware_time * 1e3:.4f} ms")
    print(f"FLOPs executed {tot.flops_executed:.3g} vs dense-equivalent "
          f"{tot.flops_dense_equiv:.3g} "
          f"({tot.flops_dense_equiv / tot.flops_executed:.1f}x reduction)")


if __name__ == "__main__":
    main()
