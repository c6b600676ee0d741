"""Full-graph GNN inference across models x datasets (paper Table VI
shape) on the PyTorch port: the counterpart of
``examples/gnn_inference.py``.

    PYTHONPATH=src python examples_torch/gnn_inference.py [--datasets CO,CI,PU] [--device cpu]
"""
import argparse

from repro_torch.core import DynasparseEngine
from repro_torch.data.graphs import load_graph
from repro_torch.models import gnn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--datasets", default="CO,CI,PU")
    ap.add_argument("--models", default="GCN,GraphSAGE,GIN,SGC")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    print(f"{'model':>10} {'ds':>3} {'hw time (ms)':>12} "
          f"{'dense/executed FLOPs':>21}")
    for model in args.models.split(","):
        for ds in args.datasets.split(","):
            g = load_graph(ds, device=args.device)
            h = g.features
            params = gnn.init_params(model, h.shape[1], g.stats.hidden,
                                     g.stats.classes, device=args.device)
            eng = DynasparseEngine(device=args.device)
            _, report = gnn.run_inference(model, eng, g.adj, h, params,
                                          device=args.device)
            tot = report.total
            print(f"{model:>10} {ds:>3} {report.hardware_time * 1e3:>12.4f} "
                  f"{tot.flops_dense_equiv / tot.flops_executed:>20.1f}x")


if __name__ == "__main__":
    main()
