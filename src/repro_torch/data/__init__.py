from repro_torch.data.graphs import DATASETS, Graph, load_graph

__all__ = ["DATASETS", "Graph", "load_graph"]
