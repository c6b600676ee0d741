"""The paper's own workload: GNN models x datasets on the Dynasparse-style
heterogeneous engine (see repro_torch.core / repro_torch.models.gnn)."""
from repro_torch.data.graphs import DATASETS
from repro_torch.models.gnn import MODELS

GNN_MODELS = MODELS
GNN_DATASETS = tuple(DATASETS)
