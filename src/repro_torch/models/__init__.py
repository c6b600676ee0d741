"""GNN model zoo of the paper (GCN, GraphSAGE, GIN, SGC)."""
