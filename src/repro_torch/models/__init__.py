"""Models: the paper's GNN zoo (GCN, GraphSAGE, GIN, SGC) and the LM
stack's serving half (layers, mixers, FFN, decoder-only and enc-dec
models, the registry)."""
