# Model definitions of the port: the dense decoder-only LM (transformer.py)
# and the GNNs (gnn.py: GCN, GIN, GAT and GraphSAGE layers).
