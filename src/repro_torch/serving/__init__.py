"""Online GNN serving engine."""
