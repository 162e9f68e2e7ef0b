"""GNN layers and their parameters."""
