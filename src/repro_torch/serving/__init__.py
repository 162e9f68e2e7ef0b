"""Online GNN serving engine and the LM serving engine."""
