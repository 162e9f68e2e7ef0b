"""GNN layers and their parameters; the LM substrate (configs in ``repro_torch.configs``)."""
