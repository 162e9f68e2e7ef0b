"""Neighbour aggregation weighting and the gather-scatter baseline.

Counterpart of ``repro/core/aggregate.py``. Aggregator weighting (paper
§III-A): ``sum`` = raw A (GIN), ``mean`` = D⁻¹A (SAGE-mean), ``gcn`` =
D^{-1/2}AD^{-1/2} (GCN). ``max`` is not a matmul; it waits for the
attention slice (ROADMAP.md Queue 1, item 3). The fused full-graph
operator (``make_fused_aggregate``) comes with the full-batch slice.
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.backends.registry import ATTENTION_ITEM, not_ported
from repro_torch.graph.csr import CSRGraph

Aggregation = Literal["sum", "mean", "gcn", "max"]


def _weighted_graph(graph: CSRGraph, aggregation: Aggregation) -> CSRGraph:
    if aggregation in ("sum", "max"):
        return graph
    if aggregation == "mean":
        return graph.row_normalized()
    if aggregation == "gcn":
        return graph.sym_normalized()
    raise ValueError(f"unknown aggregation {aggregation!r}")


def gather_scatter_aggregate(
    src: torch.Tensor,  # [E] int
    dst: torch.Tensor,  # [E] int
    weights: torch.Tensor,  # [E] float
    x: torch.Tensor,  # [N, F]
    n_nodes: int,
    aggregation: Aggregation = "sum",
) -> torch.Tensor:
    """The O(|E|·F) baseline: materialise per-edge messages, then scatter."""
    if aggregation == "max":
        raise not_ported("max aggregation", ATTENTION_ITEM)
    messages = x[src.long()] * weights[:, None]  # the [|E|, F] tensor
    out = torch.zeros((n_nodes, x.shape[-1]), dtype=messages.dtype,
                      device=x.device)
    return out.index_add_(0, dst.long(), messages)
