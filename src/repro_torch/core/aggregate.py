"""Neighbour aggregation: the gather-scatter baseline and the fused operator.

Counterpart of ``repro/core/aggregate.py``. Two execution paths, matching
the paper's evaluation:

* ``gather_scatter_aggregate`` — the PyG/DGL baseline (§II, Eq. 12):
  gather per-edge source features, scale, ``index_add_``. Materialises the
  O(|E|·F) edge-message tensor.
* ``make_fused_aggregate`` — Morphling's fused path (Eq. 13): messages
  accumulate directly into destination rows in the BSR SpMM kernels; the
  backward multiplies by the pre-transposed graph (the paper's CSC view,
  §IV-B.b), so gradients are conflict-free by construction.

Aggregator weighting (paper §III-A): ``sum`` = raw A (GIN), ``mean`` = D⁻¹A
(SAGE-mean), ``gcn`` = D^{-1/2}AD^{-1/2} (GCN). ``max`` is not a matmul;
it waits for the attention slice (ROADMAP.md Queue 1, item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Literal

import torch

from repro_torch import resolve_device
from repro_torch.backends import Backend, select_backend
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


@dataclasses.dataclass
class FusedGraphOp:
    """A graph bound to its fused aggregation operator (per aggregation)."""

    aggregate: Callable[[torch.Tensor], torch.Tensor]
    n_nodes: int
    aggregation: Aggregation
    fwd_bytes: int  # sparse-operand footprint of the (A, Aᵀ) pair
    # baseline (gather-scatter) inputs, on the operands' device
    src: torch.Tensor
    dst: torch.Tensor
    weights: torch.Tensor
    backend: str = "cuda"  # registry name of the backend serving `aggregate`
    # (u, self_term, bias, alpha, activation) -> act(A·u + alpha·self + b):
    # the registry's ``spmm_fused_epilogue`` over the pair
    aggregate_epilogue: "Callable | None" = dataclasses.field(
        default=None, repr=False)
    # the (A, Aᵀ) operand pair behind `aggregate`
    fwd_operand: object = dataclasses.field(default=None, repr=False)
    bwd_operand: object = dataclasses.field(default=None, repr=False)

    def baseline(self, x: torch.Tensor) -> torch.Tensor:
        return gather_scatter_aggregate(
            self.src, self.dst, self.weights, x, self.n_nodes, self.aggregation)


def make_fused_aggregate(
    graph: CSRGraph,
    aggregation: Aggregation = "gcn",
    br: int = 8,
    bc: "int | None" = None,
    engine: "str | Backend | None" = None,  # registry name; None = cuda
    device=None,
) -> FusedGraphOp:
    """One-time lowering: weight the adjacency, build the forward/backward
    operand pair on the selected backend and ``device`` (CUDA unless
    asked), and bind the differentiable ``spmm_transposed_vjp`` and
    ``spmm_fused_epilogue`` over it. ``bc=None`` takes the adaptive width;
    the lowering pass passes its ``LayoutPlan``'s tile."""
    if aggregation == "max":
        raise not_ported("max aggregation", ATTENTION_ITEM)
    backend = select_backend(engine)
    dev = resolve_device(device)
    weighted = _weighted_graph(graph, aggregation)
    src_np, dst_np = weighted.edge_list()
    # (A, Aᵀ) operands — the paper's CSR-forward / CSC-backward pairing
    fwd = backend.build_spmm_operand(weighted, br=br, bc=bc, device=dev)
    bwd = backend.build_spmm_operand(weighted.transpose(), br=br, bc=bc,
                                     device=dev)
    return FusedGraphOp(
        aggregate=backend.spmm_transposed_vjp(fwd, bwd),
        aggregate_epilogue=backend.spmm_fused_epilogue(fwd, bwd),
        n_nodes=weighted.n_rows,
        aggregation=aggregation,
        fwd_bytes=int(backend.operand_bytes(fwd) + backend.operand_bytes(bwd)),
        src=torch.from_numpy(src_np).to(dev),
        dst=torch.from_numpy(dst_np).to(dev),
        weights=torch.from_numpy(weighted.data).to(dev),
        backend=backend.name,
        fwd_operand=fwd,
        bwd_operand=bwd,
    )
