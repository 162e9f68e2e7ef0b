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
(SAGE-mean), ``gcn`` = D^{-1/2}AD^{-1/2} (GCN). ``max`` is not a matmul
and runs the segment path on every backend.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Literal

import torch

from repro_torch import resolve_device
from repro_torch.backends import Backend, select_backend
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
    """The O(|E|·F) baseline: materialise per-edge messages, then scatter.
    ``max`` takes the unweighted messages' elementwise max per destination
    (``jax.ops.segment_max``: -inf where a node has no in-edge; a tie
    shares the gradient equally, in both packages)."""
    messages = x[src.long()]  # the [|E|, F] tensor
    if aggregation == "max":
        idx = dst.long()[:, None].expand_as(messages)
        out = torch.full((n_nodes, x.shape[-1]), -torch.inf,
                         dtype=messages.dtype, device=x.device)
        return out.scatter_reduce(0, idx, messages, "amax", include_self=False)
    messages = messages * weights[:, None]
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
    # the registry's ``spmm_fused_epilogue`` over the pair; None for max
    aggregate_epilogue: "Callable | None" = dataclasses.field(
        default=None, repr=False)
    # (z [N, H*Dh], a_src, a_dst, heads) -> [N, H, Dh]: the registry's
    # ``spmm_attention`` over the pair; None when not requested or when the
    # backend has no fused attention
    aggregate_attention: "Callable | None" = dataclasses.field(
        default=None, repr=False)
    # the (A, Aᵀ) operand pair behind `aggregate` (or the attention); None
    # for max unless attention asked for the pair
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
    build_attention: bool = False,
) -> FusedGraphOp:
    """One-time lowering: weight the adjacency, build the forward/backward
    operand pair on the selected backend and ``device`` (CUDA unless
    asked), and bind the differentiable ``spmm_transposed_vjp`` and
    ``spmm_fused_epilogue`` over it. ``bc=None`` takes the adaptive width;
    the lowering pass passes its ``LayoutPlan``'s tile.

    ``build_attention`` also binds the backend's fused ``spmm_attention``
    over the same pair: attention reads only the nonzero pattern, so the
    weighted operands double as its masks. ``max`` is not a matmul: its
    aggregation is the segment path, and it builds the pair only when
    attention asks for it."""
    backend = select_backend(engine)
    dev = resolve_device(device)
    weighted = _weighted_graph(graph, aggregation)
    src_np, dst_np = weighted.edge_list()
    src = torch.from_numpy(src_np).to(dev)
    dst = torch.from_numpy(dst_np).to(dev)
    w = torch.from_numpy(weighted.data).to(dev)
    n = weighted.n_rows

    def pair():
        # (A, Aᵀ) operands — the paper's CSR-forward / CSC-backward pairing
        return (backend.build_spmm_operand(weighted, br=br, bc=bc, device=dev),
                backend.build_spmm_operand(weighted.transpose(), br=br, bc=bc,
                                           device=dev))

    if aggregation == "max":
        fwd = bwd = agg_attention = None
        if build_attention:
            fwd, bwd = pair()
            agg_attention = backend.spmm_attention(fwd, bwd)

        def agg_max(x):
            return gather_scatter_aggregate(src, dst, w, x, n, "max")

        return FusedGraphOp(
            aggregate=agg_max, n_nodes=n, aggregation="max",
            fwd_bytes=int(src_np.nbytes + dst_np.nbytes), src=src, dst=dst,
            weights=w, backend=backend.name,
            aggregate_attention=agg_attention, fwd_operand=fwd,
            bwd_operand=bwd)

    fwd, bwd = pair()
    return FusedGraphOp(
        aggregate=backend.spmm_transposed_vjp(fwd, bwd),
        aggregate_epilogue=backend.spmm_fused_epilogue(fwd, bwd),
        aggregate_attention=(backend.spmm_attention(fwd, bwd)
                             if build_attention else None),
        n_nodes=n,
        aggregation=aggregation,
        fwd_bytes=int(backend.operand_bytes(fwd) + backend.operand_bytes(bwd)),
        src=src,
        dst=dst,
        weights=w,
        backend=backend.name,
        fwd_operand=fwd,
        bwd_operand=bwd,
    )
