"""Gather-scatter backend — counterpart of ``repro/backends/gather.py``.

Edge-list operands, per-edge gather + ``index_add_`` (paper §II, Eq. 12);
its full-batch ``spmm_fused_epilogue`` is the registry's composition, and
its attention is the segment path (``edge_softmax_aggregate``).
The sampled path binds its ``spmm`` as ``gather.feature_matmul_sparse``:
the per-batch COO feature operand is an edge list with W as the gathered
matrix. ``index_add_`` uses atomics on CUDA, so this path is not bitwise
repeatable on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.backends.registry import Backend, edge_softmax_aggregate
from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class EdgeListOperand:
    """COO view: Y = A @ X as gather/scale/segment-sum."""

    src: torch.Tensor      # [E] int — column index (gather rows of X)
    dst: torch.Tensor      # [E] int — output row
    weights: torch.Tensor  # [E] float32
    n_rows: int


class GatherBackend(Backend):
    name = "gather"

    def build_spmm_operand(self, csr: CSRGraph, br: int = 8, bc=None,
                           device=None) -> EdgeListOperand:
        # br/bc are BSR tile hints; the edge-list layout has no blocks
        dev = resolve_device(device)
        src, dst = csr.edge_list()
        return EdgeListOperand(
            src=torch.from_numpy(src).to(dev), dst=torch.from_numpy(dst).to(dev),
            weights=torch.from_numpy(csr.data).to(dev), n_rows=csr.n_rows)

    def operand_bytes(self, operand: EdgeListOperand) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in (operand.src, operand.dst, operand.weights)))

    def spmm(self, operand: EdgeListOperand, x: torch.Tensor) -> torch.Tensor:
        msgs = x[operand.src.long()] * operand.weights[:, None]  # [E, F]
        out = torch.zeros((operand.n_rows, x.shape[-1]), dtype=msgs.dtype,
                          device=x.device)
        return out.index_add_(0, operand.dst.long(), msgs)

    def sparse_mha(self, fwd_operand: EdgeListOperand, bwd_operand):
        """Attention on this backend is the gather path: the ``sparse_mha``
        contract served over the edge-list operand, so the vocabulary stays
        complete, while plans that bind ``gather`` name the segment
        primitive."""
        op = fwd_operand

        def mha(z, a_src, a_dst):
            return edge_softmax_aggregate(z, a_src, a_dst, op.src, op.dst,
                                          op.n_rows)

        return mha
