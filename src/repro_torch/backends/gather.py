"""Gather-scatter backend — counterpart of ``repro/backends/gather.py``.

Edge-list operands, per-edge gather + ``index_add_`` (paper §II, Eq. 12).
The sampled path binds its ``spmm`` as ``gather.feature_matmul_sparse``:
the per-batch COO feature operand is an edge list with W as the gathered
matrix. ``index_add_`` uses atomics on CUDA, so this path is not bitwise
repeatable on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.backends.registry import Backend


@dataclasses.dataclass
class EdgeListOperand:
    """COO view: Y = A @ X as gather/scale/segment-sum."""

    src: torch.Tensor      # [E] int — column index (gather rows of X)
    dst: torch.Tensor      # [E] int — output row
    weights: torch.Tensor  # [E] float32
    n_rows: int


class GatherBackend(Backend):
    name = "gather"

    def spmm(self, operand: EdgeListOperand, x: torch.Tensor) -> torch.Tensor:
        msgs = x[operand.src.long()] * operand.weights[:, None]  # [E, F]
        out = torch.zeros((operand.n_rows, x.shape[-1]), dtype=msgs.dtype,
                          device=x.device)
        return out.index_add_(0, operand.dst.long(), msgs)
