"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth its CUDA kernel is held against
on the card, and the executor for CPU tensors (the tests, and the
``torch`` reference backend on any device). Counterpart of
``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch


def bsr_spmm_ref(
    block_rows: torch.Tensor,  # [n_blocks] int (sorted)
    block_cols: torch.Tensor,  # [n_blocks] int
    blocks: torch.Tensor,  # [n_blocks, BR, BC]
    x: torch.Tensor,  # [n_cols_padded, F]
    n_rows_padded: int,
) -> torch.Tensor:
    """Y[r*BR:(r+1)*BR] += blocks[b] @ X[c*BC:(c+1)*BC] for each block b.

    Float32 [n_rows_padded, F]; block-rows without blocks are zero.
    ``index_add_`` uses atomics on CUDA, so on the card this version is
    not bitwise repeatable (the kernel is)."""
    n_blocks, br, bc = blocks.shape
    f = x.shape[-1]
    x_blk = x.reshape(x.shape[0] // bc, bc, f)
    gathered = x_blk[block_cols.long()]  # [n_blocks, BC, F]
    prod = torch.bmm(blocks.float(), gathered.float())
    out = torch.zeros((n_rows_padded // br, br, f), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, block_rows.long(), prod)
    return out.reshape(n_rows_padded, f)
