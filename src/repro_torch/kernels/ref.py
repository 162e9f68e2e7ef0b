"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth its CUDA kernel is held against
on the card, and the executor for CPU tensors (the tests, and the
``torch`` reference backend on any device). Counterpart of
``repro/kernels/ref.py``.

The SpMM versions walk the block stream in fixed chunks of about
``CHUNK_BYTES`` of gathered operand, in stream order, each chunk
``index_add_``-ed into the output: a full-graph operand gathered in one
piece (ogbn-arxiv's A at F=256: ~120 GB) would not fit on the card.
"""
from __future__ import annotations

import torch

#: gathered operand per chunk of the plain SpMM versions
CHUNK_BYTES = 1 << 30


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
    x_blk = x.float().reshape(x.shape[0] // bc, bc, f)
    out = torch.zeros((n_rows_padded // br, br, f), dtype=torch.float32,
                      device=x.device)
    step = max(1, CHUNK_BYTES // max(4 * bc * f, 1))
    for s in range(0, n_blocks, step):
        gathered = x_blk[block_cols[s:s + step].long()]  # [chunk, BC, F]
        prod = torch.bmm(blocks[s:s + step].float(), gathered)
        out.index_add_(0, block_rows[s:s + step].long(), prod)
    return out.reshape(n_rows_padded, f)


def bsr_spmm_fused_ref(
    block_rows: torch.Tensor,
    block_cols: torch.Tensor,
    blocks: torch.Tensor,
    x: torch.Tensor,
    n_rows_padded: int,
    self_term: "torch.Tensor | None" = None,  # [n_rows_padded, F]
    bias: "torch.Tensor | None" = None,  # [F]
    alpha=None,  # scalar or 1-element tensor; 1.0 when None
    activation: str = "none",
):
    """act(A @ X + alpha * self_term + bias), the epilogue composed after
    the SpMM. Returns ``(y, mask)`` for relu (mask float32 0/1 of the
    pre-activation's sign), else ``(y, None)``."""
    z = bsr_spmm_ref(block_rows, block_cols, blocks, x, n_rows_padded)
    if self_term is not None:
        a = 1.0 if alpha is None else alpha
        z = z + a * self_term.float()
    if bias is not None:
        z = z + bias.float().reshape(1, -1)
    if activation == "relu":
        return torch.relu(z), (z > 0).float()
    if activation != "none":
        raise ValueError(f"unsupported fused activation {activation!r}")
    return z, None


def bsr_spmm_masked_ref(
    block_rows: torch.Tensor,
    block_cols: torch.Tensor,
    blocks: torch.Tensor,
    x: torch.Tensor,  # [n_cols_padded, F] — the incoming cotangent
    mask: torch.Tensor,  # shaped like x — the saved activation mask
    n_rows_padded: int,
) -> torch.Tensor:
    """Y = A @ (mask ⊙ X): the fused-epilogue VJP through a ReLU."""
    return bsr_spmm_ref(block_rows, block_cols, blocks, x * mask,
                        n_rows_padded)


def fused_adam_ref(p, g, m, v, lr_t: float, beta1: float, beta2: float,
                   eps: float, weight_decay: float):
    """One AdamW step in float32; ``lr_t`` already folds the bias
    correction: lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t). Returns
    ``(p, m, v)``."""
    g = g.float()
    p32 = p.float()
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * g * g
    update = m_new / (torch.sqrt(v_new) + eps) + weight_decay * p32
    return (p32 - lr_t * update).to(p.dtype), m_new, v_new
