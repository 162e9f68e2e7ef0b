"""Differentiable wrappers around the port's kernels.

Counterpart of ``repro/kernels/ops.py``. This slice ports ``feature_tile``
and ``bsr_spmm_pair``; the fused-epilogue and attention pairs come with
their kernels (ROADMAP.md Queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.bsr_spmm import bsr_spmm
from repro_torch.kernels.ref import bsr_spmm_ref


def feature_tile(f: int) -> tuple[int, int]:
    """(bf, f_pad): the JAX package's lane-tile policy, kept so plans and
    parity tests can name the TPU tile. The Hopper kernel masks the ragged
    feature edge itself and never pads F."""
    bf = min(128, f) if f % 128 != 0 else 128
    f_pad = -(-f // bf) * bf
    return bf, f_pad


def _dispatch_spmm(arrays, x, n_rows_padded, inner):
    rows, cols, _first, blocks = arrays
    if inner == "cuda":
        return bsr_spmm(rows, cols, blocks, x, n_rows_padded)
    if inner == "torch":
        return bsr_spmm_ref(rows, cols, blocks, x, n_rows_padded)
    raise ValueError(f"unknown inner executor {inner!r}; expected cuda|torch")


class _BSRSpmmPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd_arrays, bwd_arrays, n_rows_padded, inner):
        ctx.bwd_arrays = bwd_arrays
        ctx.n_cols_padded = x.shape[0]
        ctx.inner = inner
        return _dispatch_spmm(fwd_arrays, x, n_rows_padded, inner)

    @staticmethod
    def backward(ctx, dy):
        if ctx.bwd_arrays is None:
            raise RuntimeError("bsr_spmm_pair was called without the "
                               "transposed operand; no gradient exists")
        dx = _dispatch_spmm(ctx.bwd_arrays, dy.float().contiguous(),
                            ctx.n_cols_padded, ctx.inner)
        return dx, None, None, None, None


def bsr_spmm_pair(fwd_arrays: tuple, bwd_arrays: Optional[tuple],
                  x: torch.Tensor, n_rows_padded: int,
                  inner: str = "cuda") -> torch.Tensor:
    """Y = A @ X where (fwd_arrays, bwd_arrays) are the BSR of A and Aᵀ,
    each the 4-tuple (rows, cols, first, blocks).

    Differentiable in ``x`` only (the graph is data); the backward runs the
    same SpMM on the pre-built transposed operand, dX = Aᵀ @ dY. ``inner``
    picks the executor: ``"cuda"`` the kernel wrapper (the plain version
    for CPU tensors), ``"torch"`` the plain version on any device.
    ``x`` is [n_cols_padded, F] with any F; ``bwd_arrays`` may be ``None``
    where no gradient is taken (inference), and the backward then raises.
    Both paddings must agree (the sampler aligns its caps to lcm(br, bc)).
    """
    return _BSRSpmmPair.apply(x, fwd_arrays, bwd_arrays, n_rows_padded, inner)
