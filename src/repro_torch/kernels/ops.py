"""Differentiable wrappers around the port's kernels.

Counterpart of ``repro/kernels/ops.py``: ``feature_tile``, the device
operand ``BSRDevice`` and ``build_bsr_pair``, ``bsr_spmm_pair`` (the
sampled path's SpMM with its Aᵀ backward) and the fused-epilogue pair
``bsr_spmm_fused_pair`` / ``build_fused_epilogue`` (the full-batch path's
aggregation). The attention pairs come with their kernels (ROADMAP.md
Queue 1, item 3).

``inner`` picks the executor everywhere: ``"cuda"`` the kernel wrappers
(which run their plain versions for CPU tensors), ``"torch"`` the plain
versions on any device — the reference a ``cuda`` plan is held against.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.graph.csr import BSRMatrix, CSRGraph, csr_to_bsr
from repro_torch.kernels.bsr_spmm import (
    bsr_spmm,
    bsr_spmm_fused_epilogue,
    bsr_spmm_masked,
)
from repro_torch.kernels.ref import (
    bsr_spmm_fused_ref,
    bsr_spmm_masked_ref,
    bsr_spmm_ref,
)

_EXECUTORS = {
    "cuda": {"spmm": bsr_spmm, "fused": bsr_spmm_fused_epilogue,
             "masked": bsr_spmm_masked},
    "torch": {"spmm": bsr_spmm_ref, "fused": bsr_spmm_fused_ref,
              "masked": bsr_spmm_masked_ref},
}


def _executor(inner: str, op: str):
    try:
        return _EXECUTORS[inner][op]
    except KeyError:
        raise ValueError(
            f"unknown inner executor {inner!r}; expected cuda|torch") from None


def feature_tile(f: int) -> tuple[int, int]:
    """(bf, f_pad): the JAX package's lane-tile policy, kept so plans and
    parity tests can name the TPU tile. The Hopper kernels mask the ragged
    feature edge themselves and never pad F."""
    bf = min(128, f) if f % 128 != 0 else 128
    f_pad = -(-f // bf) * bf
    return bf, f_pad


def _fit_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad or slice the leading axis to ``n`` rows (differentiable)."""
    if x.shape[0] == n:
        return x
    if x.shape[0] > n:
        return x[:n]
    return F.pad(x, (0, 0, 0, n - x.shape[0]))


@dataclasses.dataclass
class BSRDevice:
    """Device-resident flattened BSR + padding metadata. The kernels find
    each row's range by a search over ``block_rows`` and apply the
    epilogue at the row's end, so ``first_in_row``/``last_in_row`` are not
    carried."""

    block_rows: torch.Tensor  # [n_blocks] int32
    block_cols: torch.Tensor  # [n_blocks] int32
    blocks: torch.Tensor      # [n_blocks, br, bc] float32
    n_rows: int
    n_cols: int
    n_rows_padded: int
    n_cols_padded: int
    br: int
    bc: int

    @classmethod
    def from_bsr(cls, bsr: BSRMatrix, device=None) -> "BSRDevice":
        """Copy a host ``BSRMatrix`` to ``device`` (CUDA unless asked)."""
        dev = resolve_device(device)
        return cls(
            block_rows=torch.from_numpy(bsr.block_rows).to(dev),
            block_cols=torch.from_numpy(bsr.block_cols).to(dev),
            blocks=torch.from_numpy(bsr.blocks).to(dev),
            n_rows=bsr.n_rows, n_cols=bsr.n_cols,
            n_rows_padded=bsr.padded_rows, n_cols_padded=bsr.padded_cols,
            br=bsr.br, bc=bsr.bc,
        )

    @property
    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in (self.block_rows, self.block_cols, self.blocks)))

    def matmul(self, x: torch.Tensor, inner: str = "cuda") -> torch.Tensor:
        """Y = A @ X, unpadded in and out: x is [n_cols, F], returns
        [n_rows, F]. The row pad and slice are no-ops when x is already
        padded; F is never padded."""
        x_p = _fit_rows(x.float(), self.n_cols_padded).contiguous()
        y = _executor(inner, "spmm")(self.block_rows, self.block_cols,
                                     self.blocks, x_p, self.n_rows_padded)
        return y[: self.n_rows] if self.n_rows != self.n_rows_padded else y


def build_bsr_pair(graph: CSRGraph, br: int = 8, bc: Optional[int] = None,
                   device=None) -> tuple[BSRDevice, BSRDevice]:
    """(A, Aᵀ) as ``BSRDevice``s — the forward/backward pair, built once
    (the paper's CSR forward + CSC backward, §IV-B.b). ``bc=None`` takes
    the adaptive width (``graph.csr.adaptive_bc``)."""
    fwd = BSRDevice.from_bsr(csr_to_bsr(graph, br=br, bc=bc), device)
    bwd = BSRDevice.from_bsr(csr_to_bsr(graph.transpose(), br=br, bc=bc),
                             device)
    return fwd, bwd


class _BSRSpmmPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd_arrays, bwd_arrays, n_rows_padded, inner):
        ctx.bwd_arrays = bwd_arrays
        ctx.n_cols_padded = x.shape[0]
        ctx.inner = inner
        rows, cols, _first, blocks = fwd_arrays
        return _executor(inner, "spmm")(rows, cols, blocks, x, n_rows_padded)

    @staticmethod
    def backward(ctx, dy):
        if ctx.bwd_arrays is None:
            raise RuntimeError("bsr_spmm_pair was called without the "
                               "transposed operand; no gradient exists")
        rows, cols, _first, blocks = ctx.bwd_arrays
        dx = _executor(ctx.inner, "spmm")(rows, cols, blocks,
                                          dy.float().contiguous(),
                                          ctx.n_cols_padded)
        return dx, None, None, None, None


def bsr_spmm_pair(fwd_arrays: tuple, bwd_arrays: Optional[tuple],
                  x: torch.Tensor, n_rows_padded: int,
                  inner: str = "cuda") -> torch.Tensor:
    """Y = A @ X where (fwd_arrays, bwd_arrays) are the BSR of A and Aᵀ,
    each the 4-tuple (rows, cols, first, blocks).

    Differentiable in ``x`` only (the graph is data); the backward runs the
    same SpMM on the pre-built transposed operand, dX = Aᵀ @ dY.
    ``x`` is [n_cols_padded, F] with any F; ``bwd_arrays`` may be ``None``
    where no gradient is taken (inference), and the backward then raises.
    Both paddings must agree (the sampler aligns its caps to lcm(br, bc)).
    """
    return _BSRSpmmPair.apply(x, fwd_arrays, bwd_arrays, n_rows_padded, inner)


class _BSRSpmmFusedPair(torch.autograd.Function):
    """act(A @ x + alpha * self_term + bias) on padded operands; the
    backward of ``repro/kernels/ops.py:_fused_pair_bwd``."""

    @staticmethod
    def forward(ctx, x, self_term, bias, alpha, fwd, bwd, inner, activation):
        y, mask = _executor(inner, "fused")(
            fwd.block_rows, fwd.block_cols, fwd.blocks, x, fwd.n_rows_padded,
            self_term, bias, alpha, activation)
        ctx.save_for_backward(mask, self_term, alpha)
        ctx.fwd, ctx.bwd, ctx.inner = fwd, bwd, inner
        ctx.relu = activation == "relu"
        ctx.bias_shape = None if bias is None else bias.shape
        return y

    @staticmethod
    def backward(ctx, dy):
        mask, self_term, alpha = ctx.saved_tensors
        fwd, bwd, inner = ctx.fwd, ctx.bwd, ctx.inner
        need_x, need_self, need_bias, need_alpha = ctx.needs_input_grad[:4]
        dy = dy.float().contiguous()
        dx = dself = dbias = dalpha = None
        if need_x:
            # dY's rows re-tiled to Aᵀ's column padding, the masked (ReLU)
            # or plain SpMM on Aᵀ, then Aᵀ's row padding re-tiled to x's:
            # the two paddings need not agree (extra rows are zeros)
            t_in = -(-fwd.n_rows_padded // bwd.bc) * bwd.bc
            if ctx.relu:
                dx = _executor(inner, "masked")(
                    bwd.block_rows, bwd.block_cols, bwd.blocks,
                    _fit_rows(dy, t_in), _fit_rows(mask, t_in),
                    bwd.n_rows_padded)
            else:
                dx = _executor(inner, "spmm")(
                    bwd.block_rows, bwd.block_cols, bwd.blocks,
                    _fit_rows(dy, t_in), bwd.n_rows_padded)
            dx = _fit_rows(dx, fwd.n_cols_padded)
        if need_self or need_bias or need_alpha:
            # the epilogue's own cotangents, plain tensor ops as in JAX
            dz = dy * mask if ctx.relu else dy
            if need_self:
                dself = alpha * dz
            if need_alpha:
                dalpha = (dz * self_term).sum().reshape(alpha.shape)
            if need_bias:
                dbias = dz.sum(dim=0).reshape(ctx.bias_shape)
        return dx, dself, dbias, dalpha, None, None, None, None


def bsr_spmm_fused_pair(fwd: BSRDevice, bwd: BSRDevice, x: torch.Tensor,
                        self_term: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        alpha: Optional[torch.Tensor] = None,
                        inner: str = "cuda",
                        activation: str = "none") -> torch.Tensor:
    """Y = act(A @ X + alpha * self_term + bias) over a pre-built (A, Aᵀ)
    pair, on padded operands: x [fwd.n_cols_padded, F], self_term
    [fwd.n_rows_padded, F], bias [F], alpha a 1-element tensor (required
    with ``self_term``). Differentiable in x, self_term, bias and alpha;
    the backward runs the masked kernel on Aᵀ under a ReLU (the mask
    applied as dY loads), else the plain SpMM on Aᵀ, re-tiling dY between
    A's row padding and Aᵀ's column padding."""
    return _BSRSpmmFusedPair.apply(x, self_term, bias, alpha, fwd, bwd,
                                   inner, activation)


def build_fused_epilogue(fwd: BSRDevice, bwd: BSRDevice, inner: str):
    """Differentiable fused-epilogue closure over a (A, Aᵀ) pair — the op
    behind ``spmm_fused_epilogue`` on the ``cuda`` and ``torch`` backends.

    Returns ``fused(u, self_term=None, bias=None, alpha=None,
    activation="none")`` computing ``act(A @ u + alpha * self_term +
    bias)`` on unpadded [n_cols, F] -> [n_rows, F]; rows are padded and
    sliced at this boundary, F never is.
    """
    _executor(inner, "fused")  # validates inner now, not at the first call

    def fused(u, self_term=None, bias=None, alpha=None, activation="none"):
        u_p = _fit_rows(u.float(), fwd.n_cols_padded).contiguous()
        s_p = a = None
        if self_term is not None:
            s_p = _fit_rows(self_term.float(), fwd.n_rows_padded).contiguous()
            if alpha is None:
                a = torch.ones(1, dtype=torch.float32, device=u.device)
            else:
                a = torch.as_tensor(alpha, dtype=torch.float32,
                                    device=u.device).reshape(1)
        b = None if bias is None else bias.float().contiguous()
        y = bsr_spmm_fused_pair(fwd, bwd, u_p, s_p, b, a, inner, activation)
        return y[: fwd.n_rows] if fwd.n_rows != fwd.n_rows_padded else y

    return fused
