"""Differentiable wrappers around the port's kernels.

Counterpart of ``repro/kernels/ops.py``: ``feature_tile``, the device
operand ``BSRDevice`` and ``build_bsr_pair``, ``bsr_spmm_pair`` (the
sampled path's SpMM with its Aᵀ backward) and the fused-epilogue pair
``bsr_spmm_fused_pair`` / ``build_fused_epilogue`` (the full-batch path's
aggregation), and the fused attention pair ``sparse_mha_pair`` /
``build_sparse_mha`` (GAT and GT, DESIGN.md §10); and the LM's prefill
attention, ``"flash"`` (``models/attention.py``), which needs no gradient.

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
from repro_torch.kernels.bsr_attention import (
    bsr_attention_bwd_col,
    bsr_attention_bwd_row,
    bsr_attention_fwd,
)
from repro_torch.kernels.bsr_spmm import (
    NonzeroColumns,
    bsr_spmm,
    bsr_spmm_fused_epilogue,
    bsr_spmm_masked,
    nonzero_columns,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import (
    bsr_attention_bwd_col_ref,
    bsr_attention_bwd_row_ref,
    bsr_attention_fwd_ref,
    bsr_spmm_fused_ref,
    bsr_spmm_masked_ref,
    bsr_spmm_ref,
    flash_attention_ref,
)

_EXECUTORS = {
    "cuda": {"spmm": bsr_spmm, "fused": bsr_spmm_fused_epilogue,
             "masked": bsr_spmm_masked, "attn_fwd": bsr_attention_fwd,
             "attn_row": bsr_attention_bwd_row,
             "attn_col": bsr_attention_bwd_col, "flash": flash_attention},
    "torch": {"spmm": bsr_spmm_ref, "fused": bsr_spmm_fused_ref,
              "masked": bsr_spmm_masked_ref, "attn_fwd": bsr_attention_fwd_ref,
              "attn_row": bsr_attention_bwd_row_ref,
              "attn_col": bsr_attention_bwd_col_ref,
              "flash": flash_attention_ref},
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
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, n - x.shape[0]))


@dataclasses.dataclass
class BSRDevice:
    """Device-resident flattened BSR + padding metadata. The kernels find
    each row's range themselves (the work list ``nzc.items``) and apply
    the epilogue at the row's end, so ``first_in_row``/``last_in_row``
    are not carried. ``nzc``, the operand's nonzero columns that every
    BSR kernel reads (the three SpMM kernels and the three attention
    passes), is built once by ``nonzero_columns()``."""

    block_rows: torch.Tensor  # [n_blocks] int32
    block_cols: torch.Tensor  # [n_blocks] int32
    blocks: torch.Tensor      # [n_blocks, br, bc] float32
    n_rows: int
    n_cols: int
    n_rows_padded: int
    n_cols_padded: int
    br: int
    bc: int
    nzc: Optional[NonzeroColumns] = dataclasses.field(default=None, repr=False)

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
        """Bytes on the device: the blocks and their indices, and ``nzc``
        once built."""
        return int(sum(t.numel() * t.element_size()
                       for t in (self.block_rows, self.block_cols, self.blocks))
                   + (0 if self.nzc is None else self.nzc.nbytes))

    def nonzero_columns(self) -> NonzeroColumns:
        """The operand's ``NonzeroColumns``, built on its device at the
        first call and kept."""
        if self.nzc is None:
            self.nzc = nonzero_columns(self.block_rows, self.block_cols,
                                       self.blocks, self.n_rows_padded)
        return self.nzc

    def matmul(self, x: torch.Tensor, inner: str = "cuda") -> torch.Tensor:
        """Y = A @ X, unpadded in and out: x is [n_cols, F], returns
        [n_rows, F]. The row pad and slice are no-ops when x is already
        padded; F is never padded. The ``cuda`` executor reads the
        operand's nonzero columns (built at the first call where the op's
        binding did not build them)."""
        x_p = _fit_rows(x.float(), self.n_cols_padded).contiguous()
        y = _executor(inner, "spmm")(self.block_rows, self.block_cols,
                                     self.blocks, x_p, self.n_rows_padded,
                                     **_nzc_kw(inner, self.nonzero_columns))
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


def _nzc_kw(inner: str, build) -> dict:
    """``nzc=``, the operand's nonzero columns from ``build()``, for the
    ``cuda`` executor; the ``torch`` one reads none and builds none."""
    return {"nzc": build()} if inner == "cuda" else {}


def _arrays_spmm(arrays: tuple, x: torch.Tensor, n_rows_padded: int,
                 inner: str) -> torch.Tensor:
    """Y = A @ X on a per-batch 4-tuple operand, its nonzero columns built
    for the call (the operand is used once)."""
    rows, cols, _first, blocks = arrays
    return _executor(inner, "spmm")(
        rows, cols, blocks, x, n_rows_padded, **_nzc_kw(
            inner, lambda: nonzero_columns(rows, cols, blocks, n_rows_padded)))


class _BSRSpmmPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd_arrays, bwd_arrays, n_rows_padded, inner):
        ctx.bwd_arrays = bwd_arrays
        ctx.n_cols_padded = x.shape[0]
        ctx.inner = inner
        return _arrays_spmm(fwd_arrays, x, n_rows_padded, inner)

    @staticmethod
    def backward(ctx, dy):
        if ctx.bwd_arrays is None:
            raise RuntimeError("bsr_spmm_pair was called without the "
                               "transposed operand; no gradient exists")
        dx = _arrays_spmm(ctx.bwd_arrays, dy.float().contiguous(),
                          ctx.n_cols_padded, ctx.inner)
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
    For the ``cuda`` executor each operand's ``NonzeroColumns`` is built
    on its device where its product runs: the sampled path binds a pair
    per batch and layer and calls it once, so once per batch and layer
    (its host syncs included, ``nonzero_columns``).
    """
    return _BSRSpmmPair.apply(x, fwd_arrays, bwd_arrays, n_rows_padded, inner)


class _BSRSpmmFusedPair(torch.autograd.Function):
    """act(A @ x + alpha * self_term + bias) on padded operands; the
    backward of ``repro/kernels/ops.py:_fused_pair_bwd``."""

    @staticmethod
    def forward(ctx, x, self_term, bias, alpha, fwd, bwd, inner, activation):
        y, mask = _executor(inner, "fused")(
            fwd.block_rows, fwd.block_cols, fwd.blocks, x, fwd.n_rows_padded,
            self_term, bias, alpha, activation,
            **_nzc_kw(inner, fwd.nonzero_columns))
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
                    bwd.n_rows_padded, **_nzc_kw(inner, bwd.nonzero_columns))
            else:
                dx = _executor(inner, "spmm")(
                    bwd.block_rows, bwd.block_cols, bwd.blocks,
                    _fit_rows(dy, t_in), bwd.n_rows_padded,
                    **_nzc_kw(inner, bwd.nonzero_columns))
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
    sliced at this boundary, F never is. For ``cuda`` both operands'
    nonzero columns are built here, once, so the operands' ``nbytes``
    count them and no training step pays for them.
    """
    _executor(inner, "fused")  # validates inner now, not at the first call
    if inner == "cuda":
        fwd.nonzero_columns()
        bwd.nonzero_columns()

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


# ---------------------------------------------------------------------------
# Fused sparse multi-head attention pair (DESIGN.md §10): edge softmax and
# aggregation in one kernel, the VJP recomputing the weights from the saved
# per-row (max, denominator) statistics
# ---------------------------------------------------------------------------

def _c(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous()


class _SparseMHAPair(torch.autograd.Function):
    """The counterpart of ``repro/kernels/ops.py:sparse_mha_pair`` and its
    ``_mha_fwd`` / ``_mha_bwd``. ``geom = (n_dst, n_src, n_rows_padded,
    n_cols_padded, nT_rows_padded, nT_cols_padded)``; destinations are the
    leading ``n_dst`` rows of the source ordering. Every operand is
    re-tiled to the padding of the stream that reads it (``_fit_rows``), so
    A and Aᵀ may pad differently. The Hopper kernels mask the ragged head
    width, so heads are never padded (the JAX package pads them to its
    lane tile, which only adds zero columns)."""

    @staticmethod
    def forward(ctx, z, a_src, a_dst, fwd, bwd, geom, inner):
        n_dst, n_src, nr_pad, nc_pad, _, _ = geom
        h, dh = z.shape[1], z.shape[2]
        z32 = z.float()
        asrc = torch.einsum("nhd,hd->nh", z32, a_src.float())
        adst = torch.einsum("nhd,hd->nh", z32, a_dst.float())
        out, m, l = _executor(inner, "attn_fwd")(
            fwd.block_rows, fwd.block_cols, fwd.blocks,
            _c(_fit_rows(adst[:n_dst], nr_pad)), _c(_fit_rows(asrc, nc_pad)),
            _c(_fit_rows(z32, nc_pad).reshape(nc_pad, h * dh)), nr_pad, h,
            **_nzc_kw(inner, fwd.nonzero_columns))
        out = out.reshape(nr_pad, h, dh)[:n_dst]
        m, l = m[:n_dst], l[:n_dst]
        ctx.save_for_backward(z32, a_src, a_dst, out, m, l, asrc, adst)
        ctx.fwd, ctx.bwd, ctx.geom, ctx.inner = fwd, bwd, geom, inner
        ctx.dtypes = (z.dtype, a_src.dtype, a_dst.dtype)
        return out.to(z.dtype)

    @staticmethod
    def backward(ctx, dy):
        z32, a_src, a_dst, out, m, l, asrc, adst = ctx.saved_tensors
        fwd, bwd, inner = ctx.fwd, ctx.bwd, ctx.inner
        n_dst, n_src, nr_pad, nc_pad, nt_r, nt_c = ctx.geom
        h, dh = z32.shape[1], z32.shape[2]
        hd = h * dh
        dy = dy.float()
        r = torch.einsum("nhd,nhd->nh", dy, out)
        adst_d = adst[:n_dst]
        dc = _executor(inner, "attn_row")(
            fwd.block_rows, fwd.block_cols, fwd.blocks,
            _c(_fit_rows(adst_d, nr_pad)), _c(_fit_rows(asrc, nc_pad)),
            _c(_fit_rows(z32, nc_pad).reshape(nc_pad, hd)),
            _c(_fit_rows(dy, nr_pad).reshape(nr_pad, hd)),
            _c(_fit_rows(r, nr_pad)), _c(_fit_rows(m, nr_pad)),
            _c(_fit_rows(l, nr_pad)), nr_pad, h,
            **_nzc_kw(inner, fwd.nonzero_columns))[:n_dst]
        dzv, dd = _executor(inner, "attn_col")(
            bwd.block_rows, bwd.block_cols, bwd.blocks,
            _c(_fit_rows(asrc, nt_r)), _c(_fit_rows(adst_d, nt_c)),
            _c(_fit_rows(z32, nt_r).reshape(nt_r, hd)),
            _c(_fit_rows(dy, nt_c).reshape(nt_c, hd)),
            _c(_fit_rows(r, nt_c)), _c(_fit_rows(m, nt_c)),
            _c(_fit_rows(l, nt_c)), nt_r, h,
            **_nzc_kw(inner, bwd.nonzero_columns))
        dzv = dzv.reshape(nt_r, h, dh)[:n_src]
        dd = dd[:n_src]
        a_src32, a_dst32 = a_src.float(), a_dst.float()
        # dz = value path + score path: dd (source side) rides a_src, dc
        # (destination side) a_dst on the leading n_dst rows
        dz = (dzv + dd[..., None] * a_src32[None]
              + _fit_rows(dc, n_src)[..., None] * a_dst32[None])
        da_src = torch.einsum("nh,nhd->hd", dd, z32)
        da_dst = torch.einsum("nh,nhd->hd", dc, z32[:n_dst])
        zt, st, dt = ctx.dtypes
        return (dz.to(zt), da_src.to(st), da_dst.to(dt), None, None, None,
                None)


def sparse_mha_pair(fwd: BSRDevice, bwd: BSRDevice, z: torch.Tensor,
                    a_src: torch.Tensor, a_dst: torch.Tensor, geom: tuple,
                    inner: str = "cuda") -> torch.Tensor:
    """``out_i = Σ_j softmax_j(leaky_relu(a_dst·z_i + a_src·z_j)) z_j`` per
    head over the nonzero pattern of A (``fwd``), with the backward's
    column pass over Aᵀ (``bwd``). Differentiable in ``z [n_src, H, Dh]``,
    ``a_src [H, Dh]`` and ``a_dst [H, Dh]``; returns ``[n_dst, H, Dh]``.
    The residuals are O(N·H) row statistics, not the O(E·H) weights."""
    return _SparseMHAPair.apply(z, a_src, a_dst, fwd, bwd, geom, inner)


def build_sparse_mha(fwd: BSRDevice, bwd: BSRDevice, inner: str):
    """Differentiable fused-attention closure over a (A, Aᵀ) pair — the op
    behind the registry's ``sparse_mha`` / ``spmm_attention`` on the
    ``cuda`` and ``torch`` backends. Returns ``mha(z, a_src, a_dst)`` on
    unpadded ``z [n_src, H, Dh]`` -> ``[n_dst, H, Dh]``. For ``cuda`` the
    nonzero columns of A (the forward and the row pass read them) and of
    Aᵀ (the column pass) are built here, once (shared with any SpMM on
    them), so no training step pays for them."""
    _executor(inner, "attn_fwd")  # validates inner now, not at the first call
    if inner == "cuda":
        fwd.nonzero_columns()
        bwd.nonzero_columns()
    geom = (fwd.n_rows, fwd.n_cols, fwd.n_rows_padded, fwd.n_cols_padded,
            bwd.n_rows_padded, bwd.n_cols_padded)

    def mha(z, a_src, a_dst):
        return sparse_mha_pair(fwd, bwd, z, a_src, a_dst, geom, inner)

    return mha
