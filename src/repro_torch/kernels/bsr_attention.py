"""Edge-softmax attention over a BSR adjacency: the forward and the two
passes of its recompute backward.

The port of ``repro/kernels/bsr_attention.py``'s three Pallas TPU kernels:

* ``bsr_attention_fwd`` (``pallas_call`` at :133): per head, scores
  ``leaky_relu(adst_i + asrc_j, 0.2)`` over each row's nonzeros, a
  softmax per row and the weighted aggregate of z; returns the
  normalised output and the rows' (max, denominator) statistics;
* ``bsr_attention_bwd_row`` (:190): ``dc_i = Σ_j dpre_ij`` over A, the
  weights recomputed from (m, l);
* ``bsr_attention_bwd_col`` (:267): ``dzv_j = Σ_i att_ij dy_i`` and
  ``dd_j = Σ_i dpre_ij`` over Aᵀ.

For CUDA tensors each wrapper launches its hand-written Hopper kernel
(``kernels/csrc/bsr_attention.cu``, no atomics, bitwise repeatable). Each
kernel walks its operand's ``NonzeroColumns`` (``kernels/bsr_spmm.py``,
the SpMM kernels' operand, built once per operand), not its blocks: the
forward and the row pass A's, the column pass Aᵀ's. One CTA takes one
work item (a block-row, or one segment of a hub row) across the whole
H·Dh width, and a second pass combines a split row's segments in order.
A CUDA call takes the columns as ``nzc=`` and raises without them. For
CPU tensors each wrapper runs the plain version in ``kernels/ref.py`` and
ignores ``nzc``. There is no fallback between the two: a CUDA call that
cannot launch raises. The block values are the adjacency mask only
(value != 0). Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.bsr_spmm import (
    _I,
    _INDEX_NAMES,
    _NZC_ARGTYPES,
    _P,
    NonzeroColumns,
    _check_nzc,
    _entry,
    _nzc_args,
    _nzc_tensors,
    _partial,
    _raise_on,
    _require_nzc,
    _stream,
)
from repro_torch.kernels.ref import (
    bsr_attention_bwd_col_ref,
    bsr_attention_bwd_row_ref,
    bsr_attention_fwd_ref,
)

#: block-row heights the kernels instantiate
BRS = (8, 16)


def _check(block_rows, block_cols, blocks, heads, row_ops: dict,
           col_ops: dict, n_rows_padded: int) -> int:
    """Shape checks shared by the plain versions and the kernels; returns
    the head width Dh. ``row_ops`` are indexed by the stream's block rows
    (``n_rows_padded`` rows), ``col_ops`` by its block columns (rows a
    multiple of bc); each is [rows, H] or [rows, H*Dh]."""
    if blocks.dim() != 3:
        raise ValueError(f"blocks must be [n_blocks, br, bc], got {tuple(blocks.shape)}")
    n_blocks, br, bc = blocks.shape
    if block_rows.shape != (n_blocks,) or block_cols.shape != (n_blocks,):
        raise ValueError(f"block_rows/block_cols must be [{n_blocks}], got "
                         f"{tuple(block_rows.shape)}/{tuple(block_cols.shape)}")
    if n_rows_padded < 0 or n_rows_padded % br != 0:
        raise ValueError(f"n_rows_padded={n_rows_padded} must be a multiple "
                         f"of br={br}")
    wide = [t for t in (*row_ops.values(), *col_ops.values())
            if t.dim() == 2 and t.shape[1] != heads]
    hd = wide[0].shape[1] if wide else heads
    if heads <= 0 or hd % heads != 0:
        raise ValueError(f"H*Dh={hd} is not a multiple of heads={heads}")
    n_cols = next(iter(col_ops.values())).shape[0]
    if n_cols % bc != 0:
        raise ValueError(f"column-side operands need rows padded to bc={bc}, "
                         f"got {n_cols}")
    for side, ops, n in (("row", row_ops, n_rows_padded), ("column", col_ops, n_cols)):
        for name, t in ops.items():
            if t.dim() != 2 or t.shape[0] != n or t.shape[1] not in (heads, hd):
                raise ValueError(f"{name} ({side} side) must be [{n}, {heads}] "
                                 f"or [{n}, {hd}], got {tuple(t.shape)}")
    device = next(iter(col_ops.values())).device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the attention kernels run on cuda or cpu tensors, "
                         f"got {device}")
    return hd // heads


def _check_launch(nzc: NonzeroColumns, **tensors) -> None:
    """What the CUDA kernels take: every operand (and the columns ``nzc``)
    on one card, int32 indices, float32 values, contiguous; a built block
    height."""
    tensors.update(_nzc_tensors(nzc))
    device = tensors["z"].device
    for name, t in tensors.items():
        dtype = torch.int32 if name in _INDEX_NAMES else torch.float32
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, z on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nzc.br not in BRS:
        raise ValueError(f"block height {nzc.br} is not built; built: {BRS}")


def _launch(name: str, symbol: str, nzc: NonzeroColumns, slot_row: int,
            tensors: tuple, ints: tuple, device) -> None:
    """Launch ``symbol`` of the attention library over ``nzc``: its work
    list, split rows and columns, scratch of ``slot_row`` floats a row of
    a split row's slot, then ``tensors`` (device pointers) and ``ints``."""
    partial = _partial(nzc, slot_row, device)
    fn = _entry("bsr_attention", symbol,
                _NZC_ARGTYPES + (_P,) * len(tensors) + (_I,) * len(ints) + (_P,))
    with torch.cuda.device(device):
        err = fn(*_nzc_args(nzc, partial), *(t.data_ptr() for t in tensors),
                 *ints, _stream(device))
    _raise_on(err, name)


def bsr_attention_fwd(
    block_rows: torch.Tensor,  # [n_blocks] int32 (sorted)
    block_cols: torch.Tensor,  # [n_blocks] int32
    blocks: torch.Tensor,  # [n_blocks, BR, BC] float32; value != 0 is an edge
    adst: torch.Tensor,  # [n_rows_padded, H] a_dst·z_i
    asrc: torch.Tensor,  # [n_cols_padded, H] a_src·z_j
    z: torch.Tensor,  # [n_cols_padded, H*Dh] head-major
    n_rows_padded: int,
    heads: int,
    nzc: Optional[NonzeroColumns] = None,
):
    """Fused edge softmax + aggregation over A. Returns ``(out
    [n_rows_padded, H*Dh], m [n_rows_padded, H], l [n_rows_padded, H])``:
    out already normalised, (m, l) each row's softmax max and denominator
    for the recompute backward (m = 0 on rows without a nonzero).

    The stream contract is ``bsr_spmm``'s: rows sorted, each row's
    block-columns increasing, zero padding blocks trailing. The kernel
    reads A's ``nzc`` (``nonzero_columns`` of these blocks, built once per
    operand: ``BSRDevice.nonzero_columns()``, which
    ``kernels/ops.py:build_sparse_mha`` calls at bind time), not the
    blocks; a CUDA call requires it. CPU calls run the plain version,
    ignore ``nzc`` and do not count as launches."""
    dh = _check(block_rows, block_cols, blocks, heads, {"adst": adst},
                {"asrc": asrc, "z": z}, n_rows_padded)
    if nzc is not None:
        _check_nzc(nzc, blocks.shape[1], n_rows_padded)
    if z.device.type == "cpu":
        return bsr_attention_fwd_ref(block_rows, block_cols, blocks, adst,
                                     asrc, z, n_rows_padded, heads)
    _require_nzc(nzc)
    _check_launch(nzc, block_rows=block_rows, block_cols=block_cols,
                  blocks=blocks, adst=adst, asrc=asrc, z=z)
    br = nzc.br
    dev = z.device
    out = torch.empty((n_rows_padded, heads * dh), dtype=torch.float32, device=dev)
    m = torch.empty((n_rows_padded, heads), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    if n_rows_padded == 0:
        return out, m, l
    # a split row's slot: its unnormalised out, then m and l
    _launch("bsr_attention_fwd", "bsr_attention_fwd_f32", nzc,
            heads * dh + 2 * heads, (adst, asrc, z, out, m, l),
            (heads, dh, br), dev)
    bsr_attention_fwd.launches += 1
    return out, m, l


def bsr_attention_bwd_row(
    block_rows: torch.Tensor,
    block_cols: torch.Tensor,
    blocks: torch.Tensor,
    adst: torch.Tensor,  # [n_rows_padded, H]
    asrc: torch.Tensor,  # [n_cols_padded, H]
    z: torch.Tensor,  # [n_cols_padded, H*Dh]
    dy: torch.Tensor,  # [n_rows_padded, H*Dh]
    r: torch.Tensor,  # [n_rows_padded, H] = Σ_d dy·out
    m: torch.Tensor,  # [n_rows_padded, H]
    l: torch.Tensor,  # [n_rows_padded, H]
    n_rows_padded: int,
    heads: int,
    nzc: Optional[NonzeroColumns] = None,
) -> torch.Tensor:
    """Row pass of the recompute backward over A: ``dc [n_rows_padded, H]``,
    the destination-side score cotangent.

    The kernel reads A's ``nzc``, as the forward does; a CUDA call
    requires it, and a block-row's dy rows (``br·H·Dh`` floats, staged per
    CTA) must fit in a CTA's shared memory, else the launch fails. CPU
    calls run the plain version, ignore ``nzc`` and do not count as
    launches."""
    dh = _check(block_rows, block_cols, blocks, heads,
                {"adst": adst, "dy": dy, "r": r, "m": m, "l": l},
                {"asrc": asrc, "z": z}, n_rows_padded)
    if nzc is not None:
        _check_nzc(nzc, blocks.shape[1], n_rows_padded)
    if z.device.type == "cpu":
        return bsr_attention_bwd_row_ref(block_rows, block_cols, blocks, adst,
                                         asrc, z, dy, r, m, l, n_rows_padded,
                                         heads)
    _require_nzc(nzc)
    _check_launch(nzc, block_rows=block_rows, block_cols=block_cols,
                  blocks=blocks, adst=adst, asrc=asrc, z=z, dy=dy, r=r, m=m, l=l)
    br = nzc.br
    dc = torch.empty((n_rows_padded, heads), dtype=torch.float32, device=z.device)
    if n_rows_padded == 0:
        return dc
    _launch("bsr_attention_bwd_row", "bsr_attention_bwd_row_f32", nzc,
            heads, (adst, asrc, z, dy, r, m, l, dc),
            (heads, dh, br, int(dy.data_ptr() % 16 == 0)), z.device)
    bsr_attention_bwd_row.launches += 1
    return dc


def bsr_attention_bwd_col(
    block_rows: torch.Tensor,  # of Aᵀ: rows are sources
    block_cols: torch.Tensor,  # of Aᵀ: columns are destinations
    blocks: torch.Tensor,
    asrc: torch.Tensor,  # [n_rows_padded, H] source side
    adst: torch.Tensor,  # [n_cols_padded, H] destination side
    z: torch.Tensor,  # [n_rows_padded, H*Dh] source side
    dy: torch.Tensor,  # [n_cols_padded, H*Dh] destination side
    r: torch.Tensor,  # [n_cols_padded, H]
    m: torch.Tensor,  # [n_cols_padded, H]
    l: torch.Tensor,  # [n_cols_padded, H]
    n_rows_padded: int,
    heads: int,
    nzc: Optional[NonzeroColumns] = None,
):
    """Column pass of the recompute backward over Aᵀ: ``(dzv
    [n_rows_padded, H*Dh], dd [n_rows_padded, H])`` on the source side.
    Operands indexed by Aᵀ's block rows live on the source side (asrc, z),
    those indexed by its block columns on the destination side (adst, dy,
    r, m, l). The kernel reads Aᵀ's ``nzc`` (its destinations), built once
    per operand as A's is; a CUDA call requires it. One launch computes
    both outputs, each dy row read once. CPU calls run the plain version,
    ignore ``nzc`` and do not count as launches."""
    dh = _check(block_rows, block_cols, blocks, heads, {"asrc": asrc, "z": z},
                {"adst": adst, "dy": dy, "r": r, "m": m, "l": l},
                n_rows_padded)
    if nzc is not None:
        _check_nzc(nzc, blocks.shape[1], n_rows_padded)
    if z.device.type == "cpu":
        return bsr_attention_bwd_col_ref(block_rows, block_cols, blocks, asrc,
                                         adst, z, dy, r, m, l, n_rows_padded,
                                         heads)
    _require_nzc(nzc)
    _check_launch(nzc, block_rows=block_rows, block_cols=block_cols,
                  blocks=blocks, asrc=asrc, adst=adst, z=z, dy=dy, r=r, m=m, l=l)
    br = nzc.br
    dev = z.device
    dzv = torch.empty((n_rows_padded, heads * dh), dtype=torch.float32, device=dev)
    dd = torch.empty((n_rows_padded, heads), dtype=torch.float32, device=dev)
    if n_rows_padded == 0:
        return dzv, dd
    # a split row's slot: its partial dzv, then dd
    _launch("bsr_attention_bwd_col", "bsr_attention_bwd_col_f32", nzc,
            heads * dh + heads, (asrc, adst, z, dy, r, m, l, dzv, dd),
            (heads, dh, br), dev)
    bsr_attention_bwd_col.launches += 1
    return dzv, dd


bsr_attention_fwd.launches = 0
bsr_attention_bwd_row.launches = 0
bsr_attention_bwd_col.launches = 0
