"""Block-sparse-row SpMM family: Y = act(A·(M ⊙ X) + α·self + bias) over a
flattened BSR stream.

The port of ``repro/kernels/bsr_spmm.py``'s three Pallas TPU kernels:

* ``bsr_spmm`` (``pallas_call`` at :105): Y = A·X;
* ``bsr_spmm_fused_epilogue`` (:245): the epilogue α·self + bias and an
  optional ReLU (with its 0/1 mask) applied where the row's sum finishes;
* ``bsr_spmm_masked`` (:312): Y = A·(mask ⊙ X), the ReLU epilogue's VJP.

For CUDA tensors each wrapper launches its hand-written Hopper kernel
(``kernels/csrc/bsr_spmm*.cu``, no atomics, bitwise repeatable); for CPU
tensors it runs the plain version in ``kernels/ref.py``. There is no
fallback between the two: a CUDA call that cannot launch raises. All three
kernels walk only the block columns that hold a nonzero (the one loop of
``bsr_nzc.cuh``), from a ``NonzeroColumns`` operand built once per BSR
operand (``nonzero_columns``): a CUDA call takes it as ``nzc=`` and raises
without it; a CPU call ignores it. The ``.cuh`` notes say what bounds the
kernels; PERF.md has their times. Each wrapper counts its launches in
``.launches``.

Non-finite X. The kernels give the sparse product, the answer of the JAX
package's ``gather`` backend (a segment sum over the edges): an X row
that no nonzero of A multiplies is never read, so an inf or NaN in it
reaches no output. The Pallas kernel multiplies whole blocks, and so do
the plain versions here: there such a row meets its block's stored zeros
and gives NaN on every row of the block-row (0·inf = NaN). A row that a
nonzero multiplies is read for its whole block column, on every backend
and kernel, so its inf or NaN reaches that nonzero's row (and, through
stored zeros, the block's other rows).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels.ref import (
    bsr_spmm_fused_ref,
    bsr_spmm_masked_ref,
    bsr_spmm_ref,
)

#: the (br, bc) tiles the tests and ``chip_smoke.py`` sweep: the JAX
#: package's tiles at br 8 and 16
TILES = ((8, 8), (8, 16), (8, 32), (8, 64), (8, 128), (16, 16), (16, 32),
         (16, 64))
#: the block heights the kernels are built for
#: (``csrc/bsr_nzc.cuh:NZC_FOR_EACH_BR``); they take any bc
BUILT_BR = (8, 16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_INDEX_NAMES = ("block_rows", "block_cols", "items", "splits", "x_rows")


#: columns one CTA takes from a block-row: a longer row (a hub) is split
#: into segments of this many columns, one CTA each, whose partial sums a
#: second pass adds in segment order
SPLIT_COLUMNS = 1024


@dataclasses.dataclass(frozen=True)
class NonzeroColumns:
    """The block columns of a BSR operand that hold a nonzero, in stream
    order (block, then column k within it): what the three SpMM kernels
    read instead of the blocks, with the CTAs' work list.
    About 4·(br + 1) bytes a column (36 at br=8) against 4·br·bc a block;
    a full-graph 8x128 block of ogbn-arxiv's A keeps ~1.4 of its 128.

    ``items`` holds one (block_row, begin, end, slot) a CTA, longest span
    first: a block-row's span of the column stream, or one segment of a
    row longer than the split, whose partial sums go to ``slot`` (else
    -1). ``splits`` holds one (block_row, first_slot, n_slots) per split
    row, for the ordered second pass."""

    items: torch.Tensor   # [n_items, 4] int32
    splits: torch.Tensor  # [n_split, 3] int32
    x_rows: torch.Tensor  # [n] int32: the X row block_col·bc + k of a column
    values: torch.Tensor  # [n, br] float32: the column's br values
    n_block_rows: int
    n_slots: int          # segments of split rows: partial sums per call

    @property
    def br(self) -> int:
        return self.values.shape[1]

    @property
    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in
                       (self.items, self.splits, self.x_rows, self.values)))

    def columns_per_row(self) -> torch.Tensor:
        """int64 [n_block_rows]: each block-row's nonzero columns."""
        it = self.items.long()
        return torch.zeros(self.n_block_rows, dtype=torch.int64,
                           device=it.device).index_add_(0, it[:, 0], it[:, 2] - it[:, 1])


def nonzero_columns(block_rows: torch.Tensor, block_cols: torch.Tensor,
                    blocks: torch.Tensor, n_rows_padded: int) -> NonzeroColumns:
    """Build the ``NonzeroColumns`` of a flattened BSR operand with torch
    ops on its device, once per operand. A column none of whose ``br``
    values is nonzero gives no entry: the sampler's zero padding tail and
    the explicit zero block of an empty block-row give none (the row keeps
    an empty item, which writes its epilogue). A row of more than
    ``SPLIT_COLUMNS`` columns becomes segments of that many. Needs the blocks
    sorted by block-row, as ``csr_to_bsr`` and the sampler give them; the
    blocks' own order within a row is kept. Its sizes depend on the data,
    so on the card the build waits for the device a few times
    (``.nonzero()``, ``bincount``, ``repeat_interleave``, ``int``):
    negligible once per full-batch operand, paid once per batch and layer
    on the sampled path."""
    n_blocks, br, bc = blocks.shape
    n_brows = n_rows_padded // br
    dev = blocks.device
    held = blocks.ne(0).any(dim=1)  # [n_blocks, bc]
    b, k = held.nonzero(as_tuple=True)  # row-major: the stream order
    counts = torch.bincount(block_rows.long()[b], minlength=n_brows)
    if counts.numel() != n_brows:
        raise ValueError(f"a block-row index lies past n_rows_padded="
                         f"{n_rows_padded} (br={br})")
    if b.numel() >= 2**31:
        raise ValueError("the column stream does not fit int32 indices")
    split = SPLIT_COLUMNS
    row_start = counts.cumsum(0) - counts
    is_split = counts > split
    n_seg = torch.where(is_split, -(-counts // split), torch.ones_like(counts))
    item_row = torch.repeat_interleave(torch.arange(n_brows, device=dev), n_seg)
    seg_start = n_seg.cumsum(0) - n_seg
    seg = torch.arange(item_row.numel(), device=dev) - seg_start[item_row]
    begin = row_start[item_row] + seg * split
    end = torch.minimum(begin + split, row_start[item_row] + counts[item_row])
    slot_base = torch.where(is_split, n_seg, 0).cumsum(0) - torch.where(is_split, n_seg, 0)
    slot = torch.where(is_split[item_row], slot_base[item_row] + seg, -1)
    order = torch.argsort(end - begin, descending=True, stable=True)
    split_rows = is_split.nonzero().flatten()
    return NonzeroColumns(
        items=torch.stack([item_row, begin, end, slot], 1)[order].int().contiguous(),
        splits=torch.stack([split_rows, slot_base[split_rows], n_seg[split_rows]],
                           1).int().contiguous(),
        x_rows=(block_cols.long()[b] * bc + k).int(),
        values=blocks[b, :, k].float().contiguous(),
        n_block_rows=n_brows,
        n_slots=int(n_seg[split_rows].sum()))


def _require_nzc(nzc: Optional[NonzeroColumns]) -> None:
    """A CUDA call reads the operand's nonzero columns, built once per
    operand; it never builds them itself (that reads every block)."""
    if nzc is None:
        raise ValueError("a CUDA call needs nzc=, the operand's nonzero "
                         "columns built once: BSRDevice.nonzero_columns() "
                         "or nonzero_columns(...)")


def _check_nzc(nzc: NonzeroColumns, br: int, n_rows_padded: int) -> None:
    if nzc.br != br or nzc.n_block_rows != n_rows_padded // br:
        raise ValueError(
            f"nzc holds {nzc.n_block_rows} block-rows of height "
            f"{nzc.br}; the operand has {n_rows_padded // br} of height {br}")
    if nzc.values.data_ptr() % 16 != 0 or nzc.items.data_ptr() % 16 != 0:
        raise ValueError("nzc.values and nzc.items must be 16-byte aligned "
                         "(the kernels load them as int4 / float4)")


@functools.cache
def _entry(name: str, symbol: str, argtypes: tuple):
    from repro_torch.kernels.build import load_library

    fn = getattr(load_library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _check(block_rows, block_cols, blocks, x, n_rows_padded):
    if blocks.dim() != 3 or x.dim() != 2:
        raise ValueError(f"blocks must be [n_blocks, br, bc] and x [n_cols, F], "
                         f"got {tuple(blocks.shape)} and {tuple(x.shape)}")
    n_blocks, br, bc = blocks.shape
    if block_rows.shape != (n_blocks,) or block_cols.shape != (n_blocks,):
        raise ValueError(f"block_rows/block_cols must be [{n_blocks}], got "
                         f"{tuple(block_rows.shape)}/{tuple(block_cols.shape)}")
    if x.shape[0] % bc != 0:
        raise ValueError("x rows must be padded to the block-column size")
    if n_rows_padded < 0 or n_rows_padded % br != 0:
        raise ValueError(f"n_rows_padded={n_rows_padded} must be a multiple "
                         f"of br={br}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the BSR kernels run on cuda or cpu tensors, got "
                         f"{x.device}")


def _check_launch(**tensors):
    """What the CUDA kernels take: every operand on x's card, int32
    indices, float32 values, contiguous; and a built block height."""
    device = tensors["x"].device
    for name, t in tensors.items():
        if t is None:
            continue
        dtype = torch.int32 if name in _INDEX_NAMES else torch.float32
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    br = tensors["blocks"].shape[1]
    if br not in BUILT_BR:
        raise ValueError(f"block height {br} is not built; built: {BUILT_BR}")


def _nzc_tensors(nzc: NonzeroColumns) -> dict:
    return {"items": nzc.items, "splits": nzc.splits, "x_rows": nzc.x_rows,
            "values": nzc.values}


#: the C types of ``_nzc_args``: the three entry points take them first
_NZC_ARGTYPES = (_P, _I, _P, _I, _P, _P, _P)


def _partial(nzc: NonzeroColumns, f: int, device) -> Optional[torch.Tensor]:
    """Scratch for the split rows' partial sums, [n_slots, br, f]."""
    if nzc.n_slots == 0:
        return None
    return torch.empty((nzc.n_slots, nzc.br, f), dtype=torch.float32,
                       device=device)


def _nzc_args(nzc: NonzeroColumns, partial: Optional[torch.Tensor]) -> tuple:
    """The operand's launch arguments: the work list, the split rows, the
    columns and the split rows' scratch."""
    return (nzc.items.data_ptr(), nzc.items.shape[0], nzc.splits.data_ptr(),
            nzc.splits.shape[0], nzc.x_rows.data_ptr(), nzc.values.data_ptr(),
            _ptr(partial))


def _vec4(f: int, *tensors: Optional[torch.Tensor]) -> bool:
    """Can the kernel move 4 features a lane (float4): F % 4 == 0 and every
    feature-shaped operand 16-byte aligned, so each of its rows is."""
    return f % 4 == 0 and all(t is None or t.data_ptr() % 16 == 0
                              for t in tensors)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def bsr_spmm(
    block_rows: torch.Tensor,  # [n_blocks] int32 (sorted)
    block_cols: torch.Tensor,  # [n_blocks] int32
    blocks: torch.Tensor,  # [n_blocks, BR, BC] float32
    x: torch.Tensor,  # [n_cols_padded, F] float32, any F
    n_rows_padded: int,
    nzc: Optional[NonzeroColumns] = None,
) -> torch.Tensor:
    """Y = A @ X with A in flattened BSR. Output is float32 [n_rows_padded, F].

    Block indices must lie inside the padded operand, rows sorted (as
    ``csr_to_bsr`` and the sampler give them); the kernel does not
    re-check them on the device. The kernel reads the operand's ``nzc``
    (``nonzero_columns`` of these blocks, built once per operand:
    ``BSRDevice.nonzero_columns()``, or once per batch and layer by
    ``kernels/ops.py:bsr_spmm_pair`` on the sampled path), not the
    blocks; a CUDA call requires it. CPU calls run the plain version and
    do not count as launches.
    """
    _check(block_rows, block_cols, blocks, x, n_rows_padded)
    if nzc is not None:
        _check_nzc(nzc, blocks.shape[1], n_rows_padded)
    if x.device.type == "cpu":
        return bsr_spmm_ref(block_rows, block_cols, blocks, x, n_rows_padded)
    _require_nzc(nzc)
    _check_launch(block_rows=block_rows, block_cols=block_cols,
                  blocks=blocks, x=x, **_nzc_tensors(nzc))
    br = blocks.shape[1]
    f = x.shape[1]
    y = torch.empty((n_rows_padded, f), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    partial = _partial(nzc, f, x.device)
    fn = _entry("bsr_spmm", "bsr_spmm_f32",
                _NZC_ARGTYPES + (_P,) * 2 + (_I,) * 3 + (_P,))
    with torch.cuda.device(x.device):
        err = fn(*_nzc_args(nzc, partial), x.data_ptr(), y.data_ptr(), f, br,
                 int(_vec4(f, x)), _stream(x.device))
    _raise_on(err, "bsr_spmm")
    bsr_spmm.launches += 1
    return y


def bsr_spmm_fused_epilogue(
    block_rows: torch.Tensor,
    block_cols: torch.Tensor,
    blocks: torch.Tensor,
    x: torch.Tensor,  # [n_cols_padded, F] float32
    n_rows_padded: int,
    self_term: Optional[torch.Tensor] = None,  # [n_rows_padded, F]
    bias: Optional[torch.Tensor] = None,  # [F] (or [1, F])
    alpha=None,  # 1-element float32 tensor (a float on the CPU)
    activation: str = "none",  # "none" | "relu"
    nzc: Optional[NonzeroColumns] = None,
):
    """Y = act(A @ X + alpha * self_term + bias), the epilogue fused into
    the SpMM. Returns ``(y, mask)``: ``mask`` is the float32 0/1 sign of
    the pre-activation with ``activation="relu"``, else ``None``.

    The spec is static by the presence of ``self_term`` / ``bias`` and the
    activation, as in the Pallas kernel; ``self_term`` requires ``alpha``
    (1.0 for a plain add), which the kernel reads on the device, so a
    parameter α costs no host sync. The kernel reads the operand's
    ``nzc`` (``nonzero_columns`` of these blocks, built once per operand:
    ``BSRDevice.nonzero_columns()``), not the blocks; a CUDA call
    requires it.
    """
    _check(block_rows, block_cols, blocks, x, n_rows_padded)
    if nzc is not None:
        _check_nzc(nzc, blocks.shape[1], n_rows_padded)
    if activation not in ("none", "relu"):
        raise ValueError(f"unsupported fused activation {activation!r}")
    f = x.shape[1]
    if self_term is not None:
        if alpha is None:
            raise ValueError("self_term requires alpha (use 1.0 for plain add)")
        if tuple(self_term.shape) != (n_rows_padded, f):
            raise ValueError(f"self_term must be [{n_rows_padded}, {f}], got "
                             f"{tuple(self_term.shape)}")
    if bias is not None and bias.numel() != f:
        raise ValueError(f"bias must hold {f} values, got {tuple(bias.shape)}")
    relu = activation == "relu"
    if x.device.type == "cpu":
        return bsr_spmm_fused_ref(block_rows, block_cols, blocks, x,
                                  n_rows_padded, self_term, bias, alpha,
                                  activation)
    if self_term is not None and not (isinstance(alpha, torch.Tensor)
                                      and alpha.numel() == 1):
        raise ValueError("alpha must be a 1-element tensor on the card")
    _require_nzc(nzc)
    _check_launch(block_rows=block_rows, block_cols=block_cols,
                  blocks=blocks, x=x, self_term=self_term, bias=bias,
                  alpha=alpha if self_term is not None else None,
                  **_nzc_tensors(nzc))
    br = blocks.shape[1]
    y = torch.empty((n_rows_padded, f), dtype=torch.float32, device=x.device)
    mask = torch.empty_like(y) if relu else None
    if y.numel() == 0:
        return y, mask
    partial = _partial(nzc, f, x.device)
    fn = _entry("bsr_spmm_fused", "bsr_spmm_fused_f32",
                _NZC_ARGTYPES + (_P,) * 6 + (_I,) * 6 + (_P,))
    with torch.cuda.device(x.device):
        err = fn(*_nzc_args(nzc, partial), x.data_ptr(), _ptr(self_term),
                 _ptr(bias), _ptr(alpha if self_term is not None else None),
                 y.data_ptr(), _ptr(mask), f, br,
                 int(_vec4(f, x, self_term, bias)),
                 int(self_term is not None), int(bias is not None),
                 int(relu), _stream(x.device))
    _raise_on(err, "bsr_spmm_fused_epilogue")
    bsr_spmm_fused_epilogue.launches += 1
    return y, mask


def bsr_spmm_masked(
    block_rows: torch.Tensor,
    block_cols: torch.Tensor,
    blocks: torch.Tensor,
    x: torch.Tensor,  # [n_cols_padded, F] — the incoming cotangent dY
    mask: torch.Tensor,  # shaped like x — the saved activation mask
    n_rows_padded: int,
    nzc: Optional[NonzeroColumns] = None,
) -> torch.Tensor:
    """Y = A @ (mask ⊙ X), the mask applied to X as it is loaded: the
    fused-epilogue VJP through a ReLU (A is the transposed operand). The
    kernel reads ``nzc`` as ``bsr_spmm_fused_epilogue`` does; a CUDA call
    requires it."""
    _check(block_rows, block_cols, blocks, x, n_rows_padded)
    if nzc is not None:
        _check_nzc(nzc, blocks.shape[1], n_rows_padded)
    if mask.shape != x.shape:
        raise ValueError(f"mask shape {tuple(mask.shape)} != x shape "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return bsr_spmm_masked_ref(block_rows, block_cols, blocks, x, mask,
                                   n_rows_padded)
    _require_nzc(nzc)
    _check_launch(block_rows=block_rows, block_cols=block_cols,
                  blocks=blocks, x=x, mask=mask, **_nzc_tensors(nzc))
    br = blocks.shape[1]
    f = x.shape[1]
    y = torch.empty((n_rows_padded, f), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    partial = _partial(nzc, f, x.device)
    fn = _entry("bsr_spmm_masked", "bsr_spmm_masked_f32",
                _NZC_ARGTYPES + (_P,) * 3 + (_I,) * 3 + (_P,))
    with torch.cuda.device(x.device):
        err = fn(*_nzc_args(nzc, partial), x.data_ptr(), mask.data_ptr(),
                 y.data_ptr(), f, br, int(_vec4(f, x, mask)),
                 _stream(x.device))
    _raise_on(err, "bsr_spmm_masked")
    bsr_spmm_masked.launches += 1
    return y


bsr_spmm.launches = 0
bsr_spmm_fused_epilogue.launches = 0
bsr_spmm_masked.launches = 0
