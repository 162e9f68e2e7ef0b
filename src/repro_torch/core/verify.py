"""Plan contract verifier — static analysis over lowered plans (DESIGN.md §14).

Counterpart of ``repro/core/verify.py``. The lowerings' implicit
cross-layer contracts (the BSR block stream's order and coverage, the
permutation boundary ``perm[new] = old`` with operands built on the
permuted graph, the sampled bucket caps and relabel tables, and the
binding legality rules) are checked *at lowering time* and reported as
structured :class:`PlanViolation` diagnostics instead of silently wrong
gradients. ``lower`` / ``lower_sampled`` (and so ``GNNProgram.compile``)
call it through ``validate="full" | "fast" | "off"``:

* ``"fast"`` (the default) — metadata and index-structure checks only:
  O(n_blocks) over the index arrays, O(n) over permutations. An
  operand's index arrays cross to the host in one copy; no block *value*
  is read.
* ``"full"`` — everything in fast, plus value-level checks, run as
  reductions on the operand's device: finite blocks, zeroed padding,
  per-block-row mass against the exec graph's (the only values that
  cross to the host are counts, maxima and those row sums), the column
  stream rebuilt from the blocks, and a template-batch pass over the
  sampler (relabel bijectivity, frontier chaining, masked padding, each
  block's column stream).
* ``"off"`` — no verification (microbenchmarks of raw lowering cost).

The Hopper kernels read another operand form than the Pallas kernels.
The TPU grid zeroes and flushes its accumulator at ``first_in_row`` /
``last_in_row``; a ``BSRDevice`` carries neither, and every BSR kernel
walks the operand's ``NonzeroColumns`` (``kernels/bsr_spmm.py``): a work
list of (block_row, begin, end, slot) spans, a ``splits`` table for rows
cut into segments, and each column's X row and values. So where the JAX
verifier checks the row flags, this one checks that column stream
(``nzc.*``): a dropped or doubled item, overlapping spans, a wrong slot,
an X row past the end or a stream that no longer matches its blocks
(``dataclasses.replace(dev, blocks=...)`` keeps the old ``nzc``) give
wrong sums silently otherwise. The sampler's dicts keep their
``first`` flags (the sampler is the JAX package's, byte for byte), so
``bsr.first_in_row`` stays for them.

A ``DistributedModelPlan`` is checked against its ``DistributedGraph``
(``dist=``), whose stacked per-rank operands are host arrays: each
rank's block streams, the split-phase rules (``split.*``: the interior
stream reads no ghost column, interior plus boundary re-add to the bulk
operand, the live shifts match the schedule) and the halo schedule
(``halo.*``: every send paired with a receive, every ghost slot written
by one sender), as in the JAX package. The column streams a rank reads
are built on its device when its trainer binds them, from these blocks.

``verify_plan`` returns the violation list; ``check_plan`` raises
:class:`PlanVerificationError` carrying it. Plans are dispatched by shape,
not by class import (``lowering`` imports this module, not the reverse).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.aggregate import _weighted_graph
from repro_torch.kernels.bsr_spmm import SPLIT_COLUMNS, nonzero_columns

VALIDATE_MODES = ("off", "fast", "full")

#: the invariant catalog — every class a check can emit, with the contract
#: it guards. Tests count mutation coverage against these names.
INVARIANT_CATALOG = {
    # BSR structure (BSRDevice operands and the sampler's padded dicts)
    "bsr.index_dtype": "block indices and first flags are int32",
    "bsr.rows_in_range": "block-row ids within [0, padded_rows/br)",
    "bsr.cols_in_range": "block-col ids within [0, padded_cols/bc)",
    "bsr.rows_sorted": "block-row ids non-decreasing along the stream",
    "bsr.cols_sorted": "block-cols strictly increasing within a block-row",
    "bsr.first_in_row": "first_in_row=1 exactly at block-row transitions",
    "bsr.row_coverage": "every block-row covered (explicit zero blocks)",
    "bsr.padding_zero": "row/col overhang regions of edge blocks are zero",
    "bsr.finite": "block values are finite (no NaN/Inf in operands)",
    # the column stream the Hopper kernels read (NonzeroColumns)
    "nzc.index_dtype": "items, splits and x_rows are int32; values float32 "
                       "[n, br] at the operand's br",
    "nzc.row_coverage": "every block-row has its items; a row's spans tile "
                        "its part of the stream, rows in order, each "
                        "column read exactly once",
    "nzc.segments": "rows over SPLIT_COLUMNS cut into ceil(count/1024) "
                    "segments whose slots run in order; splits lists "
                    "exactly those rows",
    "nzc.x_rows": "x_rows within [0, n_cols_padded), strictly rising "
                  "within a block-row",
    "nzc.stream_match": "the stream equals the one rebuilt from the "
                        "operand's blocks",
    # permutation contract
    "perm.bijection": "perm and inv_perm are permutations of [0, n)",
    "perm.inverse": "perm[inv_perm] == identity (mutually inverse)",
    "layout.tile_match": "operands built at the layout's (br, bc) tile",
    "layout.graph_match": "operand row space matches the exec graph",
    "layout.operand_rows": "per-block-row operand mass matches the "
                           "aggregation-weighted exec graph",
    # sampled contracts
    "sampled.caps_shape": "bucket cap tuples sized to the layer count",
    "sampled.caps_monotone": "bucket caps non-decreasing across buckets",
    "sampled.caps_aligned": "node caps aligned to lcm(br, bc)",
    "sampled.relabel_bijective": "relabel tables are bijections (unique "
                                 "ids, dst prefix contract)",
    "sampled.frontier_chain": "layer l's dst frontier is layer l+1's src",
    "sampled.padding_masked": "padded rows masked and padding edges zero",
    # binding legality
    "binding.epilogue_arch": "epilogue plans only on non-attention, "
                             "non-max archs",
    "binding.attention_arch": "attention plans only on GAT/GT, with "
                              "consistent head geometry",
    "binding.dim_chain": "layer i's d_out feeds layer i+1's d_in",
    "binding.operand_dtype": "operand blocks / features are float32",
    "binding.primitive": "bound primitives name the plan's backend",
    # distributed split-phase + halo schedule
    "split.interior_no_ghost": "interior operand never reads a ghost column",
    "split.reconstruction": "interior + boundary blocks reconstruct the "
                            "bulk operand exactly",
    "split.live_shifts": "live-shift set matches the halo schedule",
    "halo.schedule_paired": "every live send slot has a matching recv slot "
                            "on the destination rank",
    "halo.slot_unique": "each ghost slot is written by exactly one sender",
}


@dataclasses.dataclass(frozen=True)
class PlanViolation:
    """One violated contract: which layer, which operand, which invariant."""

    layer: int        # -1 = plan-level (layout, operands shared by layers)
    operand: str      # e.g. "graph_op.fwd", "block[0].fwd_bsr.nzc"
    invariant: str    # a key of INVARIANT_CATALOG
    detail: str

    def __str__(self) -> str:
        where = "plan" if self.layer < 0 else f"layer {self.layer}"
        return f"[{self.invariant}] {where} / {self.operand}: {self.detail}"


class PlanVerificationError(ValueError):
    """Raised by ``check_plan`` when a lowered plan violates its contracts."""

    def __init__(self, violations: list[PlanViolation], kind: str = "plan"):
        self.violations = list(violations)
        lines = "\n  ".join(str(v) for v in self.violations)
        super().__init__(
            f"{kind} failed contract verification "
            f"({len(self.violations)} violation(s)):\n  {lines}")


def _np(a) -> np.ndarray:
    """Host view of a numpy array or a tensor (a no-op for numpy). Every
    read of the device in this module passes through here, so a test can
    count what crosses."""
    if isinstance(a, np.ndarray):
        return a
    return a.detach().cpu().numpy()


def _dtype(a) -> torch.dtype:
    """The torch dtype of a tensor or numpy array."""
    if isinstance(a, torch.Tensor):
        return a.dtype
    return torch.from_numpy(np.empty(0, dtype=np.asarray(a).dtype)).dtype


def _host_ints(*arrays) -> list[np.ndarray]:
    """Host copies of index arrays: one device-to-host copy for int32
    tensors on one device, each array flattened (the caller reshapes)."""
    tensors = [a for a in arrays if isinstance(a, torch.Tensor)]
    if (len(tensors) == len(arrays) and tensors
            and all(t.dtype == torch.int32 for t in tensors)
            and len({t.device for t in tensors}) == 1):
        flat = _np(torch.cat([t.reshape(-1) for t in tensors]))
        return np.split(flat, np.cumsum([t.numel() for t in tensors])[:-1])
    return [_np(a).reshape(-1) for a in arrays]


#: values a device reduction over an operand's blocks takes at a time, so
#: its temporaries stay small beside the operand (512 MiB in float64)
_CHUNK_VALUES = 1 << 26


def _chunks(blocks: torch.Tensor):
    """Slices of whole blocks, ``_CHUNK_VALUES`` values at most."""
    step = max(1, _CHUNK_VALUES // max(blocks[0].numel(), 1)) \
        if blocks.shape[0] else 1
    return [slice(i, i + step) for i in range(0, blocks.shape[0], step)]


class _Ctx:
    def __init__(self, mode: str):
        self.mode = mode
        self.violations: list[PlanViolation] = []

    @property
    def full(self) -> bool:
        return self.mode == "full"

    def flag(self, layer: int, operand: str, invariant: str, detail: str):
        assert invariant in INVARIANT_CATALOG, invariant
        self.violations.append(
            PlanViolation(layer=int(layer), operand=operand,
                          invariant=invariant, detail=detail))


# ---------------------------------------------------------------------------
# BSR structure checks
# ---------------------------------------------------------------------------

def _check_bsr_stream(
    v: _Ctx,
    operand: str,
    rows: np.ndarray,
    cols: np.ndarray,
    first: Optional[np.ndarray],
    nrb: int,
    ncb: int,
    *,
    layer: int = -1,
    dtypes: Optional[dict] = None,
    padded: bool = False,
) -> None:
    """Verify one flattened BSR block stream's indices (host arrays).

    ``dtypes`` names the arrays' torch dtypes where ``rows`` / ``cols``
    are host copies of tensors. ``padded=True`` exempts the padding
    signature from the within-row column order: the sampler's ``_pad_bsr``
    appends ``col=0, first=0`` zero blocks to the last block-row.
    """
    dtypes = dtypes or {"rows": _dtype(rows), "cols": _dtype(cols)}
    for name, dt in dtypes.items():
        if dt != torch.int32:
            v.flag(layer, operand, "bsr.index_dtype",
                   f"{name} dtype {dt}, expected {torch.int32}")
    n = rows.shape[0]
    if n == 0:
        if nrb > 0:
            v.flag(layer, operand, "bsr.row_coverage",
                   f"empty stream but {nrb} block-rows need coverage")
        return

    r64 = rows.astype(np.int64)
    c64 = cols.astype(np.int64)
    if r64.min() < 0 or r64.max() >= nrb:
        v.flag(layer, operand, "bsr.rows_in_range",
               f"block-rows span [{r64.min()}, {r64.max()}], "
               f"valid range [0, {nrb})")
    if c64.min() < 0 or c64.max() >= ncb:
        v.flag(layer, operand, "bsr.cols_in_range",
               f"block-cols span [{c64.min()}, {c64.max()}], "
               f"valid range [0, {ncb})")
    if not (r64[1:] >= r64[:-1]).all():
        bad = int(np.flatnonzero(r64[1:] < r64[:-1])[0]) + 1
        v.flag(layer, operand, "bsr.rows_sorted",
               f"block-row decreases at flat block {bad}")

    same_row = r64[1:] == r64[:-1]
    nonincreasing = same_row & (c64[1:] <= c64[:-1])
    if nonincreasing.any():
        idx = np.flatnonzero(nonincreasing) + 1
        if padded:
            # padding signature: appended zero blocks carry col=0, first=0
            sig = (c64[idx] == 0)
            if first is not None:
                sig &= first.astype(np.int64)[idx] == 0
            idx = idx[~sig]
        if idx.size:
            v.flag(layer, operand, "bsr.cols_sorted",
                   f"block-cols not strictly increasing within block-row "
                   f"{int(r64[idx[0]])} at flat block {int(idx[0])}")

    if first is not None:
        if _dtype(first) != torch.int32:
            v.flag(layer, operand, "bsr.index_dtype",
                   f"first_in_row dtype {_dtype(first)}, expected "
                   f"{torch.int32}")
        f64 = first.astype(np.int64)
        want = np.ones(n, dtype=np.int64)
        want[1:] = (~same_row).astype(np.int64)
        if not np.array_equal(f64, want):
            bad = int(np.flatnonzero(f64 != want)[0])
            v.flag(layer, operand, "bsr.first_in_row",
                   f"first_in_row[{bad}]={int(f64[bad])} but block-row "
                   f"transition says {int(want[bad])} "
                   f"(block-row {int(r64[bad])})")

    covered = np.unique(r64[(r64 >= 0) & (r64 < nrb)])
    if covered.shape[0] != nrb:
        missing = np.setdiff1d(np.arange(nrb), covered)
        v.flag(layer, operand, "bsr.row_coverage",
               f"{missing.shape[0]} uncovered block-row(s), first: "
               f"{int(missing[0])} — empty rows need explicit zero blocks")


def _check_bsr_values(v: _Ctx, operand: str, rows: torch.Tensor,
                      blocks: torch.Tensor, nrb: int, ncb: int, *,
                      cols: torch.Tensor, layer: int = -1, n_rows: int = 0,
                      n_cols: int = 0) -> None:
    """Full mode: the blocks' values, as reductions on their device. Three
    scalars cross to the host in one copy: the non-finite count and the
    largest magnitude in the last block-row's and last block-col's
    overhang (the kernels trust both overhangs to be zero)."""
    if blocks.dtype != torch.float32:
        v.flag(layer, operand, "binding.operand_dtype",
               f"blocks dtype {blocks.dtype}, expected {torch.float32}")
    _, br, bc = blocks.shape
    zero = blocks.new_zeros((), dtype=torch.float64)
    nonfinite = zero.clone()
    for i in _chunks(blocks):
        nonfinite += (~torch.isfinite(blocks[i])).sum()
    row_over = nrb * br - n_rows if n_rows else 0
    col_over = ncb * bc - n_cols if n_cols else 0
    tails = []
    for over, sel, cut in (
            (row_over, rows == nrb - 1, lambda b: b[:, br - row_over:, :]),
            (col_over, cols == ncb - 1, lambda b: b[:, :, bc - col_over:])):
        tail = cut(blocks[sel]) if over > 0 else blocks[:0]
        tails.append(tail.abs().amax().double() if tail.numel() else zero)
    nonfinite, row_tail, col_tail = _np(torch.stack([nonfinite, *tails])).tolist()
    if nonfinite:
        v.flag(layer, operand, "bsr.finite",
               f"{int(nonfinite)} non-finite block value(s)")
    # a NaN in an overhang is a nonzero value too
    if row_tail != 0.0:
        v.flag(layer, operand, "bsr.padding_zero",
               f"nonzero value in the {row_over}-row overhang of the last "
               f"block-row")
    if col_tail != 0.0:
        v.flag(layer, operand, "bsr.padding_zero",
               f"nonzero value in the {col_over}-col overhang of the last "
               f"block-col")


# ---------------------------------------------------------------------------
# the column stream (NonzeroColumns) the Hopper kernels read
# ---------------------------------------------------------------------------

def _check_nzc(v: _Ctx, operand: str, nzc, items: np.ndarray,
               splits: np.ndarray, x_rows: np.ndarray, *, br: int, nrb: int,
               n_cols_padded: int, layer: int = -1) -> None:
    """Verify one ``NonzeroColumns`` against the operand it serves, from
    host copies of its index arrays (``values`` is read for its dtype and
    shape only). The row tiling is checked first: the segment and x_rows
    order checks read the row spans, so they run only on a stream whose
    spans tile."""
    op = f"{operand}.nzc"
    for name, t in (("items", nzc.items), ("splits", nzc.splits),
                    ("x_rows", nzc.x_rows)):
        if t.dtype != torch.int32:
            v.flag(layer, op, "nzc.index_dtype",
                   f"{name} dtype {t.dtype}, expected {torch.int32}")
    n = x_rows.shape[0]
    if nzc.values.dtype != torch.float32:
        v.flag(layer, op, "nzc.index_dtype",
               f"values dtype {nzc.values.dtype}, expected {torch.float32}")
    if tuple(nzc.values.shape) != (n, br):
        v.flag(layer, op, "nzc.index_dtype",
               f"values shaped {tuple(nzc.values.shape)}, expected "
               f"({n}, {br}) (one br-high column per x_row)")
    if nzc.items.dim() != 2 or nzc.items.shape[1] != 4 \
            or nzc.splits.dim() != 2 or nzc.splits.shape[1] != 3:
        v.flag(layer, op, "nzc.index_dtype",
               f"items shaped {tuple(nzc.items.shape)} and splits "
               f"{tuple(nzc.splits.shape)}, expected [k, 4] and [s, 3]")
        return
    items = items.reshape(-1, 4).astype(np.int64)
    splits = splits.reshape(-1, 3).astype(np.int64)

    x64 = x_rows.astype(np.int64)
    if n and (x64.min() < 0 or x64.max() >= n_cols_padded):
        bad = int(np.flatnonzero((x64 < 0) | (x64 >= n_cols_padded))[0])
        v.flag(layer, op, "nzc.x_rows",
               f"x_rows[{bad}]={int(x64[bad])} outside [0, {n_cols_padded})")

    if nzc.n_block_rows != nrb:
        v.flag(layer, op, "nzc.row_coverage",
               f"stream holds {nzc.n_block_rows} block-rows, the operand "
               f"{nrb}")
        return
    row, begin, end, slot = items.T
    if items.shape[0] == 0 or row.min() < 0 or row.max() >= nrb:
        v.flag(layer, op, "nzc.row_coverage",
               f"item block-rows outside [0, {nrb})" if items.shape[0]
               else f"no items for {nrb} block-row(s)")
        return
    if (end < begin).any() or begin.min() < 0 or end.max() > n:
        bad = int(np.flatnonzero((end < begin) | (begin < 0) | (end > n))[0])
        v.flag(layer, op, "nzc.row_coverage",
               f"item {bad} spans [{int(begin[bad])}, {int(end[bad])}), "
               f"outside the {n}-column stream")
        return
    order = np.lexsort((end, begin, row))
    r, b, e, s = row[order], begin[order], end[order], slot[order]
    per_row = np.bincount(r, minlength=nrb)
    if (per_row == 0).any():
        missing = np.flatnonzero(per_row == 0)
        v.flag(layer, op, "nzc.row_coverage",
               f"{missing.shape[0]} block-row(s) without an item, first: "
               f"{int(missing[0])} — its output is never written")
        return
    # each span starts where the previous one ends: no gap, no overlap
    starts = np.concatenate([[0], e[:-1]])
    if not np.array_equal(b, starts) or e[-1] != n:
        bad = (int(np.flatnonzero(b != starts)[0]) if not np.array_equal(
            b, starts) else len(b) - 1)
        v.flag(layer, op, "nzc.row_coverage",
               f"block-row {int(r[bad])}: span [{int(b[bad])}, "
               f"{int(e[bad])}) against the previous span's end "
               f"{int(starts[bad])} (stream end {n}): columns skipped or "
               f"read twice")
        return
    empty_shared = (e == b) & (per_row[r] > 1)
    if empty_shared.any():
        bad = int(np.flatnonzero(empty_shared)[0])
        v.flag(layer, op, "nzc.row_coverage",
               f"block-row {int(r[bad])} holds an empty item beside "
               f"{int(per_row[r[bad]]) - 1} other(s): its epilogue is "
               f"written more than once")
        return

    # segments: the rows over the split, their slots in segment order
    count = np.bincount(r, weights=e - b, minlength=nrb).astype(np.int64)
    is_split = count > SPLIT_COLUMNS
    n_seg = np.where(is_split, -(-count // SPLIT_COLUMNS), 1)
    split_rows = np.flatnonzero(is_split)
    first_slot = np.cumsum(n_seg[split_rows]) - n_seg[split_rows]
    want_splits = np.stack([split_rows, first_slot, n_seg[split_rows]], 1)
    if not np.array_equal(splits, want_splits):
        v.flag(layer, op, "nzc.segments",
               f"splits lists block-rows {splits[:, 0][:8].tolist()} "
               f"(slots {splits[:, 1:][:4].tolist()}), the stream's split "
               f"rows are {split_rows[:8].tolist()} (slots "
               f"{want_splits[:, 1:][:4].tolist()})")
    elif nzc.n_slots != int(n_seg[split_rows].sum()):
        v.flag(layer, op, "nzc.segments",
               f"n_slots={nzc.n_slots}, the split rows hold "
               f"{int(n_seg[split_rows].sum())} segments")
    if not np.array_equal(per_row, n_seg):
        bad = int(np.flatnonzero(per_row != n_seg)[0])
        v.flag(layer, op, "nzc.segments",
               f"block-row {bad} of {int(count[bad])} columns has "
               f"{int(per_row[bad])} item(s), expected {int(n_seg[bad])}")
    else:
        seg = np.arange(r.shape[0]) - np.repeat(np.cumsum(per_row) - per_row,
                                                per_row)
        slot_base = np.zeros(nrb, np.int64)
        slot_base[split_rows] = first_slot
        want_slot = np.where(is_split[r], slot_base[r] + seg, -1)
        bad_len = (e - b) > SPLIT_COLUMNS
        if not np.array_equal(s, want_slot) or bad_len.any():
            bad = int(np.flatnonzero((s != want_slot) | bad_len)[0])
            v.flag(layer, op, "nzc.segments",
                   f"block-row {int(r[bad])} segment {int(seg[bad])}: slot "
                   f"{int(s[bad])}, {int(e[bad] - b[bad])} columns; "
                   f"expected slot {int(want_slot[bad])}, at most "
                   f"{SPLIT_COLUMNS}")

    # within a block-row the X rows rise strictly (block columns sorted)
    row_of = np.repeat(r, e - b)
    falls = (x64[1:] <= x64[:-1]) & (row_of[1:] == row_of[:-1])
    if falls.any():
        bad = int(np.flatnonzero(falls)[0]) + 1
        v.flag(layer, op, "nzc.x_rows",
               f"x_rows[{bad}]={int(x64[bad])} does not rise past "
               f"x_rows[{bad - 1}]={int(x64[bad - 1])} within block-row "
               f"{int(row_of[bad])}")


def _streams_differ(a, b) -> Optional[str]:
    """Which part of two ``NonzeroColumns`` differs (values bitwise), or
    None; the comparisons run on the streams' device, one host read."""
    if (a.n_block_rows, a.n_slots) != (b.n_block_rows, b.n_slots):
        return (f"n_block_rows/n_slots {a.n_block_rows}/{a.n_slots} against "
                f"{b.n_block_rows}/{b.n_slots}")
    names = ("items", "splits", "x_rows", "values")
    pairs = [(getattr(a, k), getattr(b, k)) for k in names]
    for name, (ta, tb) in zip(names, pairs):
        if ta.shape != tb.shape or ta.dtype != tb.dtype:
            return (f"{name} {tuple(ta.shape)} {ta.dtype} against "
                    f"{tuple(tb.shape)} {tb.dtype}")

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    differs = _np(torch.stack([(bits(ta) != bits(tb)).any() for ta, tb in pairs]))
    bad = [k for k, d in zip(names, differs) if d]
    return f"{', '.join(bad)} differ" if bad else None


def _check_stream_match(v: _Ctx, operand: str, nzc, rows, cols, blocks,
                        n_rows_padded: int, layer: int = -1) -> None:
    """Full mode: rebuild the stream from the operand's blocks on their
    device and compare; a stale ``nzc`` (the blocks replaced after it was
    built) is flagged here."""
    try:
        want = nonzero_columns(rows, cols, blocks, n_rows_padded)
    except (ValueError, RuntimeError) as e:  # indices already flagged
        v.flag(layer, f"{operand}.nzc", "nzc.stream_match",
               f"the blocks give no stream to compare: {e}")
        return
    diff = _streams_differ(nzc, want)
    if diff is not None:
        v.flag(layer, f"{operand}.nzc", "nzc.stream_match",
               f"the stream is not the one its blocks give ({diff}): built "
               f"from other blocks?")


def _check_bsr_device(v: _Ctx, operand: str, dev, *, layer: int = -1,
                      want_br: int = 0, want_bc: int = 0) -> None:
    """Checks for a ``kernels.ops.BSRDevice`` operand: the strict
    single-matrix contract (no padding blocks), and its column stream
    where one was built. The index arrays cross to the host in one copy;
    full mode's value checks stay on the operand's device."""
    br, bc = int(dev.br), int(dev.bc)
    if want_br and (br != want_br or bc != want_bc):
        v.flag(layer, operand, "layout.tile_match",
               f"operand tile ({br}, {bc}) != layout tile "
               f"({want_br}, {want_bc})")
    nrb = -(-int(dev.n_rows) // br)
    ncb = max(-(-int(dev.n_cols) // bc), 1)
    nzc = getattr(dev, "nzc", None)
    arrays = [dev.block_rows, dev.block_cols]
    if nzc is not None:
        arrays += [nzc.items, nzc.splits, nzc.x_rows]
    host = _host_ints(*arrays)
    _check_bsr_stream(
        v, operand, host[0], host[1], None, nrb, ncb, layer=layer,
        dtypes={"rows": _dtype(dev.block_rows), "cols": _dtype(dev.block_cols)})
    if nzc is not None:
        _check_nzc(v, operand, nzc, *host[2:], br=br,
                   nrb=int(dev.n_rows_padded) // br,
                   n_cols_padded=int(dev.n_cols_padded), layer=layer)
    if not v.full:
        return
    _check_bsr_values(v, operand, dev.block_rows, dev.blocks, nrb, ncb,
                      cols=dev.block_cols, layer=layer,
                      n_rows=int(dev.n_rows), n_cols=int(dev.n_cols))
    if nzc is not None:
        _check_stream_match(v, operand, nzc, dev.block_rows, dev.block_cols,
                            dev.blocks, int(dev.n_rows_padded), layer)


# ---------------------------------------------------------------------------
# permutation / layout contract
# ---------------------------------------------------------------------------

def _check_layout(v: _Ctx, lp, n_exec_rows: Optional[int]) -> None:
    if lp is None:
        return
    perm = lp.perm
    inv = lp.inv_perm
    if perm is None and inv is None:
        return
    if perm is None or inv is None:
        v.flag(-1, "layout", "perm.bijection",
               "perm/inv_perm must be set together "
               f"(perm={'set' if perm is not None else 'None'}, "
               f"inv_perm={'set' if inv is not None else 'None'})")
        return
    perm = _np(perm).astype(np.int64)
    inv = _np(inv).astype(np.int64)
    n = perm.shape[0]
    ident = np.arange(n, dtype=np.int64)
    for name, p in (("perm", perm), ("inv_perm", inv)):
        if p.shape[0] != n or not np.array_equal(np.sort(p), ident):
            v.flag(-1, "layout", "perm.bijection",
                   f"{name} is not a permutation of [0, {n})")
            return
    if not np.array_equal(perm[inv], ident):
        bad = int(np.flatnonzero(perm[inv] != ident)[0])
        v.flag(-1, "layout", "perm.inverse",
               f"perm[inv_perm] != identity (first mismatch at node {bad})")
    if n_exec_rows is not None and n != n_exec_rows:
        v.flag(-1, "layout", "layout.graph_match",
               f"permutation over {n} nodes but exec graph has "
               f"{n_exec_rows} rows")


def _graph_masses(graph, aggregation) -> Optional[tuple]:
    """The aggregation-weighted exec graph's row and column sums (float64,
    host), the masses of A's and Aᵀ's rows; None where the operands keep
    raw weights (``max``: attention masks) or the graph has no weighting."""
    if aggregation == "max":
        return None
    try:
        weighted = _weighted_graph(graph, aggregation)
    except (ValueError, AssertionError):
        return None
    data = weighted.data.astype(np.float64)
    rows = np.bincount(np.repeat(np.arange(weighted.n_rows),
                                 np.diff(weighted.indptr)),
                       weights=data, minlength=weighted.n_rows)
    cols = np.bincount(weighted.indices, weights=data,
                       minlength=weighted.n_cols)
    return rows, cols


def _check_operand_rows(v: _Ctx, operand: str, dev,
                        row_sums: np.ndarray) -> None:
    """Full mode: per-block-row mass of the operand must equal the
    aggregation-weighted exec graph's (``row_sums``, from
    ``_graph_masses``) — catches operands built on the wrong
    (un-permuted, mis-weighted) graph even when totals agree. The
    operand's by ``index_add_`` of each block's float64 sum on its
    device, a chunk of blocks at a time; one array of block-row sums
    crosses to the host."""
    n = row_sums.shape[0]
    br = int(dev.br)
    nrb = -(-n // br)
    want = np.bincount(np.arange(n) // br, weights=row_sums, minlength=nrb)
    rows, blocks = dev.block_rows.long(), dev.blocks
    got = torch.zeros(nrb, dtype=torch.float64, device=blocks.device)
    for i in _chunks(blocks):
        r = rows[i]
        held = (r >= 0) & (r < nrb)  # a row out of range is flagged apart
        sums = blocks[i].double().sum(dim=(1, 2))
        got.index_add_(0, torch.where(held, r, 0), torch.where(held, sums, 0.0))
    got = _np(got)
    if not np.allclose(got, want, rtol=1e-4, atol=1e-5):
        bad = int(np.argmax(np.abs(got - want)))
        v.flag(-1, operand, "layout.operand_rows",
               f"block-row {bad} mass {got[bad]:.6g} != weighted graph's "
               f"{want[bad]:.6g} — operand not built on the exec graph?")


# ---------------------------------------------------------------------------
# binding legality (both plan families)
# ---------------------------------------------------------------------------

_ATTENTION_ARCHS = ("GAT", "GT")


def _check_bindings(v: _Ctx, plan, allowed_prefixes: tuple[str, ...]) -> None:
    layers = plan.layers
    for i, layer in enumerate(layers):
        if i + 1 < len(layers) and layer.d_out != layers[i + 1].d_in:
            v.flag(i, "layers", "binding.dim_chain",
                   f"layer {i} d_out={layer.d_out} but layer {i + 1} "
                   f"d_in={layers[i + 1].d_in}")
        is_attn = layer.op_kind in _ATTENTION_ARCHS
        if layer.epilogue is not None and (
                is_attn or plan.aggregation == "max"):
            v.flag(i, "epilogue", "binding.epilogue_arch",
                   f"epilogue plan bound on arch={layer.op_kind} "
                   f"aggregation={plan.aggregation} (no fused epilogue "
                   f"exists for attention archs or max)")
        if layer.attention is not None and not is_attn:
            v.flag(i, "attention", "binding.attention_arch",
                   f"attention plan bound on non-attention arch "
                   f"{layer.op_kind}")
        if layer.attention is not None and is_attn:
            a = layer.attention
            if a.heads < 1 or a.head_dim != max(layer.d_out // a.heads, 1):
                v.flag(i, "attention", "binding.attention_arch",
                       f"attention geometry {a.heads}h x {a.head_dim} "
                       f"inconsistent with d_out={layer.d_out}")
        for prim in (layer.primitive, layer.agg_primitive):
            prefix = prim.split(".", 1)[0]
            if prefix not in allowed_prefixes:
                v.flag(i, "primitive", "binding.primitive",
                       f"primitive {prim!r} names backend {prefix!r}, "
                       f"expected one of {allowed_prefixes}")


# ---------------------------------------------------------------------------
# plan families
# ---------------------------------------------------------------------------

def _verify_model_plan(v: _Ctx, plan, graph) -> None:
    _check_bindings(v, plan, (plan.backend, "gather"))
    lp = plan.layout
    gop = plan.graph_op
    n_exec = getattr(gop, "n_nodes", None) if gop is not None else None
    _check_layout(v, lp, n_exec)
    if graph is not None and n_exec is not None and graph.n_rows != n_exec:
        v.flag(-1, "graph_op", "layout.graph_match",
               f"exec graph has {graph.n_rows} rows but operands were "
               f"built for {n_exec}")
    if gop is None:
        return
    masses = None
    for name, dev, side in (("graph_op.fwd", gop.fwd_operand, 0),
                            ("graph_op.bwd", gop.bwd_operand, 1)):
        if dev is None or not hasattr(dev, "block_rows"):
            continue  # the gather backend's edge lists hold no blocks
        _check_bsr_device(
            v, name, dev,
            want_br=lp.br if lp is not None else 0,
            want_bc=lp.bc if lp is not None else 0)
        if v.full and graph is not None:
            masses = masses or _graph_masses(graph, plan.aggregation)
            if masses is not None:
                _check_operand_rows(v, name, dev, masses[side])


def _stacked_fast_clean(d: dict, nrb: int, ncb: int) -> bool:
    """One vectorised screening pass over a stacked per-rank BSR dict
    ``{"rows": [P, n], "cols": [P, n], "first": [P, n]}``: True when every
    fast-mode invariant holds on every rank. On any failure the caller
    re-runs the per-rank checker for exact (rank, block) diagnostics; the
    screening itself never flags."""
    rows = np.asarray(d["rows"])
    cols = np.asarray(d["cols"])
    first = np.asarray(d["first"]) if d.get("first") is not None else None
    if rows.dtype != np.int32 or cols.dtype != np.int32:
        return False
    if rows.ndim != 2 or rows.shape[1] == 0:
        return False
    r = rows.astype(np.int64, copy=False)
    c = cols.astype(np.int64, copy=False)
    if r.min() < 0 or r.max() >= nrb or c.min() < 0 or c.max() >= ncb:
        return False
    same_row = r[:, 1:] == r[:, :-1]
    if not (r[:, 1:] >= r[:, :-1]).all():
        return False
    noninc = same_row & (c[:, 1:] <= c[:, :-1])
    if noninc.any():
        pad_sig = c[:, 1:] == 0  # appended padding blocks: col=0, first=0
        if first is not None:
            pad_sig &= first[:, 1:] == 0
        if (noninc & ~pad_sig).any():
            return False
    if first is not None:
        if first.dtype != np.int32:
            return False
        want = np.ones(rows.shape, dtype=bool)
        want[:, 1:] = ~same_row
        if not np.array_equal(first.astype(bool), want):
            return False
    P = rows.shape[0]
    counts = np.bincount(
        (r + np.arange(P, dtype=np.int64)[:, None] * nrb).ravel(),
        minlength=P * nrb)
    return bool((counts > 0).all())


def _live_shift_set(send_idx: np.ndarray) -> tuple:
    P = send_idx.shape[0]
    return tuple(int(s) for s in range(1, P)
                 if bool((send_idx[:, s - 1] >= 0).any()))


def _verify_distributed_plan(v: _Ctx, plan, dist) -> None:
    _check_bindings(v, plan, ("distributed", "gather"))
    _check_layout(v, plan.layout, None)
    if dist is None:
        return
    if getattr(dist, "rank", None) is not None:
        raise ValueError("verify a distributed plan against every rank's "
                         f"arrays, not the slice of rank {dist.rank}")

    P = dist.n_ranks
    br, bc = dist.br, dist.bc
    n_local, n_ghost = dist.n_local, dist.n_ghost
    lp = plan.layout
    if lp is not None and (lp.br != br or lp.bc != bc):
        v.flag(-1, "layout", "layout.tile_match",
               f"plan layout tile ({lp.br}, {lp.bc}) != DistributedGraph "
               f"tile ({br}, {bc})")

    def stacked(name, d, nrb, ncb):
        if d is None:
            return
        # fast mode: one vectorised pass over all ranks; drop to the
        # per-rank checker only to name the failing (rank, block)
        if not v.full and _stacked_fast_clean(d, nrb, ncb):
            return
        firsts = d.get("first")
        for p in range(P):
            rows, cols = np.asarray(d["rows"][p]), np.asarray(d["cols"][p])
            op = f"{name}[rank {p}]"
            _check_bsr_stream(
                v, op, rows, cols,
                None if firsts is None else np.asarray(firsts[p]), nrb, ncb,
                padded=True)
            if v.full:
                _check_bsr_values(
                    v, op, torch.from_numpy(rows),
                    torch.from_numpy(np.asarray(d["blocks"][p])), nrb, ncb,
                    cols=torch.from_numpy(cols), n_rows=nrb * br,
                    n_cols=ncb * bc)

    nrb_l = n_local // br
    ncb_l = n_local // bc
    ncb_lg = (n_local + n_ghost) // bc
    nrb_lg = (n_local + n_ghost) // br
    stacked("fwd", dist.fwd, nrb_l, ncb_lg)
    stacked("bwd", dist.bwd, nrb_lg, ncb_l)
    if plan.feat_fwd is not None:
        f_pad = plan.feat_f_pad
        stacked("feat_fwd", plan.feat_fwd, nrb_l, max(f_pad // bc, 1))
        stacked("feat_bwd", plan.feat_bwd, max(f_pad // br, 1), ncb_l)

    # -- split-phase rules ---------------------------------------------------
    if dist.fwd_interior is not None:
        cols_i = np.asarray(dist.fwd_interior["cols"], dtype=np.int64)
        if cols_i.size and int(cols_i.max()) >= ncb_l:
            v.flag(-1, "fwd_interior", "split.interior_no_ghost",
                   f"interior block-col {int(cols_i.max())} reaches into "
                   f"the ghost region (local block-cols end at {ncb_l})")
        stacked("fwd_interior", dist.fwd_interior, nrb_l, ncb_l)
        stacked("bwd_interior", dist.bwd_interior, nrb_l, ncb_l)
        stacked("fwd_boundary", dist.fwd_boundary, nrb_l, ncb_lg)
        stacked("bwd_boundary", dist.bwd_boundary, nrb_lg, ncb_l)
        if v.full:
            _check_split_reconstruction(v, dist, nrb_l, ncb_lg)

    # -- halo schedule -------------------------------------------------------
    send_idx = np.asarray(dist.send_idx)
    recv_slot = np.asarray(dist.recv_slot)
    for s in range(1, P):
        for o in range(P):
            r = (o + s) % P
            ms = send_idx[o, s - 1] >= 0
            mr = recv_slot[r, s - 1] >= 0
            if not np.array_equal(ms, mr):
                v.flag(-1, f"halo[shift {s}]", "halo.schedule_paired",
                       f"rank {o} sends {int(ms.sum())} rows at shift {s} "
                       f"but rank {r} receives {int(mr.sum())}")
    for p in range(P):
        slots = recv_slot[p][recv_slot[p] >= 0]
        if slots.size != np.unique(slots).size:
            v.flag(-1, f"halo[rank {p}]", "halo.slot_unique",
                   f"rank {p} has ghost slots written by multiple senders")
        if slots.size and int(slots.max()) >= n_ghost:
            v.flag(-1, f"halo[rank {p}]", "halo.schedule_paired",
                   f"recv slot {int(slots.max())} outside ghost region "
                   f"[0, {n_ghost})")

    live = _live_shift_set(send_idx)
    if dist.live_shifts is not None and tuple(dist.live_shifts) != live:
        v.flag(-1, "live_shifts", "split.live_shifts",
               f"DistributedGraph.live_shifts={tuple(dist.live_shifts)} "
               f"but the halo schedule says {live}")
    if plan.overlap is not None and tuple(plan.overlap.live_shifts) != live:
        v.flag(-1, "overlap", "split.live_shifts",
               f"OverlapPlan.live_shifts={tuple(plan.overlap.live_shifts)} "
               f"but the halo schedule says {live}")


def _cells(rows, cols, blocks, nrb: int, ncb: int) -> tuple:
    """(keys, blocks): a stream's blocks that hold a nonzero, keyed
    ``row * ncb + col`` and sorted; a cell stored twice is summed (in
    float64). Zero blocks (the explicit ones of empty block-rows, the
    stacks' padding) hold nothing to reconstruct and are left out, so a
    rank's arxiv-sized streams are compared at their own size, not over
    the dense nrb x ncb grid."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    blocks = np.asarray(blocks)
    keep = ((rows >= 0) & (rows < nrb) & (cols >= 0) & (cols < ncb)
            & blocks.reshape(blocks.shape[0], -1).any(axis=1))
    key = rows[keep] * ncb + cols[keep]
    order = np.argsort(key, kind="stable")
    key, vals = key[order], blocks[keep][order]
    if key.size and bool((key[1:] == key[:-1]).any()):
        key, start = np.unique(key, return_index=True)
        vals = np.add.reduceat(vals.astype(np.float64), start, axis=0)
    return key, vals


def _check_split_reconstruction(v: _Ctx, dist, nrb, ncb) -> None:
    """interior + boundary must re-add to the bulk forward operand, block
    by block — the y_int + y_bnd == y_bulk stitching contract."""
    ncb_l = dist.n_local // dist.bc
    for p in range(dist.n_ranks):
        bulk_k, bulk_b = _cells(dist.fwd["rows"][p], dist.fwd["cols"][p],
                                dist.fwd["blocks"][p], nrb, ncb)
        # interior block-cols index the local columns, which lead the
        # bulk's: they key into the bulk's grid as they are
        ic = np.asarray(dist.fwd_interior["cols"][p])
        ik = ic < ncb_l
        got_k, got_b = _cells(
            np.concatenate([np.asarray(dist.fwd_boundary["rows"][p]),
                            np.asarray(dist.fwd_interior["rows"][p])[ik]]),
            np.concatenate([np.asarray(dist.fwd_boundary["cols"][p]), ic[ik]]),
            np.concatenate([np.asarray(dist.fwd_boundary["blocks"][p]),
                            np.asarray(dist.fwd_interior["blocks"][p])[ik]]),
            nrb, ncb)
        if np.array_equal(bulk_k, got_k) and (
                np.array_equal(bulk_b, got_b)
                or np.allclose(got_b, bulk_b, rtol=1e-5, atol=1e-6)):
            continue
        keys = np.union1d(bulk_k, got_k)
        want = np.zeros((keys.size, dist.br, dist.bc))
        have = np.zeros_like(want)
        want[np.searchsorted(keys, bulk_k)] = bulk_b
        have[np.searchsorted(keys, got_k)] = got_b
        if not np.allclose(have, want, rtol=1e-5, atol=1e-6):
            bad = int(keys[np.argmax(np.abs(have - want).sum(axis=(1, 2)))])
            v.flag(-1, f"split[rank {p}]", "split.reconstruction",
                   f"interior + boundary != bulk at block "
                   f"(row {bad // ncb}, col {bad % ncb})")
            return


def _verify_sampled_plan(v: _Ctx, plan, device) -> None:
    _check_bindings(v, plan, (plan.backend, "gather"))
    sampler = plan.sampler
    _check_layout(v, plan.layout,
                  sampler.graph.n_rows if sampler is not None else None)
    if sampler is None:
        return
    L = sampler.n_layers
    br, bc = sampler.br, sampler.bc
    align = int(np.lcm(br, bc))
    prev = None
    for k, b in enumerate(sampler.buckets):
        name = f"bucket[{k}]"
        if (len(b.node_caps) != L + 1 or len(b.nnz_caps) != L
                or len(b.fwd_block_caps) != L or len(b.bwd_block_caps) != L):
            v.flag(-1, name, "sampled.caps_shape",
                   f"cap tuples sized for {len(b.node_caps) - 1} layers, "
                   f"plan has {L}")
            continue
        for l, cap in enumerate(b.node_caps):
            if cap <= 0 or cap % align != 0:
                v.flag(-1, name, "sampled.caps_aligned",
                       f"node_caps[{l}]={cap} not a positive multiple of "
                       f"lcm(br={br}, bc={bc})={align}")
        for l in range(L):
            if b.fwd_block_caps[l] < b.node_caps[l + 1] // br:
                v.flag(-1, name, "sampled.caps_aligned",
                       f"fwd_block_caps[{l}]={b.fwd_block_caps[l]} below "
                       f"the row-coverage floor "
                       f"{b.node_caps[l + 1] // br}")
        if prev is not None:
            if b.seed_cap < prev.seed_cap:
                v.flag(-1, name, "sampled.caps_monotone",
                       f"seed_cap {b.seed_cap} < previous bucket's "
                       f"{prev.seed_cap}")
            for l in range(min(len(b.node_caps), len(prev.node_caps))):
                if b.node_caps[l] < prev.node_caps[l]:
                    v.flag(-1, name, "sampled.caps_monotone",
                           f"node_caps[{l}]={b.node_caps[l]} < previous "
                           f"bucket's {prev.node_caps[l]}")
                    break
        prev = b

    if v.full:
        _verify_template_batch(v, plan, device)


def _real_blocks(d: dict) -> int:
    """Blocks ahead of ``_pad_bsr``'s tail: padding carries col=0, first=0,
    which no real block does (a row's first block has first=1, a later one
    a column past the first's)."""
    real = np.flatnonzero((np.asarray(d["cols"]) != 0)
                          | (np.asarray(d["first"]) != 0))
    return int(real[-1]) + 1 if real.size else 0


def _check_batch_stream(v: _Ctx, operand: str, d: dict, n_rows: int,
                        n_cols: int, br: int, device, layer: int) -> None:
    """One padded batch operand's column stream, built on ``device`` as
    ``kernels/ops.py:bsr_spmm_pair`` builds it for the ``cuda`` executor
    (the trainer's batch arrays are the sampler's, copied): the ``nzc.*``
    checks, and the sampler's zero padding tail must give no column."""
    t = {k: torch.from_numpy(np.ascontiguousarray(d[k])).to(device)
         for k in ("rows", "cols", "blocks")}
    try:
        nzc = nonzero_columns(t["rows"], t["cols"], t["blocks"], n_rows)
    except ValueError as e:  # a row index past the cap: rows_in_range
        v.flag(layer, f"{operand}.nzc", "nzc.row_coverage",
               f"no stream can be built: {e}")
        return
    host = _host_ints(nzc.items, nzc.splits, nzc.x_rows)
    _check_nzc(v, operand, nzc, *host, br=br, nrb=n_rows // br,
               n_cols_padded=n_cols, layer=layer)
    n_real = _real_blocks(d)
    if n_real < t["rows"].shape[0]:
        real = nonzero_columns(t["rows"][:n_real], t["cols"][:n_real],
                               t["blocks"][:n_real], n_rows)
        diff = _streams_differ(nzc, real)
        if diff is not None:
            v.flag(layer, f"{operand}.nzc", "nzc.stream_match",
                   f"the zero padding tail gives columns ({diff})")


def _verify_template_batch(v: _Ctx, plan, device) -> None:
    """Full mode: draw one deterministic batch and check the runtime-side
    sampled contracts (relabel bijectivity, frontier chaining, masked
    padding, per-block BSR structure and column streams). Uses a private
    RNG so the sampler's training stream is untouched."""
    sampler = plan.sampler
    g = sampler.graph
    rng = np.random.default_rng(0xC0FFEE)
    n_seeds = min(plan.batch_size, g.n_rows)
    seeds = rng.choice(g.n_rows, size=n_seeds, replace=False)
    try:
        batch = sampler.sample_batch(seeds, rng=rng)
    except (AssertionError, ValueError) as e:
        v.flag(-1, "sampler", "sampled.caps_monotone",
               f"template batch violates bucket caps: {e}")
        return

    bucket = batch.bucket
    L = sampler.n_layers
    for l, blk in enumerate(batch.blocks):
        name = f"block[{l}]"
        dst = np.asarray(blk.dst_nodes)
        src = np.asarray(blk.src_nodes)
        if np.unique(dst).shape[0] != dst.shape[0]:
            v.flag(l, name, "sampled.relabel_bijective",
                   "duplicate ids in the dst frontier")
        if np.unique(src).shape[0] != src.shape[0]:
            v.flag(l, name, "sampled.relabel_bijective",
                   "duplicate ids in the src frontier")
        if not np.array_equal(src[: dst.shape[0]], dst):
            v.flag(l, name, "sampled.relabel_bijective",
                   "src frontier prefix != dst frontier (relabel table "
                   "broke the prefix contract)")
        if l + 1 < L:
            nxt = np.asarray(batch.blocks[l + 1].src_nodes)
            if not np.array_equal(dst, nxt):
                v.flag(l, name, "sampled.frontier_chain",
                       f"block {l} dst frontier != block {l + 1} src "
                       f"frontier")
        n_e = blk.n_edges
        w_pad = np.asarray(blk.edge_w[n_e:])
        if w_pad.size and float(np.abs(w_pad).max()) != 0.0:
            v.flag(l, name, "sampled.padding_masked",
                   "padding edges carry nonzero weight")
        dst_cap = bucket.node_caps[l + 1]
        src_cap = bucket.node_caps[l]
        d_pad = np.asarray(blk.edge_dst[n_e:])
        if d_pad.size and not (d_pad == dst_cap - 1).all():
            v.flag(l, name, "sampled.padding_masked",
                   "padding edges do not target the reserved dump row")
        for bname, d, nrb, ncb, nr, nc in (
                ("fwd_bsr", blk.fwd_bsr, dst_cap // sampler.br,
                 src_cap // sampler.bc, dst_cap, src_cap),
                ("bwd_bsr", blk.bwd_bsr, src_cap // sampler.br,
                 dst_cap // sampler.bc, src_cap, dst_cap)):
            if d is None:
                continue
            op = f"{name}.{bname}"
            _check_bsr_stream(
                v, op, d["rows"], d["cols"], d["first"], nrb, ncb, layer=l,
                padded=True)
            blocks = torch.from_numpy(d["blocks"])
            _check_bsr_values(v, op, torch.from_numpy(d["rows"]), blocks,
                              nrb, ncb, cols=torch.from_numpy(d["cols"]),
                              layer=l, n_rows=nr, n_cols=nc)
            _check_batch_stream(v, op, d, nr, nc, sampler.br, device, l)

    counts = [batch.blocks[0].n_src] + [b.n_dst for b in batch.blocks]
    for l, m in enumerate(batch.valid):
        m = np.asarray(m)
        want = np.zeros(m.shape[0], dtype=bool)
        want[: counts[l]] = True
        if not np.array_equal(m, want):
            v.flag(-1, f"valid[{l}]", "sampled.padding_masked",
                   f"validity mask is not the {counts[l]}-row prefix")
    if batch.x is not None:
        x = np.asarray(batch.x)
        pad_rows = x[counts[0]:]
        if pad_rows.size and float(np.abs(pad_rows).max()) != 0.0:
            v.flag(-1, "x", "sampled.padding_masked",
                   "padded feature rows are not zero")
        if x.dtype != np.float32:
            v.flag(-1, "x", "binding.operand_dtype",
                   f"gathered features dtype {x.dtype}, expected float32")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _resolve_mode(mode: str) -> str:
    if mode not in VALIDATE_MODES:
        raise ValueError(
            f"validate={mode!r}: expected one of {VALIDATE_MODES}")
    return mode


def verify_plan(plan, *, mode: str = "fast", graph=None,
                dist=None) -> list[PlanViolation]:
    """Run the invariant catalog over a lowered plan; return violations.

    ``graph`` is the *exec* graph a ``ModelPlan``'s operands were built
    from (post-reorder). A ``ModelPlan``'s checks run where its operands
    are; a sampled plan's full-mode template batch builds its column
    streams on the plan's ``device``, where the trainer builds a batch's
    (None: the host). ``dist`` is the ``DistributedGraph`` behind a
    ``DistributedModelPlan`` (the plan does not carry the stacked
    operands), every rank's. Dispatch is structural: an object with
    ``sampler`` / ``n_ranks`` / ``graph_op`` is the corresponding family.
    """
    mode = _resolve_mode(mode)
    v = _Ctx(mode)
    if mode == "off":
        return []
    if hasattr(plan, "sampler"):
        _verify_sampled_plan(v, plan, torch.device(plan.device or "cpu"))
    elif hasattr(plan, "n_ranks"):
        _verify_distributed_plan(v, plan, dist)
    elif hasattr(plan, "graph_op"):
        _verify_model_plan(v, plan, graph)
    else:
        raise TypeError(f"not a lowered plan: {type(plan).__name__}")
    return v.violations


def check_plan(plan, *, mode: str = "fast", graph=None, dist=None) -> None:
    """``verify_plan`` that raises :class:`PlanVerificationError`."""
    if _resolve_mode(mode) == "off":
        return
    violations = verify_plan(plan, mode=mode, graph=graph, dist=dist)
    if violations:
        raise PlanVerificationError(violations, kind=type(plan).__name__)
