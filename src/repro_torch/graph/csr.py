"""Sparse containers: CSR (paper-native) and flattened BSR.

A copy of ``repro/graph/csr.py`` (the port imports nothing from the JAX
package): the same numpy code, so both packages build byte-identical
``CSRGraph`` and ``BSRMatrix`` operands from the same inputs, and a parity
failure points at a kernel or a composition, never at a conversion.

Morphling materialises CSR for the forward pass and CSC for the backward
pass once at load time (§IV-B.b). The BSR stream (blocks sorted by
(block-row, block-col), one explicit zero block per empty block-row) is
what the Hopper SpMM kernel (``kernels/csrc/bsr_spmm.cu``) consumes: one
CTA per block-row walks that row's contiguous blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """A directed graph / sparse matrix in CSR, host-resident (numpy).

    ``indptr[i]:indptr[i+1]`` spans the column indices and values of row i.
    For GNNs: row = destination node, columns = its in-neighbours, so
    Y = A @ X aggregates neighbour features into each destination row.
    """

    indptr: np.ndarray  # [n_rows + 1] int32
    indices: np.ndarray  # [nnz] int32
    data: np.ndarray  # [nnz] float32
    n_rows: int
    n_cols: int
    # structural validation at construction. Direct constructions default
    # to validated (malformed inputs used to be accepted silently and
    # surface as wrong aggregations); the library's own builders
    # (csr_from_edges after its lexsort, transpose) pass False — they are
    # sorted by construction, may intentionally carry multi-edges
    # (dedupe=False), and transpose runs per batch on the sampled hot path.
    validate: bool = dataclasses.field(default=True, repr=False,
                                       compare=False)

    def __post_init__(self):
        # Enforce the int32 index promise at construction so every builder
        # (csr_from_edges, transpose, dataclasses.replace) agrees — the seed
        # let int64 drift in through cumsum/bincount intermediates. int32
        # caps nnz at ~2.1e9, far beyond any host-resident graph here.
        if self.indices.shape[0] > np.iinfo(np.int32).max:
            raise OverflowError(
                f"nnz={self.indices.shape[0]} exceeds int32 index range")
        self.indptr = np.ascontiguousarray(self.indptr, dtype=np.int32)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.int32)
        if self.validate:
            self.validate_structure()

    def validate_structure(self) -> None:
        """Raise ``ValueError`` unless this is a well-formed CSR: monotone
        indptr spanning [0, nnz], in-range column indices, and strictly
        increasing (sorted, duplicate-free) columns within each row."""
        indptr, indices = self.indptr, self.indices
        if indptr.shape[0] != self.n_rows + 1:
            raise ValueError(
                f"CSRGraph: indptr has {indptr.shape[0]} entries, expected "
                f"n_rows + 1 = {self.n_rows + 1}")
        if indptr[0] != 0 or indptr[-1] != indices.shape[0]:
            raise ValueError(
                f"CSRGraph: indptr must span [0, nnz={indices.shape[0]}], "
                f"got [{int(indptr[0])}, {int(indptr[-1])}]")
        if not (indptr[1:] >= indptr[:-1]).all():
            row = int(np.flatnonzero(indptr[1:] < indptr[:-1])[0])
            raise ValueError(
                f"CSRGraph: indptr decreases at row {row} "
                f"({int(indptr[row])} -> {int(indptr[row + 1])})")
        if indices.shape[0] == 0:
            return
        lo, hi = int(indices.min()), int(indices.max())
        if lo < 0 or hi >= self.n_cols:
            raise ValueError(
                f"CSRGraph: column indices span [{lo}, {hi}], valid range "
                f"[0, {self.n_cols})")
        # strictly increasing within a row <=> sorted and duplicate-free;
        # only positions that start a new row are exempt
        nondecr = indices[1:].astype(np.int64) <= indices[:-1]
        if nondecr.any():
            row_start = np.zeros(indices.shape[0], dtype=bool)
            # boundaries equal to nnz belong to trailing empty rows and have
            # no flat position to exempt
            p = indptr[1:-1]
            row_start[p[p < indices.shape[0]]] = True
            bad = nondecr & ~row_start[1:]
            if bad.any():
                pos = int(np.flatnonzero(bad)[0]) + 1
                row = int(np.searchsorted(indptr, pos, side="right")) - 1
                kind = ("duplicate" if indices[pos] == indices[pos - 1]
                        else "unsorted")
                raise ValueError(
                    f"CSRGraph: {kind} column index {int(indices[pos])} in "
                    f"row {row} (flat position {pos})")

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def transpose(self) -> "CSRGraph":
        """CSR of Aᵀ — the paper's CSC view used by the backward pass.

        Vectorised (stable sort by column, then original row): the sampled
        mini-batch path converts per batch, so this runs on the training
        hot path, not just once at load.
        """
        n, m = self.n_rows, self.n_cols
        counts = np.bincount(self.indices, minlength=m)
        indptr_t = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr_t[1:])
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(self.indptr))
        order = np.lexsort((rows, self.indices))
        return CSRGraph(
            indptr=indptr_t,  # __post_init__ narrows to int32
            indices=rows[order],
            data=self.data[order],
            n_rows=m,
            n_cols=n,
            validate=False,  # sorted by the lexsort; hot sampled path
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=self.data.dtype)
        for row in range(self.n_rows):
            s, e = self.indptr[row], self.indptr[row + 1]
            out[row, self.indices[s:e]] += self.data[s:e]
        return out

    def row_normalized(self) -> "CSRGraph":
        """D⁻¹A — mean aggregation weights."""
        deg = np.maximum(self.degrees(), 1).astype(self.data.dtype)
        scale = 1.0 / deg
        data = self.data.copy()
        for row in range(self.n_rows):
            s, e = self.indptr[row], self.indptr[row + 1]
            data[s:e] *= scale[row]
        return dataclasses.replace(self, data=data)

    def sym_normalized(self) -> "CSRGraph":
        """D^(-1/2) A D^(-1/2) — GCN aggregation weights (square graphs)."""
        assert self.n_rows == self.n_cols
        deg_out = np.bincount(self.indices, minlength=self.n_cols)
        deg_in = self.degrees()
        d_in = 1.0 / np.sqrt(np.maximum(deg_in, 1)).astype(self.data.dtype)
        d_out = 1.0 / np.sqrt(np.maximum(deg_out, 1)).astype(self.data.dtype)
        data = self.data.copy()
        for row in range(self.n_rows):
            s, e = self.indptr[row], self.indptr[row + 1]
            data[s:e] *= d_in[row] * d_out[self.indices[s:e]]
        return dataclasses.replace(self, data=data)

    def edge_list(self) -> tuple[np.ndarray, np.ndarray]:
        """(src=col, dst=row) arrays — gather-scatter baseline format."""
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int32), self.degrees().astype(np.int32))
        return self.indices.copy(), rows


def csr_from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    n_rows: int,
    n_cols: Optional[int] = None,
    data: Optional[np.ndarray] = None,
    dedupe: bool = True,
) -> CSRGraph:
    """Build CSR with row=dst so that A@X aggregates src features into dst."""
    n_cols = n_cols if n_cols is not None else n_rows
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if data is None:
        data = np.ones(src.shape[0], dtype=np.float32)
    if dedupe and src.shape[0] > 0:
        key = dst * n_cols + src
        _, uniq = np.unique(key, return_index=True)
        src, dst, data = src[uniq], dst[uniq], data[uniq]
    order = np.lexsort((src, dst))
    src, dst, data = src[order], dst[order], np.asarray(data)[order]
    counts = np.bincount(dst, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(
        indptr=indptr,
        indices=src.astype(np.int32),
        data=data.astype(np.float32),
        n_rows=int(n_rows),
        n_cols=int(n_cols),
        # sorted by the lexsort above; dedupe=False callers intentionally
        # keep multi-edges, which strict validation would reject
        validate=False,
    )


def csr_from_dense(mat: np.ndarray) -> CSRGraph:
    rows, cols = np.nonzero(mat)
    return csr_from_edges(
        src=cols, dst=rows, n_rows=mat.shape[0], n_cols=mat.shape[1],
        data=mat[rows, cols], dedupe=False,
    )


# --------------------------------------------------------------------------
# Locality-aware node reordering (layout-optimization stage, DESIGN.md §9).
#
# The BSR block count — and with it DMA volume and MXU work — depends on the
# node numbering the dataset happened to ship with. Both orders below return
# ``perm`` with the convention ``perm[new] = old`` (new node i is old node
# perm[i]); ``reorder_graph`` applies a symmetric permutation P A Pᵀ so the
# graph stays the same graph, just renumbered.
# --------------------------------------------------------------------------

def _symmetrized_structure(graph: CSRGraph) -> CSRGraph:
    """A + Aᵀ structure (deduped, unweighted) for traversal orders."""
    src, dst = graph.edge_list()
    return csr_from_edges(
        src=np.concatenate([src, dst]), dst=np.concatenate([dst, src]),
        n_rows=max(graph.n_rows, graph.n_cols))


def _require_square(graph: CSRGraph, what: str) -> None:
    if graph.n_rows != graph.n_cols:
        raise ValueError(
            f"{what} needs a square graph (symmetric renumbering), got "
            f"{graph.n_rows}x{graph.n_cols}")


def degree_order(graph: CSRGraph) -> np.ndarray:
    """Degree-sort permutation: total (in + out) degree descending, stable.

    Packs hub rows/columns into the same block-rows/-columns, so dense
    neighbourhoods share blocks and light tails produce near-empty
    block-rows with few blocks — fewer distinct (block-row, block-col)
    pairs overall on power-law graphs.
    """
    _require_square(graph, "degree_order")
    und = _symmetrized_structure(graph)
    return np.argsort(-und.degrees(), kind="stable")


def rcm_order(graph: CSRGraph) -> np.ndarray:
    """Reverse Cuthill–McKee permutation (BFS bandwidth reduction).

    Per connected component of the symmetrised structure: BFS from a
    minimum-degree node, expanding neighbours in increasing-degree order,
    then reverse the whole visitation sequence. Nonzeros end up near the
    diagonal, so each block-row touches few distinct block-columns.
    """
    _require_square(graph, "rcm_order")
    und = _symmetrized_structure(graph)
    n = graph.n_rows
    deg = und.degrees()
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # component roots in increasing-degree order (classic CM seed choice)
    for root in np.argsort(deg, kind="stable"):
        if visited[root]:
            continue
        visited[root] = True
        order[pos] = root
        head, pos = pos, pos + 1
        while head < pos:
            u = order[head]
            head += 1
            s, e = und.indptr[u], und.indptr[u + 1]
            nbrs = und.indices[s:e]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                order[pos: pos + nbrs.size] = nbrs
                pos += nbrs.size
    return order[::-1].copy()


#: reorder modes `reorder_graph` understands (besides "none")
REORDER_MODES = ("degree", "rcm")


def reorder_graph(
    graph: CSRGraph, mode: str = "rcm",
) -> tuple[CSRGraph, np.ndarray, np.ndarray]:
    """Symmetric renumbering: returns ``(P A Pᵀ, perm, inv_perm)``.

    ``perm[new] = old`` and ``inv_perm[old] = new``; features permute in as
    ``X[perm]`` and outputs permute back as ``Y[inv_perm]`` — the
    permutation contract the trainers uphold (DESIGN.md §9). Square graphs
    only (the renumbering applies to rows and columns alike).
    """
    _require_square(graph, "reorder_graph")
    if mode == "none":
        ident = np.arange(graph.n_rows, dtype=np.int64)
        return graph, ident, ident.copy()
    if mode == "degree":
        perm = degree_order(graph)
    elif mode == "rcm":
        perm = rcm_order(graph)
    else:
        raise ValueError(f"unknown reorder mode {mode!r}; "
                         f"expected one of {('none',) + REORDER_MODES}")
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.shape[0], dtype=np.int64)
    return permute_graph(graph, inv_perm), perm, inv_perm


def permute_graph(graph: CSRGraph, inv_perm: np.ndarray) -> CSRGraph:
    """Apply a symmetric renumbering ``inv_perm[old] = new`` to a square
    graph (the edge-level form of P A Pᵀ)."""
    _require_square(graph, "permute_graph")
    rows = np.repeat(np.arange(graph.n_rows, dtype=np.int64),
                     np.diff(graph.indptr))
    return csr_from_edges(
        src=inv_perm[graph.indices], dst=inv_perm[rows],
        n_rows=graph.n_rows, data=graph.data, dedupe=False)


# --------------------------------------------------------------------------
# BSR: the flattened block stream the SpMM kernel consumes.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class BSRMatrix:
    """Block-sparse-row matrix, flattened into one sorted block stream.

    Blocks are sorted by block-row; all blocks of a row are contiguous, so
    one CTA that owns a block-row finds them as one range and accumulates
    them in registers without atomics (Alg 3's block-per-row mapping).

    ``block_rows[b]`` / ``block_cols[b]``: block coordinates of flat block b.
    ``first_in_row[b]``: 1 iff b is the first block of its block-row (the
    JAX package's sequential TPU grid zeroes its accumulator there; the
    Hopper kernel derives each row's range from ``block_rows`` instead).
    ``last_in_row[b]``: its dual — 1 iff b is the last block of its
    block-row.
    ``blocks[b]``: the dense (BR, BC) tile.
    Rows with no nonzeros still get one explicit zero block so every output
    tile is written (and every row sees exactly one first and one last).
    """

    block_rows: np.ndarray  # [n_blocks] int32
    block_cols: np.ndarray  # [n_blocks] int32
    first_in_row: np.ndarray  # [n_blocks] int32 (0/1)
    blocks: np.ndarray  # [n_blocks, BR, BC] float32
    n_rows: int  # unpadded logical rows
    n_cols: int
    br: int
    bc: int
    # derived when omitted (row-sorted invariant): external constructors that
    # predate the fused-epilogue kernel keep working unchanged
    last_in_row: Optional[np.ndarray] = None  # [n_blocks] int32 (0/1)

    def __post_init__(self):
        if self.last_in_row is None and self.block_rows.shape[0] > 0:
            last = np.ones(self.block_rows.shape[0], dtype=np.int32)
            last[:-1] = (self.block_rows[1:] != self.block_rows[:-1]).astype(
                np.int32)
            self.last_in_row = last
        elif self.last_in_row is None:
            self.last_in_row = np.zeros(0, dtype=np.int32)

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def padded_rows(self) -> int:
        return _ceil_to(self.n_rows, self.br)

    @property
    def padded_cols(self) -> int:
        return _ceil_to(self.n_cols, self.bc)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.padded_rows, self.padded_cols), dtype=self.blocks.dtype)
        for b in range(self.n_blocks):
            r, c = self.block_rows[b], self.block_cols[b]
            out[r * self.br:(r + 1) * self.br, c * self.bc:(c + 1) * self.bc] += self.blocks[b]
        return out[: self.n_rows, : self.n_cols]


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def adaptive_bc(n_cols: int, max_bc: int = 128) -> int:
    """Fallback block-column width for an un-autotuned ``csr_to_bsr``.

    Largest lane tile in {128, 64, 32, 16, 8} whose column padding wastes
    at most 1/8 of the padded width. Large graphs keep the full 128-lane
    tile; small graphs (nell's 263 nodes) stop shipping a mostly-zero
    padded block-column through the DMA. The autotuner (core/layout.py)
    overrides this with a measured choice when one is cached.
    """
    for bc in (128, 64, 32, 16, 8):
        if bc > max_bc:
            continue
        padded = _ceil_to(max(n_cols, 1), bc)
        if (padded - n_cols) * 8 <= padded:
            return bc
    return 8


def csr_to_bsr(csr: CSRGraph, br: int = 8, bc: Optional[int] = None) -> BSRMatrix:
    """CSR→BSR conversion (O(nnz), vectorised).

    One-time at load for the full-batch/distributed paths (the paper's
    CSR/CSC materialisation argument, §IV-B.b) — but the sampled mini-batch
    path converts every batch's blocks, so this runs in numpy ops, not
    Python loops. Output invariants (what the kernels rely on): blocks
    sorted by (block-row, block-col), ``first_in_row`` flags the first
    block of each block-row, and every empty block-row gets one explicit
    zero block at column 0 so its output tile is still produced.
    ``bc=None`` picks the adaptive fallback width (``adaptive_bc``).
    """
    if bc is None:
        bc = adaptive_bc(csr.n_cols)
    n_block_rows = _ceil_to(csr.n_rows, br) // br
    n_block_cols = max(_ceil_to(csr.n_cols, bc) // bc, 1)
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64),
                     np.diff(csr.indptr))
    cols = csr.indices.astype(np.int64)
    rb, cb = rows // br, cols // bc
    key = rb * n_block_cols + cb
    uniq, inv = np.unique(key, return_inverse=True)
    occ_rows = (uniq // n_block_cols).astype(np.int64)

    # empty block rows still need one explicit zero block each
    present = np.zeros(n_block_rows, dtype=bool)
    present[occ_rows] = True
    empty_rows = np.flatnonzero(~present)
    all_rows = np.concatenate([occ_rows, empty_rows])
    all_cols = np.concatenate(
        [uniq % n_block_cols, np.zeros(empty_rows.shape[0], np.int64)])
    order = np.lexsort((all_cols, all_rows))  # (row, col) sorted

    n_blocks = all_rows.shape[0]
    blocks = np.zeros((n_blocks, br, bc), dtype=np.float32)
    np.add.at(blocks, (inv, rows % br, cols % bc), csr.data)
    blocks = blocks[order]
    block_rows = all_rows[order]
    first_flags = np.ones(n_blocks, dtype=np.int32)
    first_flags[1:] = (block_rows[1:] != block_rows[:-1]).astype(np.int32)
    # last_in_row derived by BSRMatrix.__post_init__ (single definition)
    return BSRMatrix(
        block_rows=block_rows.astype(np.int32),
        block_cols=all_cols[order].astype(np.int32),
        first_in_row=first_flags,
        blocks=blocks,
        n_rows=csr.n_rows,
        n_cols=csr.n_cols,
        br=br,
        bc=bc,
    )


def bsr_block_count(csr: CSRGraph, br: int, bc: int) -> int:
    """Block count of ``csr_to_bsr(csr, br, bc)`` without materialising the
    blocks — the autotuner's cost-model primitive (distinct
    (block-row, block-col) pairs plus one explicit zero block per empty
    block-row, exactly the conversion's output size)."""
    n_block_rows = _ceil_to(csr.n_rows, br) // br
    n_block_cols = max(_ceil_to(csr.n_cols, bc) // bc, 1)
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64),
                     np.diff(csr.indptr))
    key = (rows // br) * n_block_cols + csr.indices.astype(np.int64) // bc
    uniq = np.unique(key)
    occupied = np.unique(uniq // n_block_cols)
    return int(uniq.shape[0] + (n_block_rows - occupied.shape[0]))
