"""Layout stage: node-order selection and the ``LayoutPlan`` record.

Counterpart of ``repro/core/layout.py``, without its tile autotuner (that
waits for ROADMAP.md Queue 1's layout item: tiles for the H100 are timed on
the Hopper kernels, never carried over from the TPU). ``_select_order``,
``default_layout`` and ``_waste`` are the same numpy code, so plans
renumber and describe their tiles exactly as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.graph.csr import (
    REORDER_MODES,
    CSRGraph,
    adaptive_bc,
    bsr_block_count,
    reorder_graph,
)


@dataclasses.dataclass
class LayoutPlan:
    """One graph's chosen layout: node order + BSR tile, plan-visible.

    ``perm[new] = old`` / ``inv_perm[old] = new`` (``None`` for the
    identity order); ``bf == 0`` means no pinned lane tile. ``source``
    records provenance: ``default`` (no tuning ran), ``explicit`` (the
    caller's tile), ``requested`` (the caller's order), ``sampled`` (the
    mini-batch path).
    """

    order: str                        # "none" | "degree" | "rcm"
    br: int
    bc: int
    bf: int = 0
    perm: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    inv_perm: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)
    source: str = "default"
    n_blocks: int = 0                 # BSR(A) block count at this layout
    padding_waste: float = 0.0        # estimated share of padded entries
    # the renumbered graph (P·A·Pᵀ) the plan was computed from
    reordered_graph: Optional[CSRGraph] = dataclasses.field(
        default=None, repr=False)

    @property
    def permutes(self) -> bool:
        return self.order != "none" and self.perm is not None

    def describe(self) -> str:
        bf = self.bf if self.bf else "auto"
        line = f"{self.order} {self.br}x{self.bc} bf={bf}"
        if self.n_blocks:
            line += f" blocks={self.n_blocks} waste={self.padding_waste:.1%}"
        return f"{line} [{self.source}]"


def default_layout(graph: CSRGraph, br: Optional[int] = None,
                   bc: Optional[int] = None) -> LayoutPlan:
    """The un-autotuned fallback: identity order, given or adaptive tile."""
    br = 8 if br is None else int(br)
    bc = adaptive_bc(graph.n_cols) if bc is None else int(bc)
    nb = bsr_block_count(graph, br, bc)
    return LayoutPlan(order="none", br=br, bc=bc, bf=0,
                      n_blocks=nb, padding_waste=_waste(graph, br, bc, nb))


def _waste(graph: CSRGraph, br: int, bc: int, n_blocks: int) -> float:
    """Cheap padding-waste estimate without materialising blocks: assumes
    every last-row/last-col overhang block is occupied proportionally."""
    bsr_rows = -(-graph.n_rows // br) * br
    bsr_cols = max(-(-graph.n_cols // bc), 1) * bc
    row_over, col_over = bsr_rows - graph.n_rows, bsr_cols - graph.n_cols
    # upper bound: one block-row's worth of row overhang, one block-col's
    # of col overhang, over the stored total
    n_bcols = bsr_cols // bc
    n_brows = bsr_rows // br
    est = (min(n_blocks, n_bcols) * row_over * bc
           + min(n_blocks, n_brows) * col_over * br)
    return min(est / max(n_blocks * br * bc, 1), 1.0)


def _select_order(graph: CSRGraph, mode: str = "auto", br: int = 8,
                  bc: Optional[int] = None, min_gain: float = 0.1,
                  ) -> tuple[str, CSRGraph, Optional[np.ndarray],
                             Optional[np.ndarray]]:
    """Resolve the reorder mode and return ``(mode, reordered graph, perm,
    inv_perm)``. ``auto`` picks by BSR block count at a reference tile and
    only permutes when the best mode shrinks the block count by at least
    ``min_gain`` (relative)."""
    if mode != "auto":
        if mode not in ("none",) + REORDER_MODES:
            raise ValueError(f"unknown reorder mode {mode!r}")
        if mode == "none":
            return "none", graph, None, None
        g_r, perm, inv = reorder_graph(graph, mode)
        return mode, g_r, perm, inv
    if graph.n_rows != graph.n_cols:
        return "none", graph, None, None
    bc = adaptive_bc(graph.n_cols) if bc is None else bc
    base = bsr_block_count(graph, br, bc)
    best = ("none", graph, None, None)
    best_count = base
    for m in REORDER_MODES:
        g_r, perm, inv = reorder_graph(graph, m)
        count = bsr_block_count(g_r, br, bc)
        if count < best_count:
            best, best_count = (m, g_r, perm, inv), count
    if best_count > base * (1.0 - min_gain):
        return "none", graph, None, None
    return best
