"""Layout stage: node-order selection and the ``LayoutPlan`` record.

Counterpart of ``repro/core/layout.py``, without its tile autotuner (that
waits for ROADMAP.md Queue 1's layout item: tiles for the H100 are timed on
the Hopper kernels, never carried over from the TPU). ``_select_order`` is
the same numpy code, so reordered plans renumber exactly as in JAX.
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
    records provenance (``sampled`` for the mini-batch path).
    """

    order: str                        # "none" | "degree" | "rcm"
    br: int
    bc: int
    bf: int = 0
    perm: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    inv_perm: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)
    source: str = "default"
    # the renumbered graph (P·A·Pᵀ) the plan was computed from
    reordered_graph: Optional[CSRGraph] = dataclasses.field(
        default=None, repr=False)

    @property
    def permutes(self) -> bool:
        return self.order != "none" and self.perm is not None

    def describe(self) -> str:
        bf = self.bf if self.bf else "auto"
        return f"{self.order} {self.br}x{self.bc} bf={bf} [{self.source}]"


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
