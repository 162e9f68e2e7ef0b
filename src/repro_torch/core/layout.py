"""Layout-optimization stage: reorder selection + BSR tile autotuning.

Counterpart of ``repro/core/layout.py``. ``plan_layout`` runs at lowering
time and decides, per ``(graph fingerprint, feature dim, backend,
fused?)``:

* the **node order** — ``none`` / ``degree`` / ``rcm``
  (``graph/csr.py:reorder_graph``), chosen by BSR block count at a
  reference tile, with the JAX package's rule (``_select_order``);
* the **tile** ``(br, bc, bf)`` — timed over a small candidate grid with
  samples interleaved round-robin where timing measures the layout (the
  ``torch`` backend on any device, the ``cuda`` backend on a CUDA
  device), else scored by a cost model;
* and caches the winner to disk, so the measurement runs once per
  fingerprint — a cache hit never re-measures.

The port's backend names key the cache (``cuda`` for ``pallas``,
``torch`` for ``xla``), so entries of the two packages never shadow each
other in one file.

The Hopper SpMM kernels do not multiply blocks: they walk each block-row's
nonzero columns (``kernels/bsr_spmm.py:NonzeroColumns``), the ascending set
of element columns that hold a nonzero, which does not depend on ``bc``.
So on ``cuda`` the tile reduces to the block height: the grid keeps one
``bc`` per ``br`` (the one storing the fewest elements, since the blocks
are still built), carries no ``bf`` (the kernels mask the ragged feature
edge), and the cost model scores the column stream. The ``torch`` and
``gather`` backends keep the JAX package's block model: the plain version
multiplies whole blocks.

The result is a ``LayoutPlan`` the lowering pass threads through every
plan consumer; features go in as ``X[perm]`` and outputs come back as
``Y[inv_perm]`` inside the trainers, never at the user (DESIGN.md §9).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.graph.csr import (
    REORDER_MODES,
    CSRGraph,
    adaptive_bc,
    bsr_block_count,
    csr_to_bsr,
    reorder_graph,
)
from repro_torch.kernels.bsr_spmm import SPLIT_COLUMNS

#: default (br, bc) candidate grid; bf candidates derive from the feature dim
TILE_CANDIDATES = ((8, 16), (8, 32), (8, 64), (8, 128), (16, 32), (16, 64))

#: modelled fixed cost per block (grid-step overhead: index prefetch, DMA
#: issue) in MAC-equivalents — keeps the cost model from picking tiny tiles
#: whose per-block overhead would dominate
BLOCK_OVERHEAD = 4096.0

#: the ``cuda`` model's fixed cost per work item (one CTA: a block-row, or
#: one segment of a split hub row), in the same MAC-equivalents
ITEM_OVERHEAD = BLOCK_OVERHEAD

#: timed candidates since import — the cache-determinism proof observable
#: (a cache hit leaves this untouched)
_MEASURE_CALLS = 0


def measure_calls() -> int:
    return _MEASURE_CALLS


@dataclasses.dataclass
class LayoutPlan:
    """One graph's chosen layout: node order + BSR tile, plan-visible.

    ``perm[new] = old`` / ``inv_perm[old] = new`` (``None`` for the
    identity order); ``bf == 0`` means no pinned lane tile. ``source``
    records provenance: ``default`` (no tuning ran), ``explicit`` (the
    caller's tile), ``requested`` (the caller's order), ``cost-model``,
    ``measured``, ``cache`` (a previous plan, loaded), ``sampled`` (the
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
    fingerprint: str = ""
    n_blocks: int = 0                 # BSR(A) block count at this layout
    padding_waste: float = 0.0        # share of padded entries
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


def graph_fingerprint(graph: CSRGraph, f_dim: int, backend: str, fused: bool,
                      order: str = "auto",
                      tiles: Optional[Sequence[tuple[int, int]]] = None,
                      n_heads: int = 0, attention: bool = False,
                      ) -> str:
    """Cache key: exact graph structure + every tuning condition, as the
    JAX package's (the port's backend name is part of it). Attention plans
    key apart from SpMM plans on the same graph, and a custom candidate
    grid apart from the default one."""
    h = hashlib.sha256()
    h.update(np.asarray(
        [graph.n_rows, graph.n_cols, graph.nnz, int(f_dim)],
        dtype=np.int64).tobytes())
    h.update(backend.encode())
    h.update(b"fused" if fused else b"unfused")
    h.update(f"attn={int(bool(attention))}x{int(n_heads)}".encode())
    h.update(f"order={order}".encode())
    h.update(repr("default" if tiles is None
                  else tuple(map(tuple, tiles))).encode())
    h.update(np.ascontiguousarray(graph.indptr).tobytes())
    h.update(np.ascontiguousarray(graph.indices).tobytes())
    return h.hexdigest()[:20]


def default_cache_path() -> str:
    """``MORPHLING_LAYOUT_CACHE``, else the JAX package's file."""
    return os.environ.get(
        "MORPHLING_LAYOUT_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "morphling-repro",
                     "layout_cache.json"))


def _load_cache(path: str) -> dict:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def _store_entry(path: str, key: str, entry: dict) -> None:
    # re-read just before the atomic replace so concurrent tuners merge
    # rather than clobber; a true race can still lose one entry, which
    # costs that graph a re-measure on its next cold run
    cache = _load_cache(path)
    cache[key] = entry
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(cache, fh, indent=1, sort_keys=True)
    os.replace(tmp, path)


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


def _timing_available(backend: str, device=None) -> bool:
    """Wall time only means something where the candidate runs as it will
    run: the ``torch`` plain versions on any device, the Hopper kernels
    on a CUDA device. The ``cuda`` backend on CPU tensors would time the
    plain versions instead of the kernels it plans for."""
    if backend == "torch":
        return True
    if backend == "cuda":
        return device is not None and torch.device(device).type == "cuda"
    return False


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


def choose_order(graph: CSRGraph, mode: str = "auto", br: int = 8,
                 bc: Optional[int] = None, min_gain: float = 0.1) -> str:
    """The mode-only view of ``_select_order`` (validates explicit
    modes; ``auto`` applies the min-gain rule)."""
    return _select_order(graph, mode, br, bc, min_gain)[0]


def column_stream(graph: CSRGraph, br: int) -> tuple[int, int]:
    """``(columns, work items)`` of the Hopper kernels' operand at block
    height ``br``, counted on the host without building blocks: the
    distinct element columns holding a nonzero in each ``br``-row
    block-row (the length of ``NonzeroColumns``'s stream, for any ``bc``),
    and the CTAs that walk it (one a block-row, one more for each further
    ``SPLIT_COLUMNS`` of a hub row)."""
    n_brows = -(-graph.n_rows // br)
    rows = np.repeat(np.arange(graph.n_rows, dtype=np.int64),
                     np.diff(graph.indptr))
    held = np.asarray(graph.data) != 0
    key = (rows[held] // br) * max(graph.n_cols, 1) + graph.indices[held]
    uniq = np.unique(key)
    counts = np.bincount(uniq // max(graph.n_cols, 1), minlength=n_brows)
    extra = np.maximum(-(-counts // SPLIT_COLUMNS) - 1, 0)
    return int(uniq.shape[0]), int(n_brows + extra.sum())


def _bf_candidates(f_dim: int) -> tuple[int, ...]:
    """Lane-tile candidates of the block backends: 0 (the per-call
    ``feature_tile`` policy) always, and a pinned 128 only where it
    changes the padded width (f > 128, f % 128 != 0)."""
    cands = {0}
    if f_dim > 128 and f_dim % 128 != 0:
        cands.add(128)
    return tuple(sorted(cands))


def _f_pad_for(f_dim: int, bf: int) -> int:
    from repro_torch.kernels.ops import feature_tile

    if bf == 0:
        return feature_tile(f_dim)[1]
    return -(-f_dim // bf) * bf


def _candidate_grid(graph: CSRGraph, f_dim: int,
                    tiles: Optional[Sequence[tuple[int, int]]],
                    lane_matters: bool = True, backend: str = "torch") -> list:
    """(br, bc, bf) candidates. ``lane_matters=False`` collapses the bf
    axis to 0, as the JAX package does where the lane tile is not a
    distinct program. On ``cuda`` every candidate of one ``br`` gives the
    same nonzero-column stream, so timing them all would time one program
    and persist a noise-picked winner: the grid keeps, of each ``br``, the
    ``bc`` storing the fewest elements (``bsr_block_count · br · bc``),
    with no ``bf`` axis."""
    tiles = TILE_CANDIDATES if tiles is None else tuple(tiles)
    tiles = [(int(br), int(bc)) for br, bc in tiles
             # a lane tile twice the matrix is pure padding
             if not (bc > 2 * graph.n_cols and bc > 16)]
    if backend == "cuda":
        best: dict = {}
        for br, bc in tiles:
            stored = bsr_block_count(graph, br, bc) * br * bc
            if br not in best or stored < best[br][0]:
                best[br] = (stored, bc)
        grid = [(br, bc, 0) for br, (_, bc) in best.items()]
    else:
        bfs = _bf_candidates(f_dim) if lane_matters else (0,)
        grid = [(br, bc, bf) for br, bc in tiles for bf in bfs]
    return grid or [(8, adaptive_bc(graph.n_cols), 0)]


def _model_scores(graph: CSRGraph, f_dim: int, grid: list,
                  backend: str = "torch") -> list[float]:
    """Cost model (timing-free fallback). Block backends, as the JAX
    package: MAC volume over the stored blocks, padded lanes included,
    plus a fixed cost a block. ``cuda``: what the Hopper kernel reads,
    the nonzero-column stream's length × 2·br·F, plus a fixed cost a
    work item."""
    scores = []
    for br, bc, bf in grid:
        if backend == "cuda":
            n_cols, n_items = column_stream(graph, br)
            scores.append(n_cols * 2.0 * br * f_dim + ITEM_OVERHEAD * n_items)
        else:
            nb = bsr_block_count(graph, br, bc)
            scores.append(
                nb * (2.0 * br * bc * _f_pad_for(f_dim, bf) + BLOCK_OVERHEAD))
    return scores


def _time_scores(graph: CSRGraph, f_dim: int, backend: str, fused: bool,
                 grid: list, seed: int, device, repeats: int = 7) -> list[float]:
    """Median time a candidate's forward takes: ``spmm_fused_epilogue``
    with ReLU when ``fused``, the plain ``spmm`` otherwise, in float32.
    Each candidate's operand pair (and, on ``cuda``, its nonzero columns)
    is built outside the timed region, as at bind time, and run once
    before timing; samples are interleaved round-robin, so drift in the
    card's clocks hits every candidate alike. CUDA events on the card,
    the host clock elsewhere."""
    global _MEASURE_CALLS
    from repro_torch.backends import get_backend

    be = get_backend(backend)
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(
        rng.standard_normal((graph.n_cols, f_dim)).astype(np.float32)).to(dev)
    bias = torch.zeros((f_dim,), dtype=torch.float32, device=dev)
    graph_t = graph.transpose() if fused else None
    thunks = []
    for br, bc, _ in grid:
        fwd = be.build_spmm_operand(graph, br=br, bc=bc, device=dev)
        if fused:
            bwd = be.build_spmm_operand(graph_t, br=br, bc=bc, device=dev)
            fn = be.spmm_fused_epilogue(fwd, bwd)
            thunks.append(lambda _fn=fn: _fn(u, bias=bias, activation="relu"))
        else:
            if backend == "cuda":
                fwd.nonzero_columns()
            thunks.append(lambda _o=fwd: be.spmm(_o, u))
    on_card = dev.type == "cuda"
    samples: list[list[float]] = [[] for _ in thunks]
    with torch.no_grad():
        for op in thunks:
            op()
        if on_card:
            torch.cuda.synchronize(dev)
        for _ in range(repeats):
            for i, op in enumerate(thunks):
                if on_card:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    op()
                    end.record()
                    end.synchronize()
                    samples[i].append(start.elapsed_time(end) / 1e3)
                else:
                    t0 = time.perf_counter()
                    op()
                    samples[i].append(time.perf_counter() - t0)
    _MEASURE_CALLS += len(grid)
    return [sorted(s)[len(s) // 2] for s in samples]


def plan_layout(
    graph: CSRGraph,
    f_dim: int,
    *,
    backend: str = "torch",
    fused: bool = True,
    order: str = "auto",
    tiles: Optional[Sequence[tuple[int, int]]] = None,
    cache_path: Optional[str] = None,
    measure: Optional[bool] = None,
    device=None,
    seed: int = 0,
    n_heads: int = 0,
    attention: bool = False,
) -> LayoutPlan:
    """Resolve the full layout for one graph: order + autotuned tile.

    ``f_dim`` is the width the SpMM operand runs at (the model's hidden
    width, which ``lower`` passes); attention plans set ``attention=True``
    and ``n_heads`` so their entries key apart. ``measure=None`` times
    where ``_timing_available(backend, device)``; ``False`` forces the
    cost model, ``True`` forces timing. ``device`` is where timing runs
    (CUDA unless asked); the cost model needs none. The disk cache under
    ``cache_path`` (default ``default_cache_path()``) is keyed by
    ``graph_fingerprint``: a hit recomputes the permutation and measures
    nothing, and an entry the cost model made is measured again once
    timing is available.
    """
    cache_path = default_cache_path() if cache_path is None else cache_path
    key = graph_fingerprint(graph, f_dim, backend, fused, order, tiles,
                            n_heads=n_heads, attention=attention)
    if measure is None or measure:
        from repro_torch import resolve_device

        device = resolve_device(device)
    if measure is None:
        measure = _timing_available(backend, device)
    cached = _load_cache(cache_path).get(key)
    if cached is not None and measure and cached.get("source") == "cost-model":
        # timing is available now but the entry was modelled: upgrade it
        cached = None
    if cached is not None:
        mode = cached["order"]
        g_r = perm = inv = None
        if mode != "none":
            g_r, perm, inv = reorder_graph(graph, mode)
        return LayoutPlan(
            order=mode, br=int(cached["br"]), bc=int(cached["bc"]),
            bf=int(cached.get("bf", 0)), perm=perm, inv_perm=inv,
            source="cache", fingerprint=key,
            n_blocks=int(cached.get("n_blocks", 0)),
            padding_waste=float(cached.get("padding_waste", 0.0)),
            reordered_graph=g_r)

    mode, g_r, perm, inv = _select_order(graph, order)
    lane_matters = fused or backend == "cuda"
    grid = _candidate_grid(g_r, f_dim, tiles, lane_matters, backend)
    if measure:
        scores = _time_scores(g_r, f_dim, backend, fused, grid, seed, device)
        source = "measured"
    else:
        scores = _model_scores(g_r, f_dim, grid, backend)
        source = "cost-model"
    br, bc, bf = grid[int(np.argmin(scores))]
    bsr = csr_to_bsr(g_r, br=br, bc=bc)
    plan = LayoutPlan(
        order=mode, br=br, bc=bc, bf=bf, perm=perm, inv_perm=inv,
        source=source, fingerprint=key, n_blocks=bsr.n_blocks,
        padding_waste=bsr.padding_waste(),
        reordered_graph=g_r if mode != "none" else None)
    _store_entry(cache_path, key, {
        "order": mode, "br": br, "bc": bc, "bf": bf, "source": source,
        "n_blocks": plan.n_blocks, "padding_waste": plan.padding_waste,
        "backend": backend, "f_dim": int(f_dim), "fused": bool(fused),
        "attention": bool(attention), "n_heads": int(n_heads),
        "scores": {f"{g[0]}x{g[1]}x{g[2]}": float(s)
                   for g, s in zip(grid, scores)},
    })
    return plan


def cached_layout(graph: CSRGraph, f_dim: int, *, backend: str = "torch",
                  fused: bool = True, n_heads: int = 0,
                  attention: bool = False,
                  cache_path: Optional[str] = None) -> Optional[LayoutPlan]:
    """Pure cache lookup — ``None`` on a miss, never measures."""
    cache_path = default_cache_path() if cache_path is None else cache_path
    key = graph_fingerprint(graph, f_dim, backend, fused,
                            n_heads=n_heads, attention=attention)
    if key not in _load_cache(cache_path):
        return None
    # measure=False honours the entry as it is: never the upgrade path
    return plan_layout(graph, f_dim, backend=backend, fused=fused,
                       n_heads=n_heads, attention=attention,
                       cache_path=cache_path, measure=False)
