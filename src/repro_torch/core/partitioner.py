"""Adaptive Hierarchical Partitioning engine — Algorithm 4 of the paper.

A copy of ``repro/core/partitioner.py`` (the port imports nothing of the
JAX package): the same numpy calls, so given the same graph, ``k`` and
seed both packages return the same assignment and statistics, byte for
byte, and the same per-rank ``LocalView``s.

Partitioning is treated as constraint satisfaction with progressively
relaxing constraints:

  Phase I   Topology-aware minimisation: multilevel k-way (SHEM-style
            heavy-edge coarsening + greedy growth + boundary refinement)
            under a strict imbalance constraint ε=1.03; on failure relax to
            ε=1.20 and retry with recursive bisection.
  Phase II  Component-aware bin packing: BFS connected components,
            Best-Fit-Decreasing to minimise Σ_p |V_p − V̄|² (Eq. 6).
  Phase III Load-aware greedy fallback: vertices sorted by degree
            descending, assigned to the min-weight partition with
            weight_p = Σ_{v∈p} deg(v) + 1 (Eq. 7) — balances *computational*
            load (∝ edges, Eq. 9), not vertex counts.

METIS is not installed; Phase I reimplements the same multilevel scheme
(SHEM coarsening, ε-constrained k-way) in numpy, on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class PartitionResult:
    assignment: np.ndarray  # [n_nodes] int32 partition id
    k: int
    phase: Literal["metis_kway", "recursive_bisection", "component_packing", "greedy_degree"]
    edge_cut: int
    vertex_imbalance: float  # max_p |V_p| / (|V|/k)
    load_imbalance: float  # max_p Σdeg / (Σdeg/k)

    def partition_sizes(self) -> np.ndarray:
        return np.bincount(self.assignment, minlength=self.k)


def _edge_cut(graph: CSRGraph, part: np.ndarray) -> int:
    src, dst = graph.edge_list()
    return int(np.count_nonzero(part[src] != part[dst]))


def _imbalances(graph: CSRGraph, part: np.ndarray, k: int) -> tuple[float, float]:
    n = graph.n_rows
    deg = graph.degrees() + 1
    sizes = np.bincount(part, minlength=k).astype(np.float64)
    loads = np.bincount(part, weights=deg.astype(np.float64), minlength=k)
    v_imb = float(sizes.max() / max(n / k, 1e-9))
    l_imb = float(loads.max() / max(deg.sum() / k, 1e-9))
    return v_imb, l_imb


def _undirected_neighbors(graph: CSRGraph) -> CSRGraph:
    """Symmetrise A + Aᵀ (structure only) for traversal/coarsening."""
    src, dst = graph.edge_list()
    from repro_torch.graph.csr import csr_from_edges

    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    return csr_from_edges(src=s, dst=d, n_rows=graph.n_rows)


# ---------------------------------------------------------------------------
# Phase I: multilevel k-way (SHEM coarsening + greedy growth + refinement)
# ---------------------------------------------------------------------------

def _heavy_edge_matching(g: CSRGraph, node_w: np.ndarray, rng: np.random.Generator):
    """SHEM: visit nodes in increasing degree order, match with the
    heaviest-edge unmatched neighbour."""
    n = g.n_rows
    match = np.full(n, -1, dtype=np.int64)
    order = np.argsort(g.degrees(), kind="stable")
    for u in order:
        if match[u] >= 0:
            continue
        s, e = g.indptr[u], g.indptr[u + 1]
        best, best_w = -1, -np.inf
        for idx in range(s, e):
            v = g.indices[idx]
            if v == u or match[v] >= 0:
                continue
            w = g.data[idx]
            if w > best_w:
                best, best_w = v, w
        if best >= 0:
            match[u], match[best] = best, u
        else:
            match[u] = u
    # build coarse ids
    coarse_id = np.full(n, -1, dtype=np.int64)
    nxt = 0
    for u in range(n):
        if coarse_id[u] >= 0:
            continue
        coarse_id[u] = nxt
        v = match[u]
        if v != u and v >= 0:
            coarse_id[v] = nxt
        nxt += 1
    return coarse_id, nxt


def _coarsen(g: CSRGraph, node_w: np.ndarray, rng: np.random.Generator):
    coarse_id, n_coarse = _heavy_edge_matching(g, node_w, rng)
    src, dst = g.edge_list()
    cs, cd = coarse_id[src], coarse_id[dst]
    keep = cs != cd
    from repro_torch.graph.csr import csr_from_edges

    # sum parallel edge weights
    key = cd[keep] * n_coarse + cs[keep]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    w_s = g.data[np.nonzero(keep)[0][order]]
    uniq, start = np.unique(key_s, return_index=True)
    w_sum = np.add.reduceat(w_s, start) if len(w_s) else np.zeros(0, dtype=np.float32)
    cg = csr_from_edges(
        src=(uniq % n_coarse), dst=(uniq // n_coarse), n_rows=n_coarse,
        data=w_sum.astype(np.float32), dedupe=False,
    )
    new_w = np.bincount(coarse_id, weights=node_w, minlength=n_coarse)
    return cg, new_w, coarse_id


def _greedy_growth_kway(g: CSRGraph, node_w: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """BFS region growing from k seeds, weight-capped — initial partition."""
    n = g.n_rows
    part = np.full(n, -1, dtype=np.int64)
    target = node_w.sum() / k
    deg = g.degrees()
    seeds = list(np.argsort(-deg)[: 4 * k])
    rng.shuffle(seeds)
    loads = np.zeros(k)
    frontiers: list[list[int]] = [[] for _ in range(k)]
    si = 0
    for p in range(k):
        while si < len(seeds) and part[seeds[si]] >= 0:
            si += 1
        if si < len(seeds):
            u = seeds[si]
            part[u] = p
            loads[p] += node_w[u]
            frontiers[p].append(int(u))
    active = True
    while active:
        active = False
        for p in np.argsort(loads):
            if loads[p] >= target * 1.02 or not frontiers[p]:
                continue
            u = frontiers[p].pop()
            s, e = g.indptr[u], g.indptr[u + 1]
            for v in g.indices[s:e]:
                if part[v] < 0:
                    part[v] = p
                    loads[p] += node_w[v]
                    frontiers[p].append(int(v))
                    active = True
                    break
            else:
                continue
    # unassigned nodes (other components / overflow) -> lightest partition
    for u in np.nonzero(part < 0)[0]:
        p = int(np.argmin(loads))
        part[u] = p
        loads[p] += node_w[u]
    return part


def _refine_boundary(g: CSRGraph, node_w: np.ndarray, part: np.ndarray, k: int,
                     epsilon: float, passes: int = 4) -> np.ndarray:
    """KL/FM-lite: move boundary vertices to the neighbour-majority partition
    when it reduces cut and keeps balance within ε."""
    part = part.copy()
    target = node_w.sum() / k
    loads = np.bincount(part, weights=node_w, minlength=k).astype(np.float64)
    for _ in range(passes):
        moved = 0
        for u in range(g.n_rows):
            s, e = g.indptr[u], g.indptr[u + 1]
            if s == e:
                continue
            neigh = g.indices[s:e]
            w = g.data[s:e]
            gain = np.zeros(k)
            np.add.at(gain, part[neigh], w)
            cur = part[u]
            gain_cur = gain[cur]
            gain[cur] = -np.inf
            best = int(np.argmax(gain))
            if gain[best] > gain_cur and loads[best] + node_w[u] <= epsilon * target:
                loads[cur] -= node_w[u]
                loads[best] += node_w[u]
                part[u] = best
                moved += 1
        if moved == 0:
            break
    return part


def _weighted_cut(g: CSRGraph, part: np.ndarray) -> float:
    """Σ of edge weights crossing the partition — comparable across
    coarsening levels (coarse edge weights sum the fine edges they contract)."""
    src, dst = g.edge_list()
    return float(g.data[part[src] != part[dst]].sum())


def _multilevel_kway(graph: CSRGraph, k: int, epsilon: float, seed: int,
                     coarsen_to: int = 256,
                     trace: Optional[list] = None) -> Optional[np.ndarray]:
    """Multilevel k-way: coarsen, partition the coarsest graph, then refine
    at *every* uncoarsening level (KL/FM boundary passes on each finer
    graph, as METIS does). ``trace``, if given, collects the weighted
    edge-cut after each refinement — monotonically non-increasing, since
    projection preserves the weighted cut exactly and refinement only takes
    cut-reducing moves."""
    rng = np.random.default_rng(seed)
    und = _undirected_neighbors(graph)
    levels = []  # (coarse_id, finer graph, finer node weights)
    g, w = und, np.ones(und.n_rows)
    while g.n_rows > max(coarsen_to, 8 * k):
        cg, cw, cid = _coarsen(g, w, rng)
        if cg.n_rows >= g.n_rows * 0.95:  # matching stalled
            break
        levels.append((cid, g, w))
        g, w = cg, cw
    part = _greedy_growth_kway(g, w, k, rng)
    part = _refine_boundary(g, w, part, k, epsilon)
    if trace is not None:
        trace.append(_weighted_cut(g, part))
    for cid, fine_g, fine_w in reversed(levels):
        part = part[cid]  # project onto the finer level (cut preserved)
        part = _refine_boundary(fine_g, fine_w, part, k, epsilon)
        if trace is not None:
            trace.append(_weighted_cut(fine_g, part))
    v_imb, _ = _imbalances(graph, part, k)
    if v_imb > epsilon or len(np.unique(part)) < k:
        return None  # convergence failure -> escalate (Alg 4 line 4)
    return part


def _recursive_bisection(graph: CSRGraph, k: int, epsilon: float, seed: int) -> Optional[np.ndarray]:
    """Recursive 2-way multilevel splits — higher stability on irregular
    graphs (Alg 4 line 6)."""
    n = graph.n_rows
    part = np.zeros(n, dtype=np.int64)

    def split(nodes: np.ndarray, k_sub: int, base: int, depth: int):
        if k_sub == 1 or len(nodes) == 0:
            part[nodes] = base
            return
        k_left = k_sub // 2
        k_right = k_sub - k_left
        sub = _induced_subgraph(graph, nodes)
        two = _multilevel_kway(sub, 2, epsilon, seed + depth) if sub.n_rows > 2 else None
        if two is None:
            order = np.argsort(-(graph.degrees()[nodes]))
            two = np.zeros(len(nodes), dtype=np.int64)
            loads = np.zeros(2)
            quota = np.array([k_left, k_right], dtype=np.float64)
            for i in order:
                p = int(np.argmin(loads / quota))
                two[i] = p
                loads[p] += graph.degrees()[nodes[i]] + 1
        left = nodes[two == 0]
        right = nodes[two == 1]
        split(left, k_left, base, depth + 1)
        split(right, k_right, base + k_left, depth + 7)

    split(np.arange(n), k, 0, 0)
    v_imb, _ = _imbalances(graph, part, k)
    if v_imb > epsilon * 1.5 or len(np.unique(part)) < k:
        return None
    return part


def _induced_subgraph(graph: CSRGraph, nodes: np.ndarray) -> CSRGraph:
    from repro_torch.graph.csr import csr_from_edges

    remap = np.full(graph.n_rows, -1, dtype=np.int64)
    remap[nodes] = np.arange(len(nodes))
    src, dst = graph.edge_list()
    keep = (remap[src] >= 0) & (remap[dst] >= 0)
    return csr_from_edges(
        src=remap[src[keep]], dst=remap[dst[keep]], n_rows=len(nodes),
        data=graph.data[keep], dedupe=False,
    )


# ---------------------------------------------------------------------------
# Phase II: component-aware Best-Fit-Decreasing bin packing (Eq. 6)
# ---------------------------------------------------------------------------

def connected_components(graph: CSRGraph) -> np.ndarray:
    """BFS components on the symmetrised structure."""
    und = _undirected_neighbors(graph)
    n = und.n_rows
    comp = np.full(n, -1, dtype=np.int64)
    cid = 0
    for s0 in range(n):
        if comp[s0] >= 0:
            continue
        stack = [s0]
        comp[s0] = cid
        while stack:
            u = stack.pop()
            lo, hi = und.indptr[u], und.indptr[u + 1]
            for v in und.indices[lo:hi]:
                if comp[v] < 0:
                    comp[v] = cid
                    stack.append(int(v))
        cid += 1
    return comp


def _component_packing(graph: CSRGraph, k: int) -> Optional[np.ndarray]:
    comp = connected_components(graph)
    n_comp = int(comp.max()) + 1
    if n_comp <= 1:
        return None  # Alg 4: only applicable when |Comps| > 1
    sizes = np.bincount(comp)
    order = np.argsort(-sizes)  # decreasing
    weights = np.zeros(k)
    comp_part = np.zeros(n_comp, dtype=np.int64)
    for c in order:
        p = int(np.argmin(weights))  # best-fit = currently lightest (Eq. 6)
        comp_part[c] = p
        weights[p] += sizes[c]
    return comp_part[comp]


# ---------------------------------------------------------------------------
# Phase III: load-aware greedy fallback (Eq. 7)
# ---------------------------------------------------------------------------

def _greedy_degree(graph: CSRGraph, k: int) -> np.ndarray:
    deg = graph.degrees()
    order = np.argsort(-deg, kind="stable")  # hubs first
    part = np.zeros(graph.n_rows, dtype=np.int64)
    weights = np.zeros(k)
    for v in order:
        p = int(np.argmin(weights))
        part[v] = p
        weights[p] += deg[v] + 1  # Alg 4 line 30
    return part


def greedy_vertex_count(graph: CSRGraph, k: int) -> np.ndarray:
    """The *standard* baseline the paper argues against: balance |V_p|."""
    order = np.argsort(-graph.degrees(), kind="stable")
    part = np.zeros(graph.n_rows, dtype=np.int64)
    counts = np.zeros(k)
    for v in order:
        p = int(np.argmin(counts))
        part[v] = p
        counts[p] += 1
    return part


# ---------------------------------------------------------------------------
# Driver — Algorithm 4
# ---------------------------------------------------------------------------

def hierarchical_partition(
    graph: CSRGraph,
    k: int,
    seed: int = 0,
    epsilon_strict: float = 1.03,
    epsilon_relaxed: float = 1.20,
    force_phase: Optional[str] = None,
) -> PartitionResult:
    """Run Alg 4's phase-escalation and return the partition + quality stats."""
    if k <= 0:
        raise ValueError("k must be positive")
    if k == 1:
        part = np.zeros(graph.n_rows, dtype=np.int64)
        v, l = _imbalances(graph, part, 1)
        return PartitionResult(part.astype(np.int32), 1, "metis_kway", 0, v, l)

    attempts: list[tuple[str, Optional[np.ndarray]]] = []
    if force_phase in (None, "metis_kway"):
        attempts.append(("metis_kway", _multilevel_kway(graph, k, epsilon_strict, seed)))
    if force_phase in (None, "recursive_bisection") and not any(p is not None for _, p in attempts):
        attempts.append((
            "recursive_bisection",
            _recursive_bisection(graph, k, epsilon_relaxed, seed),
        ))
    if force_phase in (None, "component_packing") and not any(p is not None for _, p in attempts):
        attempts.append(("component_packing", _component_packing(graph, k)))
    if force_phase == "greedy_degree" or not any(p is not None for _, p in attempts):
        attempts.append(("greedy_degree", _greedy_degree(graph, k)))

    phase, part = next((ph, p) for ph, p in attempts if p is not None)
    v_imb, l_imb = _imbalances(graph, part, k)
    return PartitionResult(
        assignment=part.astype(np.int32),
        k=k,
        phase=phase,  # type: ignore[arg-type]
        edge_cut=_edge_cut(graph, part),
        vertex_imbalance=v_imb,
        load_imbalance=l_imb,
    )


# ---------------------------------------------------------------------------
# Ghost-node views for the distributed runtime (paper §IV-E2: G2L mapping)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LocalView:
    """Per-rank view: local nodes [0, n_local) followed by ghost nodes —
    the contiguous layout that lets kernels use dense index ranges.

    Local nodes are themselves ordered ``[interior | boundary]``: the first
    ``n_interior`` slots hold nodes with no in-edge from a ghost, so their
    aggregation rows read only local columns — the rows the split-phase
    runtime computes while the halo exchange is still in flight."""

    rank: int
    global_ids: np.ndarray  # [n_local + n_ghost] global node id per local slot
    n_local: int
    n_ghost: int
    local_graph: CSRGraph  # rows = local nodes, cols = local+ghost slots
    ghost_owner: np.ndarray  # [n_ghost] owning rank of each ghost
    n_interior: int = 0  # leading local slots with no ghost in-edge


def build_local_views(graph: CSRGraph, part: np.ndarray, k: int,
                      reorder: str = "none") -> list[LocalView]:
    """Per-rank [local | ghost] views; ``reorder`` renumbers each rank's
    local block (``degree`` / ``rcm`` on the rank's induced subgraph) so
    the per-rank BSR packs denser blocks. The reorder is a permutation of
    ``local_nodes`` only — every downstream structure (halo schedule,
    feature/label/mask stacking) is derived from ``global_ids``, so the
    renumbering is baked into the data distribution and loss/grads stay
    order-invariant (DESIGN.md §9)."""
    from repro_torch.graph.csr import degree_order, rcm_order

    # interior/boundary classification (DESIGN.md §11): a node is boundary
    # iff any in-neighbour lives on another rank — its aggregation row reads
    # a ghost column. Computed once over the global edge list.
    deg = np.diff(graph.indptr)
    dst_all = np.repeat(np.arange(graph.n_rows, dtype=np.int64), deg)
    cross = part[graph.indices] != part[dst_all]
    is_boundary = np.zeros(graph.n_rows, dtype=bool)
    is_boundary[dst_all[cross]] = True

    views = []
    for rank in range(k):
        local_nodes = np.nonzero(part == rank)[0]
        if reorder != "none" and local_nodes.size > 1:
            sub = _induced_subgraph(graph, local_nodes)
            if reorder == "degree":
                order = degree_order(sub)
            elif reorder == "rcm":
                order = rcm_order(sub)
            else:
                raise ValueError(f"unknown reorder mode {reorder!r}")
            local_nodes = local_nodes[order]
        # [interior | boundary] ordering, stable within each segment so the
        # within-rank reorder (degree / rcm) survives the split
        interior_sel = ~is_boundary[local_nodes]
        n_interior = int(interior_sel.sum())
        local_nodes = np.concatenate(
            [local_nodes[interior_sel], local_nodes[~interior_sel]])
        g2l = {int(g): i for i, g in enumerate(local_nodes)}
        ghost_ids: list[int] = []
        src_l, dst_l, val_l = [], [], []
        for li, g in enumerate(local_nodes):
            s, e = graph.indptr[g], graph.indptr[g + 1]
            for idx in range(s, e):
                v = int(graph.indices[idx])
                if v in g2l:
                    slot = g2l[v]
                else:
                    slot = len(local_nodes) + len(ghost_ids)
                    g2l[v] = slot
                    ghost_ids.append(v)
                src_l.append(slot)
                dst_l.append(li)
                val_l.append(graph.data[idx])
        from repro_torch.graph.csr import csr_from_edges

        n_local = len(local_nodes)
        n_tot = n_local + len(ghost_ids)
        lg = csr_from_edges(
            src=np.asarray(src_l, dtype=np.int64),
            dst=np.asarray(dst_l, dtype=np.int64),
            n_rows=n_local, n_cols=n_tot,
            data=np.asarray(val_l, dtype=np.float32), dedupe=False,
        ) if src_l else CSRGraph(
            indptr=np.zeros(n_local + 1, dtype=np.int64),
            indices=np.zeros(0, dtype=np.int32),
            data=np.zeros(0, dtype=np.float32),
            n_rows=n_local, n_cols=n_tot,
        )
        views.append(LocalView(
            rank=rank,
            global_ids=np.concatenate([local_nodes, np.asarray(ghost_ids, dtype=np.int64)])
            if ghost_ids else local_nodes.astype(np.int64),
            n_local=n_local,
            n_ghost=len(ghost_ids),
            local_graph=lg,
            ghost_owner=part[np.asarray(ghost_ids, dtype=np.int64)].astype(np.int32)
            if ghost_ids else np.zeros(0, dtype=np.int32),
            n_interior=n_interior,
        ))
    return views
