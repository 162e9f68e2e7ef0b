"""Synthetic dataset generators statistically matching the paper's Table II.

We cannot ship Reddit/AmazonProducts; instead each dataset is generated with
the same *shape statistics* that stress Morphling's machinery: node/edge
counts (scalable), feature dimensionality, class count, power-law degree
distribution, and — critically for the sparsity engine — the feature sparsity
regime (NELL ≈ 99.2% sparse bag-of-words vs Reddit's dense 602-dim features).

A copy of ``repro/graph/datasets.py``: the same numpy rng calls, so both
packages generate byte-identical data from one seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.graph.csr import CSRGraph, csr_from_edges


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    name: str
    n_nodes: int
    n_edges: int
    n_features: int
    n_classes: int
    feature_sparsity: float  # fraction of zero entries in X
    power_law_alpha: float = 2.1  # degree distribution exponent
    n_components: int = 1  # >1 exercises partitioner Phase II


# Table II analogs. ``feature_sparsity`` reflects the regimes discussed in
# §V-C (NELL 99.21% sparse; Reddit dense). Scaled at generation time.
DATASET_SPECS: dict[str, SyntheticSpec] = {
    "corafull": SyntheticSpec("corafull", 19_793, 126_842, 8_710, 70, 0.95),
    "physics": SyntheticSpec("physics", 34_493, 495_924, 8_415, 5, 0.95),
    "ppi": SyntheticSpec("ppi", 56_944, 1_612_348, 50, 121, 0.10, n_components=20),
    "nell": SyntheticSpec("nell", 65_755, 251_550, 61_278, 186, 0.9921),
    "flickr": SyntheticSpec("flickr", 88_250, 899_756, 500, 7, 0.45),
    "reddit": SyntheticSpec("reddit", 232_965, 114_615_892, 602, 41, 0.0),
    "yelp": SyntheticSpec("yelp", 716_847, 13_954_819, 300, 100, 0.25),
    "amazonproducts": SyntheticSpec("amazonproducts", 1_569_960, 264_339_468, 200, 107, 0.15),
    "ogbn-arxiv": SyntheticSpec("ogbn-arxiv", 169_343, 1_166_243, 128, 40, 0.0),
    "ogbn-products": SyntheticSpec("ogbn-products", 2_449_029, 61_859_140, 100, 47, 0.05),
    # pathological star graph — exercises partitioner Phase III
    "stargraph": SyntheticSpec("stargraph", 10_000, 9_999, 64, 4, 0.5, power_law_alpha=1.2),
}


@dataclasses.dataclass
class GraphDataset:
    name: str
    graph: CSRGraph  # row-normalised adjacency not applied; raw A with self loops
    features: np.ndarray  # [N, F] float32, with the requested sparsity
    labels: np.ndarray  # [N] int32
    n_classes: int
    train_mask: np.ndarray  # [N] bool (~70%)
    spec: SyntheticSpec
    # held-out splits (~15% each, disjoint from train) — the mini-batch
    # path's generalisation probes; None only for hand-built datasets
    val_mask: Optional[np.ndarray] = None
    test_mask: Optional[np.ndarray] = None

    @property
    def feature_sparsity(self) -> float:
        total = self.features.size
        return 1.0 - (np.count_nonzero(self.features) / max(total, 1))


def _power_law_degrees(n: int, mean_deg: float, alpha: float, rng: np.random.Generator) -> np.ndarray:
    """Sample a power-law-ish degree sequence with the requested mean."""
    raw = rng.pareto(alpha - 1.0, size=n) + 1.0
    deg = raw / raw.mean() * mean_deg
    return np.maximum(deg.round().astype(np.int64), 1)


def generate_dataset(
    name: str,
    scale: float = 1.0,
    seed: int = 0,
    max_nodes: Optional[int] = None,
    add_self_loops: bool = True,
) -> GraphDataset:
    """Generate a synthetic analog of dataset ``name`` at ``scale``.

    ``scale`` < 1 shrinks nodes/edges/features proportionally so the same
    statistical regime runs on CPU in tests and benchmarks.
    """
    spec = DATASET_SPECS[name]
    rng = np.random.default_rng(seed)
    n = max(int(spec.n_nodes * scale), 32)
    if max_nodes is not None:
        n = min(n, max_nodes)
    f = max(int(spec.n_features * min(scale * 4, 1.0)), 8)
    e_target = max(int(spec.n_edges * scale * (n / max(int(spec.n_nodes * scale), 1))), n)
    mean_deg = max(e_target / n, 1.0)

    # --- topology: power-law in-degrees, possibly multiple components ---
    comps = max(int(spec.n_components * min(scale * 10, 1.0)), 1) if spec.n_components > 1 else 1
    comp_of = rng.integers(0, comps, size=n) if comps > 1 else np.zeros(n, dtype=np.int64)
    deg = _power_law_degrees(n, mean_deg, spec.power_law_alpha, rng)
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    # sources drawn within the same component (rejection-free: sample then map)
    src = rng.integers(0, n, size=dst.shape[0])
    if comps > 1:
        # remap each source into its dst's component by modular fold
        comp_nodes = [np.where(comp_of == c)[0] for c in range(comps)]
        for c in range(comps):
            sel = comp_of[dst] == c
            nodes_c = comp_nodes[c]
            if len(nodes_c) == 0:
                continue
            src[sel] = nodes_c[src[sel] % len(nodes_c)]
    if add_self_loops:
        src = np.concatenate([src, np.arange(n)])
        dst = np.concatenate([dst, np.arange(n)])
    graph = csr_from_edges(src=src, dst=dst, n_rows=n)

    # --- features at the requested sparsity regime ---
    x = rng.standard_normal((n, f)).astype(np.float32)
    if spec.feature_sparsity > 0:
        mask = rng.random((n, f)) < spec.feature_sparsity
        x[mask] = 0.0
    labels = rng.integers(0, spec.n_classes, size=n).astype(np.int32)
    # one uniform draw splits 70/15/15 — the same stream position as the
    # seed's train_mask draw, so existing seeds reproduce their train split
    u = rng.random(n)
    train_mask = u < 0.7
    val_mask = (u >= 0.7) & (u < 0.85)
    test_mask = u >= 0.85
    return GraphDataset(
        name=name, graph=graph, features=x, labels=labels,
        n_classes=spec.n_classes, train_mask=train_mask, spec=spec,
        val_mask=val_mask, test_mask=test_mask,
    )
