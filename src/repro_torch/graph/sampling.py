"""Seeded fanout-based neighbour sampling over ``CSRGraph`` (DESIGN.md §7).

GraphSAGE-style mini-batch construction: starting from a batch of seed
nodes, walk the graph backwards through the model's L layers, keeping at
most ``fanouts[l]`` in-neighbours per destination node, and emit one
``SampledBlock`` per layer — a rectangular CSR operand over *relabeled*
node frontiers. Rows of block ``l`` are the layer's destination frontier
(level ``l+1``), columns its source frontier (level ``l``); destination
nodes occupy the leading columns, so the self/skip term of SAGE/GIN is a
leading-row slice (``LayerOps.restrict``). A sampled block is just a
smaller sparse operand: the same CSR→BSR lowering and backend primitives
the full-batch path uses apply unchanged — Morphling's "memory-efficient
layouts" argument, with graph size decoupled from device memory.

Shapes are **bucketed**: a batch of ``s`` seeds is padded to the smallest
bucket whose caps fit ``s``. Caps are deterministic worst-case bounds
derived from the bucket's seed capacity and the fanouts alone (clamped by
graph size), so every batch landing in a bucket presents *identical* array
shapes to the executor — at most one distinct shape signature per bucket,
not one per batch. The price is padding (zero feature rows, zero
BSR blocks, weight-0 edges targeting a reserved "dump" row); the trainer
re-zeroes padded rows between layers with the per-level validity masks
this module emits.

Everything here is host-side numpy; device transfer happens in the
trainer. A copy of ``repro/graph/sampling.py``: the same rng calls in the
same order, so both packages draw byte-identical batches from one seed.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np

from repro_torch.graph.csr import BSRMatrix, CSRGraph, csr_from_edges, csr_to_bsr


def _round_up(v: int, m: int) -> int:
    return -(-int(v) // m) * m


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Deterministic worst-case shape caps for one batch-size bucket.

    ``node_caps[l]`` is the padded size of frontier level ``l`` (level 0 is
    the input frontier, level L the seeds); every cap reserves one trailing
    dump row for padding edges and is aligned to lcm(br, bc) so the BSR of
    a block and of its transpose agree on padding. ``*_block_caps`` bound
    the flattened-BSR block counts (#nonzero (row, col) block pairs plus
    one explicit zero block per empty block-row — the bound ``csr_to_bsr``
    can never exceed).
    """

    seed_cap: int
    node_caps: tuple[int, ...]       # L+1 entries
    nnz_caps: tuple[int, ...]        # L entries
    fwd_block_caps: tuple[int, ...]  # L entries, BSR of the block
    bwd_block_caps: tuple[int, ...]  # L entries, BSR of its transpose
    br: int
    bc: int
    feat_nnz_cap: int = 0  # >0 once the Alg-1 sparse input path is bound


def make_bucket_specs(
    graph: CSRGraph,
    fanouts: Sequence[int],
    batch_size: int,
    n_buckets: int,
    br: int,
    bc: int,
) -> tuple[BucketSpec, ...]:
    """Geometric seed-capacity buckets [B/2^(k), ..., B/2, B] with caps.

    Worst-case frontier growth per level is ``v[l] = v[l+1] * (1 + fanout)``
    (every destination keeps itself plus ``fanout`` distinct new sources),
    clamped by the graph's node count; edge counts by ``v[l+1] * fanout``
    clamped by nnz. Caps depend only on (bucket, fanouts, graph size), so
    a jitted step sees at most ``n_buckets`` distinct shape signatures.
    """
    L = len(fanouts)
    align = int(np.lcm(br, bc))
    specs: list[BucketSpec] = []
    for k in range(n_buckets):
        seed_cap = max(1, -(-batch_size // (2 ** (n_buckets - 1 - k))))
        v = [0] * (L + 1)
        v[L] = min(seed_cap, graph.n_rows)
        for l in range(L - 1, -1, -1):
            v[l] = min(v[l + 1] * (1 + fanouts[l]), graph.n_rows)
        node_caps = tuple(_round_up(v[l] + 1, align) for l in range(L + 1))
        nnz_caps = tuple(
            max(min(v[l + 1] * fanouts[l], graph.nnz), 1) for l in range(L))
        fwd_caps, bwd_caps = [], []
        for l in range(L):
            grid = (node_caps[l + 1] // br) * (node_caps[l] // bc)
            fwd_caps.append(min(nnz_caps[l], grid) + node_caps[l + 1] // br)
            grid_t = (node_caps[l] // br) * (node_caps[l + 1] // bc)
            bwd_caps.append(min(nnz_caps[l], grid_t) + node_caps[l] // br)
        specs.append(BucketSpec(
            seed_cap=seed_cap, node_caps=node_caps, nnz_caps=nnz_caps,
            fwd_block_caps=tuple(fwd_caps), bwd_block_caps=tuple(bwd_caps),
            br=br, bc=bc,
        ))
    return tuple(specs)


def _pad_bsr(bsr: BSRMatrix, cap: int) -> dict[str, np.ndarray]:
    """Pad flattened BSR arrays to ``cap`` blocks with explicit zero blocks.

    Padding blocks attach to the last block-row with ``first_in_row=0`` —
    they accumulate zeros, keep the row-sorted invariant both the CUDA
    kernel and the plain version rely on, and make the block count a
    bucket-determined constant.
    """
    nb = bsr.n_blocks
    if nb > cap:
        raise AssertionError(
            f"BSR block count {nb} exceeds bucket cap {cap} (internal bound "
            f"violated)")
    pad = cap - nb
    last_row = int(bsr.block_rows[-1])
    return {
        "rows": np.concatenate(
            [bsr.block_rows, np.full(pad, last_row, np.int32)]),
        "cols": np.concatenate([bsr.block_cols, np.zeros(pad, np.int32)]),
        "first": np.concatenate([bsr.first_in_row, np.zeros(pad, np.int32)]),
        "blocks": np.concatenate(
            [bsr.blocks, np.zeros((pad, bsr.br, bsr.bc), np.float32)], axis=0),
    }


@dataclasses.dataclass
class SampledBlock:
    """One layer's bipartite message-passing operand (dst ← src frontier)."""

    layer: int
    dst_nodes: np.ndarray   # [n_dst] global ids of the destination frontier
    src_nodes: np.ndarray   # [n_src] global ids; [:n_dst] == dst_nodes
    csr: CSRGraph           # [dst_cap, src_cap] sampled weighted edges
    edge_src: np.ndarray    # [nnz_cap] int32 local src ids (padded)
    edge_dst: np.ndarray    # [nnz_cap] int32 local dst ids (pad -> dump row)
    edge_w: np.ndarray      # [nnz_cap] float32 (pad -> 0)
    n_edges: int
    fwd_bsr: Optional[dict] = None  # padded flattened BSR of csr
    bwd_bsr: Optional[dict] = None  # padded flattened BSR of csr.transpose()

    @property
    def n_dst(self) -> int:
        return int(self.dst_nodes.shape[0])

    @property
    def n_src(self) -> int:
        return int(self.src_nodes.shape[0])


@dataclasses.dataclass
class SampledBatch:
    """A bucketed, padded mini-batch: blocks + gathered frontier features."""

    bucket: BucketSpec
    seeds: np.ndarray             # [n_seeds] global seed ids
    blocks: list[SampledBlock]    # layer 0 first
    valid: list[np.ndarray]       # L+1 bool masks [node_caps[l]]
    x: Optional[np.ndarray]       # [node_caps[0], F] gathered, zero-padded
    labels: Optional[np.ndarray]  # [node_caps[L]] int32, zero-padded
    # (rows, cols, vals) COO of the valid region of x, padded to
    # feat_nnz_cap — present iff the plan bound the sparse input path and
    # this batch's nonzeros fit the cap
    feat_coo: Optional[tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    feat_overflow: bool = False

    @property
    def n_seeds(self) -> int:
        return int(self.seeds.shape[0])


class NeighborSampler:
    """Fanout-bounded neighbour sampler emitting bucketed ``SampledBatch``es.

    ``graph`` must already carry the aggregation weighting (the full-graph
    ``sym``/``row`` normalisation is applied *before* sampling, exactly as
    the full-batch path pre-weights its operands — so a full-fanout batch
    reproduces full-batch numerics bit-for-layout, the parity anchor).

    Deterministic: a fixed ``seed`` yields an identical batch sequence.
    """

    def __init__(
        self,
        graph: CSRGraph,
        fanouts: Sequence[int],
        batch_size: int,
        *,
        n_buckets: int = 2,
        br: int = 8,
        bc: int = 8,
        seed: int = 0,
        emit_bsr: bool = True,
    ):
        fanouts = tuple(int(f) for f in fanouts)
        if not fanouts or any(f < 1 for f in fanouts):
            raise ValueError(f"fanouts must be positive, got {fanouts!r}")
        if batch_size < 1 or n_buckets < 1:
            raise ValueError("batch_size and n_buckets must be >= 1")
        self.graph = graph
        self.fanouts = fanouts
        self.batch_size = int(batch_size)
        self.n_buckets = int(n_buckets)
        self.br, self.bc = br, bc
        self.emit_bsr = emit_bsr
        self.buckets = make_bucket_specs(
            graph, fanouts, batch_size, n_buckets, br, bc)
        self.rng = np.random.default_rng(seed)
        # scratch global->local relabel table, reset after each block
        self._lookup = np.full(graph.n_rows, -1, dtype=np.int64)

    @property
    def n_layers(self) -> int:
        return len(self.fanouts)

    def bucket_for(self, n_seeds: int) -> BucketSpec:
        for spec in self.buckets:  # seed caps ascend; pick the smallest fit
            if spec.seed_cap >= n_seeds:
                return spec
        raise ValueError(
            f"batch of {n_seeds} seeds exceeds batch_size={self.batch_size}; "
            f"chunk the request with split_request() first")

    def split_request(self, node_ids: np.ndarray) -> Iterator[np.ndarray]:
        """Yield ``<= batch_size`` chunks of an arbitrary-size request.

        ``bucket_for`` rejects waves larger than the largest bucket by
        design (caps are derived from ``batch_size``); every serve/batch-
        inference caller must chunk oversize requests through this helper
        instead of crashing. Order is preserved; an empty request yields
        nothing.
        """
        ids = np.asarray(node_ids)
        for i in range(0, ids.shape[0], self.batch_size):
            yield ids[i: i + self.batch_size]

    def set_feature_caps(self, caps: Sequence[int]) -> None:
        """Bind per-bucket COO capacities for the Alg-1 sparse input path
        (called by ``lower_sampled`` once the template decision is made)."""
        if len(caps) != len(self.buckets):
            raise ValueError("one feature cap per bucket required")
        self.buckets = tuple(
            dataclasses.replace(b, feat_nnz_cap=int(c))
            for b, c in zip(self.buckets, caps))

    # -- sampling -----------------------------------------------------------

    def _sample_block(self, layer: int, dst_nodes: np.ndarray,
                      bucket: BucketSpec, rng: np.random.Generator) -> SampledBlock:
        g = self.graph
        fanout = self.fanouts[layer]
        dst_cap = bucket.node_caps[layer + 1]
        src_cap = bucket.node_caps[layer]
        n_dst = dst_nodes.shape[0]

        starts = g.indptr[dst_nodes].astype(np.int64)
        degs = (g.indptr[dst_nodes + 1] - g.indptr[dst_nodes]).astype(np.int64)
        full = degs <= fanout

        # rows whose whole neighbourhood fits: vectorised range extraction
        cf = degs[full]
        offs = np.repeat(starts[full], cf)
        base = np.repeat(np.cumsum(cf) - cf, cf)
        pos_full = offs + (np.arange(int(cf.sum()), dtype=np.int64) - base)
        dst_full = np.repeat(np.flatnonzero(full), cf)

        # over-degree rows: uniform sample without replacement, vectorised —
        # one random key per candidate edge, keep the fanout smallest keys
        # per row (segmented top-k via lexsort + within-row rank)
        over = np.flatnonzero(~full)
        if over.size:
            co = degs[over]
            offs_o = np.repeat(starts[over], co)
            base_o = np.repeat(np.cumsum(co) - co, co)
            cand_pos = offs_o + (np.arange(int(co.sum()), dtype=np.int64) - base_o)
            cand_row = np.repeat(over, co)
            order = np.lexsort((rng.random(cand_pos.shape[0]), cand_row))
            take = (np.arange(order.shape[0], dtype=np.int64) - base_o) < fanout
            pos_sampled = cand_pos[order][take]
            dst_sampled = cand_row[order][take]
        else:
            pos_sampled = np.zeros(0, np.int64)
            dst_sampled = np.zeros(0, np.int64)

        pos = np.concatenate([pos_full, pos_sampled])
        edge_dst_local = np.concatenate([dst_full, dst_sampled]).astype(np.int64)
        src_global = g.indices[pos].astype(np.int64)
        w = g.data[pos].astype(np.float32)

        # relabel: dst frontier keeps its order as the prefix, new sources
        # follow in sorted-global-id order (deterministic)
        lookup = self._lookup
        lookup[dst_nodes] = np.arange(n_dst)
        new_nodes = np.unique(src_global[lookup[src_global] < 0])
        lookup[new_nodes] = n_dst + np.arange(new_nodes.shape[0])
        edge_src_local = lookup[src_global]
        src_nodes = np.concatenate([dst_nodes, new_nodes])
        lookup[src_nodes] = -1  # reset scratch

        n_edges = int(pos.shape[0])
        nnz_cap = bucket.nnz_caps[layer]
        assert src_nodes.shape[0] < src_cap and n_edges <= nnz_cap, \
            "bucket caps violated (worst-case bound broken)"

        csr = csr_from_edges(
            src=edge_src_local, dst=edge_dst_local,
            n_rows=dst_cap, n_cols=src_cap, data=w, dedupe=False)

        # padded edge arrays: padding edges carry weight 0 and target the
        # reserved dump row, so every segment-path op (sum, max, GAT
        # softmax) sees them land on a row the validity masks discard
        e_src = np.zeros(nnz_cap, np.int32)
        e_dst = np.full(nnz_cap, dst_cap - 1, np.int32)
        e_w = np.zeros(nnz_cap, np.float32)
        e_src[:n_edges] = edge_src_local
        e_dst[:n_edges] = edge_dst_local
        e_w[:n_edges] = w

        fwd = bwd = None
        if self.emit_bsr:
            fwd = _pad_bsr(csr_to_bsr(csr, br=self.br, bc=self.bc),
                           bucket.fwd_block_caps[layer])
            bwd = _pad_bsr(csr_to_bsr(csr.transpose(), br=self.br, bc=self.bc),
                           bucket.bwd_block_caps[layer])

        return SampledBlock(
            layer=layer, dst_nodes=dst_nodes, src_nodes=src_nodes, csr=csr,
            edge_src=e_src, edge_dst=e_dst, edge_w=e_w, n_edges=n_edges,
            fwd_bsr=fwd, bwd_bsr=bwd,
        )

    def sample_batch(
        self,
        seeds: np.ndarray,
        features: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> SampledBatch:
        """Sample the L-layer block stack for one batch of seed nodes."""
        rng = self.rng if rng is None else rng
        seeds = np.asarray(seeds, dtype=np.int64)
        bucket = self.bucket_for(seeds.shape[0])
        L = self.n_layers

        blocks: list[Optional[SampledBlock]] = [None] * L
        frontier = seeds
        for l in range(L - 1, -1, -1):
            blk = self._sample_block(l, frontier, bucket, rng)
            blocks[l] = blk
            frontier = blk.src_nodes

        valid = []
        counts = [blocks[0].n_src] + [blocks[l].n_dst for l in range(L)]
        for l in range(L + 1):
            m = np.zeros(bucket.node_caps[l], dtype=bool)
            m[: counts[l]] = True
            valid.append(m)

        x = None
        feat_coo = None
        overflow = False
        if features is not None:
            frontier0 = blocks[0].src_nodes
            x = np.zeros((bucket.node_caps[0], features.shape[-1]), np.float32)
            x[: frontier0.shape[0]] = features[frontier0]
            if bucket.feat_nnz_cap > 0:
                rr, cc = np.nonzero(x)
                if rr.shape[0] <= bucket.feat_nnz_cap:
                    rows = np.zeros(bucket.feat_nnz_cap, np.int32)
                    cols = np.zeros(bucket.feat_nnz_cap, np.int32)
                    vals = np.zeros(bucket.feat_nnz_cap, np.float32)
                    rows[: rr.shape[0]] = rr
                    cols[: rr.shape[0]] = cc
                    vals[: rr.shape[0]] = x[rr, cc]
                    feat_coo = (rows, cols, vals)
                else:  # denser batch than the template predicted
                    overflow = True

        lab = np.zeros(bucket.node_caps[L], np.int32)
        if labels is not None:
            lab[: seeds.shape[0]] = np.asarray(labels)[seeds]

        return SampledBatch(
            bucket=bucket, seeds=seeds, blocks=blocks, valid=valid, x=x,
            labels=lab, feat_coo=feat_coo, feat_overflow=overflow,
        )

    def epoch_batches(
        self,
        seed_ids: np.ndarray,
        features: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        rng: Optional[np.random.Generator] = None,
        shuffle: bool = True,
    ) -> Iterator[SampledBatch]:
        """One epoch over ``seed_ids`` in batches (reshuffled when asked)."""
        rng = self.rng if rng is None else rng
        ids = np.asarray(seed_ids, dtype=np.int64)
        if shuffle:
            ids = ids[rng.permutation(ids.shape[0])]
        for i in range(0, ids.shape[0], self.batch_size):
            yield self.sample_batch(
                ids[i: i + self.batch_size], features, labels, rng=rng)
