"""The lowering pass: GNN spec -> per-layer plans (DESIGN.md §3, §7).

Counterpart of ``repro/core/lowering.py``'s ``lower`` (full batch: a
``ModelPlan``), ``lower_sampled`` (mini-batch: a ``SampledModelPlan``)
and ``lower_distributed`` (node-sharded over P ranks: a
``DistributedModelPlan``).
A spec becomes per-layer ``LayerPlan`` records naming the feature path,
the backend primitives and the epilogue binding, with the same
Algorithm-1 decisions as the JAX package (measured input sparsity for
layer 0, post-activation estimates for hidden layers). ``describe()``
prints the same plan dump, with the port's backend names (``cuda`` for
``pallas``, ``torch`` for ``xla``).

Both paths run every arch (GCN, SAGE mean/sum/gcn/max, GIN, GAT, GT);
attention archs bind the fused ``spmm_attention`` on ``cuda``/``torch``
(an ``AttentionPlan`` per layer), the sampled path over each batch's
padded (A, Aᵀ) pair, and ``max`` binds ``gather.segment_max``.
``layout="auto"`` runs the layout stage (``core/layout.py:plan_layout``:
node order and a tile timed on this device, cached on disk). Every
lowering checks the plan it returns (``core/verify.py:check_plan``,
``validate="fast"`` by default, as in the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.backends import Backend, select_backend
from repro_torch.core.aggregate import (
    FusedGraphOp,
    _weighted_graph,
    make_fused_aggregate,
)
from repro_torch.core.layout import (
    LayoutPlan,
    _select_order,
    default_layout,
    plan_layout,
)
from repro_torch.core.sparsity import (
    PAPER_GAMMA_DEFAULT,
    SparsityDecision,
    decide_execution_path,
    decide_execution_path_from_stats,
    estimate_activation_sparsity,
)
from repro_torch.core.verify import _resolve_mode, check_plan
from repro_torch.graph.csr import CSRGraph, permute_graph
from repro_torch.graph.sampling import NeighborSampler


@dataclasses.dataclass(frozen=True)
class EpiloguePlan:
    """One layer's fused-epilogue record (DESIGN.md §8): which epilogue
    operands the layer's aggregation takes — ``alpha * self_term + bias``
    then an optional activation. ``apply_layer`` owns the per-arch
    algebra; this record is the plan's visible commitment."""

    self_term: bool         # fuse alpha * self_term into the aggregation
    bias: bool              # fuse the bias add
    activation: str         # "relu" | "none"
    formula: str            # human-readable algebra, for plan dumps

    def describe(self) -> str:
        return self.formula


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """One layer's attention record (DESIGN.md §10), the sibling of
    ``EpiloguePlan``: how a GAT / GT layer's edge-softmax aggregation runs.
    ``fused`` is the BSR attention kernel (online segment softmax and
    aggregation in one pass, per-edge scores never stored) with the
    recompute VJP from the saved per-row (max, denominator); unfused is the
    segment (gather) path with autograd through the per-edge tensors."""

    heads: int
    head_dim: int
    fused: bool
    vjp: str                # "recompute(m,l)" | "autodiff"
    formula: str            # human-readable algebra, for plan dumps

    def describe(self) -> str:
        mode = "fused-bsr" if self.fused else "segment"
        return (f"{self.heads}h x {self.head_dim} {mode} vjp={self.vjp} "
                f"{self.formula}")


def _attention_binding(heads: int, d_out: int, fused: bool) -> AttentionPlan:
    return AttentionPlan(
        heads=heads, head_dim=max(d_out // heads, 1), fused=fused,
        vjp="recompute(m,l)" if fused else "autodiff",
        formula="softmax_j(leaky_relu(a_dst·z_i + a_src·z_j))·z_j")


def is_attention_arch(kind: str) -> bool:
    """Archs whose aggregation is the edge-softmax attention primitive."""
    return kind in ("GAT", "GT")


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """The distributed plan's split-phase execution record (DESIGN.md §11).

    Declares that every matmul / attention aggregation layer runs the
    interior product (local columns only) while the halo exchange is on
    the wire, then the boundary product once the ghosts have landed,
    forward and backward (``backends/distributed.py``). ``live_shifts`` is
    the host-computed set of ring shifts with at least one live send on
    any rank; dead shifts are not posted. ``double_buffer_slots`` is the
    depth of the trainer's ``GhostBufferRing``. ``prefetch_depth`` > 0
    marks host-streamed operands (not ported: ROADMAP.md Queue 1, item 7).
    """

    interior_blocks: int        # fleet-total interior stream length
    boundary_blocks: int        # fleet-total boundary stream length
    live_shifts: tuple          # ring shifts actually posted
    total_shifts: int           # P - 1
    double_buffer_slots: int = 2
    prefetch_depth: int = 0     # 0 = device-resident operands

    def describe(self) -> str:
        line = (f"split-phase int={self.interior_blocks}b "
                f"bnd={self.boundary_blocks}b "
                f"shifts={len(self.live_shifts)}/{self.total_shifts} "
                f"ghost-slots={self.double_buffer_slots}")
        if self.prefetch_depth:
            line += f" prefetch={self.prefetch_depth}"
        return line


@dataclasses.dataclass
class LayerPlan:
    """One layer's synthesized execution record."""

    index: int
    op_kind: str            # GCN | SAGE | GIN | GAT | GT
    d_in: int
    d_out: int
    feature_path: str       # "sparse" | "dense" — the path that will execute
    primitive: str          # backend primitive for the feature transform
    agg_primitive: str      # backend primitive for neighbour aggregation
    decision: SparsityDecision  # this layer's Alg-1 decision
    note: str = ""
    # epilogue binding; None = unfused aggregation + separate ops
    epilogue: Optional[EpiloguePlan] = None
    # attention binding (GAT / GT layers); None for the other archs
    attention: Optional[AttentionPlan] = None
    # the layout the layer's sparse operands were built at
    layout: Optional[LayoutPlan] = None
    # differentiable w -> X @ w over pre-built BSR(X)/BSR(Xᵀ); only set on
    # a full-batch plan's sparse layer 0 (its feature matrix is known)
    sparse_xw: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)

    def describe(self) -> str:
        d = self.decision
        line = (
            f"layer {self.index}: {self.op_kind:4s} [{self.d_in} -> {self.d_out}]  "
            f"path={self.feature_path:6s} primitive={self.primitive}  "
            f"agg={self.agg_primitive}  "
            f"s={d.sparsity:.3f} tau={d.threshold:.2f} mode={d.mode}"
        )
        if self.epilogue is not None:
            line += f"  epilogue[{self.epilogue.describe()}]"
        if self.attention is not None:
            line += f"  attention[{self.attention.describe()}]"
        if self.layout is not None:
            line += f"  layout[{self.layout.describe()}]"
        if self.note:
            line += f"  ({self.note})"
        return line


@dataclasses.dataclass
class ModelPlan:
    """The synthesized full-batch program, made visible: per-layer plans +
    the shared graph operator, its operands on ``device``."""

    layers: list[LayerPlan]
    backend: str            # registry name of the chosen backend
    gamma: float
    arch: str
    aggregation: str        # effective aggregation ("gcn", "sum", ...)
    feature_sparsity: float  # measured input sparsity (0.0 if unknown)
    graph_op: FusedGraphOp = dataclasses.field(repr=False)
    # the node order + BSR tile the operands were built at; carries
    # perm/inv_perm when the order permutes
    layout: Optional[LayoutPlan] = None
    device: Optional[torch.device] = None

    @property
    def input_decision(self) -> SparsityDecision:
        """Layer 0's Alg-1 decision."""
        return self.layers[0].decision

    def describe(self) -> str:
        head = (
            f"ModelPlan: arch={self.arch} backend={self.backend} "
            f"aggregation={self.aggregation} gamma={self.gamma:.2f} "
            f"input_sparsity={self.feature_sparsity:.3f} "
            f"layers={len(self.layers)}"
        )
        return "\n".join([head] + ["  " + l.describe() for l in self.layers])


@dataclasses.dataclass
class DistributedModelPlan:
    """The synthesized *distributed* program: per-layer plans whose
    aggregation primitives are the halo-exchange compositions of
    ``backends/distributed.py``, plus the stacked per-rank sparse operands
    of the layer-0 Alg-1 input path (DESIGN.md §6). Host arrays: each
    rank binds its own slice on its device (``DistributedGNNTrainer``)."""

    layers: list[LayerPlan]
    backend: str            # "distributed"
    inner: str              # the local executor: "cuda" | "torch"
    gamma: float
    arch: str
    aggregation: str
    n_ranks: int
    feature_sparsity: float             # pooled over valid rows, all ranks
    per_rank_sparsity: np.ndarray       # [P] measured per-rank input sparsity
    # stacked per-rank BSR(X_local) / BSR(X_localᵀ): bound iff layer 0 took
    # the sparse path
    feat_fwd: Optional[dict] = dataclasses.field(default=None, repr=False)
    feat_bwd: Optional[dict] = dataclasses.field(default=None, repr=False)
    feat_f_pad: int = 0                 # shared padded feature dim of the pair
    # within-rank order + the tile the stacked operands were built at; the
    # permutation is baked into the data distribution (perm=None here)
    layout: Optional[LayoutPlan] = None
    # split-phase overlap record; None = bulk-synchronous (overlap=False,
    # a DistributedGraph without split operands, or an aggregation with no
    # overlapped composition)
    overlap: Optional[OverlapPlan] = None
    # the one rank whose feat_fwd / feat_bwd this plan holds (rank_slice)
    rank: Optional[int] = None

    @property
    def input_decision(self) -> SparsityDecision:
        return self.layers[0].decision

    def rank_slice(self, rank: int) -> "DistributedModelPlan":
        """The plan with rank ``rank``'s X_local operands alone (at index
        0), what its rank process binds; the decisions stay the fleet's."""
        if self.rank is not None:
            raise ValueError(f"already the slice of rank {self.rank}")

        def one(d):
            return None if d is None else {
                k: np.ascontiguousarray(v[rank:rank + 1]) for k, v in d.items()}

        return dataclasses.replace(self, feat_fwd=one(self.feat_fwd),
                                   feat_bwd=one(self.feat_bwd), rank=rank)

    def describe(self) -> str:
        s = self.per_rank_sparsity
        head = (
            f"DistributedModelPlan: arch={self.arch} backend={self.backend} "
            f"inner={self.inner} ranks={self.n_ranks} "
            f"aggregation={self.aggregation} gamma={self.gamma:.2f} "
            f"input_sparsity={self.feature_sparsity:.3f} "
            f"per_rank_s=[{s.min():.3f}, {s.max():.3f}] layers={len(self.layers)}"
        )
        if self.overlap is not None:
            head += f"\n  overlap[{self.overlap.describe()}]"
        return "\n".join([head] + ["  " + l.describe() for l in self.layers])


@dataclasses.dataclass
class SampledModelPlan:
    """The synthesized mini-batch program (DESIGN.md §7): per-layer plans
    whose aggregation primitives run on the sampler's bucketed
    ``SampledBlock`` operands, plus the template-batch Alg-1 decision."""

    layers: list[LayerPlan]
    backend: str
    gamma: float
    arch: str
    aggregation: str
    feature_sparsity: float   # measured on the template batch's frontier
    fanouts: tuple[int, ...]
    batch_size: int
    n_buckets: int
    sampler: NeighborSampler = dataclasses.field(repr=False)
    # full-graph order the sampler's CSR was renumbered with (the trainer
    # maps user node ids through inv_perm) + the sampler's block tile
    layout: Optional[LayoutPlan] = None
    # serving plans: the trainer never builds loss/grad closures
    infer_only: bool = False
    # where the trainer builds each batch's operands (None: the host); the
    # full-mode check builds the template batch's column streams there
    device: Optional[torch.device] = None

    def describe(self) -> str:
        head = (
            f"SampledModelPlan: arch={self.arch} backend={self.backend} "
            f"aggregation={self.aggregation} gamma={self.gamma:.2f} "
            f"fanouts={list(self.fanouts)} batch={self.batch_size} "
            f"buckets={self.n_buckets} "
            f"frontier_sparsity={self.feature_sparsity:.3f} "
            f"layers={len(self.layers)}"
            + (" infer_only" if self.infer_only else "")
        )
        lines = [head] + ["  " + l.describe() for l in self.layers]
        for b in self.sampler.buckets:
            lines.append(
                f"  bucket[seed_cap={b.seed_cap}]: node_caps={list(b.node_caps)} "
                f"nnz_caps={list(b.nnz_caps)} feat_nnz_cap={b.feat_nnz_cap}")
        return "\n".join(lines)


def lower_sampled(
    config,
    graph: CSRGraph,
    features: np.ndarray,
    *,
    fanouts,
    batch_size: int = 256,
    n_buckets: int = 2,
    gamma: float = PAPER_GAMMA_DEFAULT,
    engine: "str | Backend | None" = None,
    br: int = 8,
    bc: int = 8,
    seed: int = 0,
    use_sparse_input: bool = True,
    feat_slack: float = 2.0,
    fuse_epilogue: bool = True,
    fuse_attention: bool = True,
    layout: "LayoutPlan | str | None" = None,
    infer_only: bool = False,
    validate: str = "fast",
    device=None,
) -> SampledModelPlan:
    """Lower a GNN spec onto the neighbour-sampled mini-batch path.

    The graph is pre-weighted for the spec's aggregation and handed to a
    ``NeighborSampler`` whose bucketed shape caps bound the distinct shape
    signatures to one per bucket. Alg 1 runs on the gathered frontier
    features of a template batch; a sparse layer-0 decision binds
    ``gather.feature_matmul_sparse`` over per-batch COO operands capped at
    ``feat_slack`` times the template's density. ``layout`` renumbers the
    full graph before the sampler is built (the trainer maps user ids
    through ``inv_perm``). ``infer_only=True`` marks a serving plan.
    GAT / GT bind the fused ``spmm_attention`` over each batch's BSR pair
    on ``cuda``/``torch`` (``fuse_attention=False``: the segment path over
    the padded edge lists); ``max`` binds ``gather.segment_max``.
    ``validate`` (``"off" | "fast" | "full"``) is the depth of the
    plan-contract check run on the finished plan (``core/verify.py``).
    ``device`` is where the trainer builds each batch's operands (None:
    the host); the plan carries it, and full mode builds the template
    batch's column streams there.
    """
    _resolve_mode(validate)
    backend = select_backend(engine)
    kind = config.kind
    dims = list(config.layer_dims)
    features = np.asarray(features)
    if features.shape[-1] != dims[0]:
        raise ValueError(
            f"layer_dims[0]={dims[0]} != feature dim {features.shape[-1]}")
    if isinstance(fanouts, int):
        fanouts = (fanouts,) * config.n_layers
    fanouts = tuple(int(f) for f in fanouts)
    if len(fanouts) != config.n_layers:
        raise ValueError(
            f"need one fanout per layer ({config.n_layers}), got {fanouts!r}")

    if isinstance(layout, LayoutPlan):
        lp = dataclasses.replace(layout, br=int(br), bc=int(bc), bf=0,
                                 n_blocks=0, padding_waste=0.0,
                                 source="sampled")
    else:
        if layout is None:
            mode, g_r, perm, inv = "none", graph, None, None
        else:
            mode, g_r, perm, inv = _select_order(graph, layout)
        lp = LayoutPlan(order=mode, br=int(br), bc=int(bc), perm=perm,
                        inv_perm=inv, source="sampled",
                        reordered_graph=g_r if mode != "none" else None)
    if lp.permutes:
        graph = (lp.reordered_graph if lp.reordered_graph is not None
                 else permute_graph(graph, lp.inv_perm))
        features = features[lp.perm]
    if lp.reordered_graph is not None:  # sampler holds its own weighted copy
        lp = dataclasses.replace(lp, reordered_graph=None)

    agg = effective_aggregation(config)
    weighted = _weighted_graph(graph, agg)
    is_attn = is_attention_arch(kind)
    # matmul aggregations ride the BSR operands; attention archs join them
    # when the fused attention kernel is on (the per-batch BSR nonzero
    # pattern doubles as the attention mask); max stays edge-valued
    emit_attn = (fuse_attention and is_attn
                 and backend.name in ("cuda", "torch"))
    emit_bsr = (backend.name in ("cuda", "torch")
                and (emit_attn if is_attn else agg != "max"))
    sampler = NeighborSampler(
        weighted, fanouts, batch_size, n_buckets=n_buckets, br=br, bc=bc,
        seed=seed, emit_bsr=emit_bsr)

    # template batch: Alg-1 input statistics on a gathered frontier
    t_rng = np.random.default_rng(seed ^ 0x5EED)
    t_seeds = t_rng.choice(
        graph.n_rows, size=min(batch_size, graph.n_rows), replace=False)
    template = sampler.sample_batch(t_seeds, rng=t_rng)
    frontier0 = template.blocks[0].src_nodes
    rows = features[frontier0]
    s_frontier = 1.0 - np.count_nonzero(rows) / max(rows.size, 1)

    emit_epilogue = fuse_epilogue and epilogue_fusable(config, agg)
    if is_attn:
        agg_primitive = (f"{backend.name}.spmm_attention" if emit_attn
                         else f"{backend.name}.segment_softmax_aggregate")
    elif agg == "max":
        agg_primitive = "gather.segment_max"
    elif emit_epilogue:
        agg_primitive = f"{backend.name}.spmm_fused_epilogue"
    elif backend.name == "gather":
        agg_primitive = "gather.segment_sum_baseline"
    else:
        agg_primitive = f"{backend.name}.spmm_transposed_vjp"

    layers: list[LayerPlan] = []
    for i in range(config.n_layers):
        d_in, d_out = dims[i], dims[i + 1]
        if i == 0:
            decision = decide_execution_path_from_stats(
                s_frontier, int(frontier0.shape[0]), d_in, d_out, gamma=gamma)
        else:
            s_est = estimate_activation_sparsity(config.activation)
            decision = decide_execution_path_from_stats(
                s_est, int(frontier0.shape[0]), d_in, d_out, gamma=gamma)

        path, primitive, note = "dense", f"{backend.name}.feature_matmul_dense", ""
        if i == 0 and decision.mode == "sparse":
            expressible, expr_note = _sparse_expressible(kind)
            if not use_sparse_input:
                note = "sparse profitable but disabled (use_sparse_input=False)"
            elif not expressible:
                note = expr_note
            else:
                # per-batch feature matrices are runtime values: the sampler
                # streams COO operands in the gather backend's edge-list
                # layout, capped by the template's measured density
                f_dim = dims[0]
                caps = [
                    max(min(int(np.ceil(b.node_caps[0] * f_dim
                                        * (1.0 - s_frontier) * feat_slack)),
                            b.node_caps[0] * f_dim), 1)
                    for b in sampler.buckets
                ]
                sampler.set_feature_caps(caps)
                path = "sparse"
                primitive = "gather.feature_matmul_sparse"
                note = (f"per-batch COO operand streamed by the sampler "
                        f"(slack={feat_slack:g})")
                if expr_note:
                    note += f"; {expr_note}"
        elif decision.mode == "sparse":
            note = ("sparse profitable but activations are runtime values; "
                    "no pre-built operand — dense fallback")

        epilogue = None
        if emit_epilogue:
            epilogue = _epilogue_binding(
                config, is_last=(i == config.n_layers - 1),
                sparse_path=(path == "sparse"))
        attention = None
        if is_attn:
            attention = _attention_binding(config.gat_heads, d_out, emit_attn)

        layers.append(LayerPlan(
            index=i, op_kind=kind, d_in=d_in, d_out=d_out,
            feature_path=path, primitive=primitive,
            agg_primitive=agg_primitive, decision=decision, note=note,
            epilogue=epilogue, attention=attention, layout=lp,
        ))

    plan = SampledModelPlan(
        layers=layers, backend=backend.name, gamma=gamma, arch=kind,
        aggregation=agg, feature_sparsity=float(s_frontier), fanouts=fanouts,
        batch_size=int(batch_size), n_buckets=int(n_buckets), sampler=sampler,
        layout=lp, infer_only=bool(infer_only),
        device=None if device is None else torch.device(device),
    )
    check_plan(plan, mode=validate)
    return plan


def effective_aggregation(config) -> str:
    """The aggregation the spec lowers to: GCN always uses symmetric
    normalisation, GIN's sum is fixed by the arch, everything else takes
    ``config.aggregation``."""
    if config.kind == "GCN":
        return "gcn"
    if config.kind == "GIN":
        return "sum"
    return config.aggregation


def lower_distributed(
    config,
    dist,  # core.halo.DistributedGraph
    features: Optional[np.ndarray] = None,  # [P, n_local, F]; default dist's
    *,
    gamma: float = PAPER_GAMMA_DEFAULT,
    inner: Optional[str] = None,
    use_sparse_input: bool = True,
    fuse_epilogue: bool = True,
    fuse_attention: bool = True,
    overlap: bool = True,
    validate: str = "fast",
) -> DistributedModelPlan:
    """Lower a GNN spec onto the distributed backend, on the host, over
    every rank's arrays (the whole ``DistributedGraph``, not a rank's
    slice).

    The Alg-1 layer-0 decision runs on *per-rank* feature statistics
    (padding rows excluded via ``dist.n_valid``). The ranks run one
    program, so the sparse input path binds iff **every** rank decides
    sparse; a mixed fleet falls back to dense with the per-rank spread in
    the plan note. When the sparse path binds, the per-rank
    BSR(X_local)/BSR(X_localᵀ) pairs are built here, stacked on the rank
    axis like the graph operands.

    ``overlap=True`` binds the split-phase compositions, recorded as an
    ``OverlapPlan``; it falls back to the bulk-synchronous primitives
    when the graph carries no split operands, or for ``max`` and the
    unfused segment attention, which read the ghost buffer directly.
    ``inner`` names the local executor (``cuda`` where a card is
    present, else ``torch``: ``DistributedBackend.inner``)."""
    from repro_torch.backends import get_backend
    from repro_torch.core.halo import stack_bsr_matrices
    from repro_torch.graph.csr import csr_from_dense, csr_to_bsr

    if getattr(dist, "rank", None) is not None:
        raise ValueError("lower_distributed needs every rank's arrays, not "
                         f"the slice of rank {dist.rank}")
    backend = get_backend("distributed")
    inner_name = inner or backend.inner()
    kind = config.kind
    dims = list(config.layer_dims)
    P = dist.n_ranks

    agg = effective_aggregation(config)
    if dist.aggregation not in ("sum", agg):
        raise ValueError(
            f"DistributedGraph was weighted for {dist.aggregation!r} but the "
            f"spec needs {agg!r}; rebuild with build_distributed_graph(..., "
            f"aggregation={agg!r})")

    emit_epilogue = fuse_epilogue and epilogue_fusable(config, agg)
    is_attn = is_attention_arch(kind)
    emit_attn = fuse_attention and is_attn
    split_built = getattr(dist, "fwd_interior", None) is not None
    emit_overlap = (overlap and split_built and agg != "max"
                    and (emit_attn if is_attn else True))
    if is_attn:
        if emit_attn:
            agg_primitive = ("distributed.dist_spmm_attention_split"
                             if emit_overlap
                             else "distributed.dist_spmm_attention")
        else:
            agg_primitive = "distributed.dist_segment_softmax_aggregate"
    elif agg == "max":
        agg_primitive = "distributed.dist_segment_max"
    elif emit_epilogue:
        agg_primitive = ("distributed.dist_spmm_fused_epilogue_split"
                         if emit_overlap
                         else "distributed.dist_spmm_fused_epilogue")
    else:
        agg_primitive = ("distributed.dist_spmm_split_transposed_vjp"
                         if emit_overlap
                         else "distributed.dist_spmm_transposed_vjp")

    overlap_plan = None
    if emit_overlap:
        overlap_plan = OverlapPlan(
            interior_blocks=int(np.asarray(dist.interior_blocks).sum()),
            boundary_blocks=int(np.asarray(dist.boundary_blocks).sum()),
            live_shifts=tuple(dist.live_shifts or ()),
            total_shifts=P - 1,
        )

    feats = np.asarray(dist.features if features is None else features)
    if feats.shape[0] != P or feats.shape[1] != dist.n_local:
        raise ValueError(
            f"features must be rank-stacked [P={P}, n_local={dist.n_local}, F]")
    f_dim = feats.shape[-1]
    if dims[0] != f_dim:
        raise ValueError(f"layer_dims[0]={dims[0]} != feature dim {f_dim}")

    # within-rank order + tile the stacked operands were built at; the
    # permutation is baked into the data distribution (no perm here)
    lp = LayoutPlan(order=getattr(dist, "reorder", "none"),
                    br=dist.br, bc=dist.bc, bf=0, source="distributed")

    n_valid = (np.asarray(dist.n_valid) if dist.n_valid is not None
               else np.full(P, dist.n_local))
    per_rank_s = np.zeros(P)
    nnz_total = 0
    for p in range(P):
        rows = feats[p, : n_valid[p]]
        nnz = np.count_nonzero(rows)
        per_rank_s[p] = 1.0 - nnz / max(rows.size, 1)
        nnz_total += nnz
    pooled_s = 1.0 - nnz_total / max(int(n_valid.sum()) * f_dim, 1)

    rank_decisions = [
        decide_execution_path_from_stats(
            per_rank_s[p], int(n_valid[p]), dims[0], dims[1], gamma=gamma)
        for p in range(P)
    ]
    all_sparse = all(d.mode == "sparse" for d in rank_decisions)

    feat_fwd = feat_bwd = None
    f_pad = 0
    layers: list[LayerPlan] = []
    for i in range(config.n_layers):
        d_in, d_out = dims[i], dims[i + 1]
        if i == 0:
            decision = decide_execution_path_from_stats(
                pooled_s, int(n_valid.sum()), d_in, d_out, gamma=gamma)
        else:
            s_est = estimate_activation_sparsity(config.activation)
            decision = decide_execution_path_from_stats(
                s_est, int(n_valid.sum()), d_in, d_out, gamma=gamma)

        path, primitive, note = "dense", "distributed.feature_matmul_dense", ""
        if i == 0 and decision.mode == "sparse":
            expressible, expr_note = _sparse_expressible(kind)
            if not use_sparse_input:
                note = "sparse profitable but disabled (use_sparse_input=False)"
            elif not expressible:
                note = expr_note
            elif not all_sparse:
                note = (f"mixed fleet: {sum(d.mode == 'sparse' for d in rank_decisions)}"
                        f"/{P} ranks sparse — SPMD-uniform dense fallback")
            else:
                # the stacked per-rank sparse operands, built once, here
                br, bc = dist.br, dist.bc
                mult = int(np.lcm(br, bc))
                f_pad = -(-f_dim // mult) * mult
                fwd_stack, bwd_stack = [], []
                for p in range(P):
                    x_csr = csr_from_dense(feats[p])
                    x_csr = dataclasses.replace(x_csr, n_cols=f_pad)
                    fwd_stack.append(csr_to_bsr(x_csr, br=br, bc=bc))
                    bwd_stack.append(csr_to_bsr(x_csr.transpose(), br=br, bc=bc))
                feat_fwd = stack_bsr_matrices(fwd_stack, br, bc)
                feat_bwd = stack_bsr_matrices(bwd_stack, br, bc)
                path = "sparse"
                primitive = "distributed.dist_feature_matmul_sparse"
                note = (f"per-rank BSR(X_local); s in "
                        f"[{per_rank_s.min():.3f}, {per_rank_s.max():.3f}]")
                if expr_note:
                    note += f"; {expr_note}"
        elif decision.mode == "sparse":
            note = ("sparse profitable but activations are runtime values; "
                    "no pre-built operand — dense fallback")

        epilogue = None
        if emit_epilogue:
            epilogue = _epilogue_binding(
                config, is_last=(i == config.n_layers - 1),
                sparse_path=(path == "sparse"))
        attention = None
        if is_attn:
            attention = _attention_binding(config.gat_heads, d_out, emit_attn)

        layers.append(LayerPlan(
            index=i, op_kind=kind, d_in=d_in, d_out=d_out,
            feature_path=path, primitive=primitive,
            agg_primitive=agg_primitive, decision=decision, note=note,
            epilogue=epilogue, attention=attention, layout=lp,
        ))

    plan = DistributedModelPlan(
        layers=layers, backend="distributed", inner=inner_name, gamma=gamma,
        arch=kind, aggregation=agg, n_ranks=P, feature_sparsity=pooled_s,
        per_rank_sparsity=per_rank_s, feat_fwd=feat_fwd, feat_bwd=feat_bwd,
        feat_f_pad=f_pad, layout=lp, overlap=overlap_plan,
    )
    check_plan(plan, mode=validate, dist=dist)
    return plan


def epilogue_fusable(config, aggregation: str) -> bool:
    """Can this spec's aggregate layers take a fused epilogue at all?
    Attention archs and ``max`` keep the unfused sequence."""
    return not is_attention_arch(config.kind) and aggregation != "max"


def _epilogue_binding(config, is_last: bool,
                      sparse_path: bool) -> Optional[EpiloguePlan]:
    """The per-layer epilogue record (DESIGN.md §8 grammar).

    Only ReLU — the port's own ``torch.relu`` — lowers into the epilogue;
    any other ``config.activation`` fuses self-term/bias and leaves the
    activation outside. Per arch:

    * GCN  — ``relu(A·(X·W) + b)``.
    * SAGE — ``relu(A·(X·Wn) + X·Ws + b)`` (``A(X)·Wn == A(X·Wn)``).
    * GIN  — sparse layers ``act(A·u + (1+eps)·u + b1), u = X·W1``; dense
      layers the self-term combine ``A·x + (1+eps)·x``.
    """
    kind = config.kind
    relu_ok = config.activation is torch.relu
    post = "relu" if (relu_ok and not is_last) else "none"
    if kind == "GCN":
        f = "A·(X·W) + b"
        return EpiloguePlan(self_term=False, bias=True, activation=post,
                            formula=f"relu({f})" if post == "relu" else f)
    if kind == "SAGE":
        f = "A·(X·Wn) + X·Ws + b"
        return EpiloguePlan(self_term=True, bias=True, activation=post,
                            formula=f"relu({f})" if post == "relu" else f)
    if kind == "GIN":
        if sparse_path:
            act = "relu" if relu_ok else "none"
            f = "A·u + (1+eps)·u + b1, u = X·W1"
            return EpiloguePlan(self_term=True, bias=True, activation=act,
                                formula=f"relu({f})" if act == "relu" else f)
        return EpiloguePlan(self_term=True, bias=False, activation="none",
                            formula="A·x + (1+eps)·x")
    return None


def _sparse_expressible(kind: str) -> tuple[bool, str]:
    """Can the layer-0 X @ W be served by ``feature_matmul_sparse``?
    GIN re-associates z @ W1 = (1+eps)·(X@W1) + A·(X@W1)."""
    if kind in ("GCN", "SAGE", "GAT", "GT"):
        return True, ""
    if kind == "GIN":
        return True, "reassociated: z@W1 = (1+eps)(X@W1) + A(X@W1)"
    return False, f"no sparse lowering for {kind}"


def _resolve_layout(
    graph: CSRGraph,
    f_dim: int,
    backend_name: str,
    fused: bool,
    layout: "LayoutPlan | str | None",
    br: Optional[int],
    bc: Optional[int],
    device: torch.device,
    n_heads: int = 0,
    attention: bool = False,
) -> LayoutPlan:
    """Turn a ``layout=`` argument into a concrete ``LayoutPlan``.

    * ``None`` / ``"none"`` — identity order, explicit ``br``/``bc`` when
      given, the adaptive ``bc`` otherwise;
    * ``"auto"`` — the full layout stage: order selection and tile
      autotuning with the disk cache (``core/layout.py:plan_layout``),
      timed on ``device`` where that times the backend's kernels;
    * ``"degree"`` / ``"rcm"`` — that order with the same tile;
    * a ``LayoutPlan`` — passes through untouched.

    Explicit ``br``/``bc`` with ``"auto"`` or a ``LayoutPlan`` is a
    conflict (the layout carries the tile) and raises.
    """
    if isinstance(layout, LayoutPlan) or layout == "auto":
        if br is not None or bc is not None:
            raise ValueError(
                f"explicit br/bc conflict with layout={layout!r}: the "
                f"layout carries the tile — pass one or the other")
        if isinstance(layout, LayoutPlan):
            return layout
        return plan_layout(graph, f_dim, backend=backend_name, fused=fused,
                           device=device, n_heads=n_heads,
                           attention=attention)
    if layout is None or layout == "none":
        lp = default_layout(graph, br=br, bc=bc)
        if br is not None or bc is not None:
            lp.source = "explicit"
        return lp
    mode, g_r, perm, inv = _select_order(graph, layout)  # validates mode
    lp = default_layout(g_r, br=br, bc=bc)
    return dataclasses.replace(lp, order=mode, perm=perm, inv_perm=inv,
                               source="requested", reordered_graph=g_r)


def lower(
    config,
    graph: CSRGraph,
    features: Optional[np.ndarray] = None,
    *,
    gamma: float = PAPER_GAMMA_DEFAULT,
    engine: "str | Backend | None" = None,
    use_fused: bool = True,
    fuse_epilogue: bool = True,
    fuse_attention: bool = True,
    br: Optional[int] = None,
    bc: Optional[int] = None,
    layout: "LayoutPlan | str | None" = None,
    device=None,
    validate: str = "fast",
) -> ModelPlan:
    """Lower a GNN spec onto backend primitives for full-batch execution:
    the synthesis step, as ``repro/core/lowering.py:lower``.

    ``features=None`` means the input matrix is unknown at lowering time;
    every layer then takes the dense path. ``use_fused=False`` keeps the
    plan but aggregates on the gather-scatter baseline and binds no sparse
    feature operand. ``fuse_epilogue=False`` keeps the fused aggregation
    but unbinds the per-layer epilogue (bias / self-term / activation as
    separate ops). ``fuse_attention=False`` keeps GAT / GT on the
    segment-softmax gather path; by default they bind the fused BSR
    attention kernels on ``cuda`` and their plain versions on ``torch``.
    ``layout`` takes ``None | "none" | "auto" | "degree" | "rcm"`` or a
    ``LayoutPlan``; ``"auto"`` runs the layout stage (order and a tile
    timed on ``device`` where that times the backend's kernels, else the
    cost model; cached on disk). A reordered plan carries
    ``perm``/``inv_perm`` and ``GNNModel.apply`` permutes features in and
    logits back. Operands are built on ``device``: CUDA unless asked.
    ``validate`` (``"off" | "fast" | "full"``) is the depth of the
    plan-contract check run on the finished plan against the exec graph
    (``core/verify.py``; full mode's value checks run on ``device``).
    """
    _resolve_mode(validate)
    backend = select_backend(engine)
    dev = resolve_device(device)
    kind = config.kind
    dims = list(config.layer_dims)
    agg = effective_aggregation(config)

    emit_epilogue = (use_fused and fuse_epilogue
                     and epilogue_fusable(config, agg))
    is_attn = is_attention_arch(kind)
    emit_attn = (use_fused and fuse_attention and is_attn
                 and backend.name in ("cuda", "torch"))
    # the autotuner measures at the width the aggregation runs: every arch
    # aggregates post-transform tensors of the hidden width
    agg_width = dims[1] if len(dims) > 1 else dims[0]
    lp = _resolve_layout(graph, agg_width, backend.name, emit_epilogue,
                         layout, br, bc, dev,
                         n_heads=config.gat_heads if is_attn else 0,
                         attention=emit_attn)
    if lp.permutes:
        graph_exec = (lp.reordered_graph if lp.reordered_graph is not None
                      else permute_graph(graph, lp.inv_perm))
        features_exec = (None if features is None
                         else np.asarray(features)[lp.perm])
    else:
        graph_exec = graph
        features_exec = None if features is None else np.asarray(features)
    n_nodes = graph_exec.n_rows

    graph_op = make_fused_aggregate(graph_exec, agg, br=lp.br, bc=lp.bc,
                                    engine=backend, device=dev,
                                    build_attention=emit_attn)
    # operands are built: drop the layout's host-side copy of the graph
    # (``graph_exec`` keeps it for the plan check)
    if lp.reordered_graph is not None:
        lp = dataclasses.replace(lp, reordered_graph=None)

    attn_bound = emit_attn and graph_op.aggregate_attention is not None
    if is_attn:
        agg_primitive = (f"{backend.name}.spmm_attention" if attn_bound
                         else f"{backend.name}.segment_softmax_aggregate")
    elif agg == "max":
        agg_primitive = "gather.segment_max"  # not a matmul on any backend
    elif not use_fused:
        agg_primitive = "gather.segment_sum_baseline"
    elif emit_epilogue:
        agg_primitive = f"{backend.name}.spmm_fused_epilogue"
    else:
        agg_primitive = f"{backend.name}.spmm_transposed_vjp"

    s_input = 0.0
    layers: list[LayerPlan] = []
    for i in range(config.n_layers):
        d_in, d_out = dims[i], dims[i + 1]
        if i == 0 and features is not None:
            decision = decide_execution_path(features, gamma=gamma,
                                             n_hidden=d_out)
            s_input = decision.sparsity
        else:
            s_est = (estimate_activation_sparsity(config.activation)
                     if i > 0 else 0.0)
            decision = decide_execution_path_from_stats(
                s_est, n_nodes, d_in, d_out, gamma=gamma)

        sparse_xw = None
        path, primitive, note = "dense", f"{backend.name}.feature_matmul_dense", ""
        if decision.mode == "sparse":
            expressible, expr_note = _sparse_expressible(kind)
            if i == 0 and features is not None and use_fused and expressible:
                # X's columns are features, not graph nodes: bc adapts to
                # the feature dim, the adjacency tile does not apply
                sparse_xw = backend.feature_matmul_sparse(
                    features_exec, br=lp.br, bc=None, device=dev)
                path = "sparse"
                primitive = f"{backend.name}.feature_matmul_sparse"
                note = expr_note
            elif not use_fused:
                note = "sparse profitable but fusion disabled (use_fused=False)"
            elif i > 0:
                note = ("sparse profitable but activations are runtime "
                        "values; no pre-built operand — dense fallback")
            elif features is None:
                note = "feature matrix unknown at lowering time"
            else:
                note = expr_note

        epilogue = None
        if emit_epilogue:
            epilogue = _epilogue_binding(
                config, is_last=(i == config.n_layers - 1),
                sparse_path=sparse_xw is not None)
        attention = None
        if is_attn:
            attention = _attention_binding(config.gat_heads, d_out,
                                           attn_bound)

        layers.append(LayerPlan(
            index=i, op_kind=kind, d_in=d_in, d_out=d_out,
            feature_path=path, primitive=primitive,
            agg_primitive=agg_primitive, decision=decision, note=note,
            epilogue=epilogue, attention=attention, layout=lp,
            sparse_xw=sparse_xw,
        ))

    plan = ModelPlan(
        layers=layers, backend=backend.name, gamma=gamma, arch=kind,
        aggregation=agg, feature_sparsity=s_input, graph_op=graph_op,
        layout=lp, device=dev,
    )
    check_plan(plan, mode=validate, graph=graph_exec)
    return plan
