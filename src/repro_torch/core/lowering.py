"""The lowering pass: GNN spec -> per-layer plans (DESIGN.md §3, §7).

Counterpart of ``repro/core/lowering.py``'s ``lower`` (full batch: a
``ModelPlan``) and ``lower_sampled`` (mini-batch: a ``SampledModelPlan``).
A spec becomes per-layer ``LayerPlan`` records naming the feature path,
the backend primitives and the epilogue binding, with the same
Algorithm-1 decisions as the JAX package (measured input sparsity for
layer 0, post-activation estimates for hidden layers). ``describe()``
prints the same plan dump, with the port's backend names (``cuda`` for
``pallas``, ``torch`` for ``xla``).

Full batch runs every arch (GCN, SAGE mean/sum/gcn/max, GIN, GAT, GT);
attention archs bind the fused ``spmm_attention`` on ``cuda``/``torch``
(an ``AttentionPlan`` per layer). The sampled path runs the matmul
aggregations; attention and ``max`` there wait for ROADMAP.md Queue 1,
item 11. ``layout="auto"`` waits for item 5; the distributed lowering for
item 7; the plan-contract verifier (``check_plan``) for item 8, and a
full-batch plan's ``describe()`` says so.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.backends import Backend, select_backend
from repro_torch.backends.registry import (
    LAYOUT_ITEM,
    SAMPLED_ATTENTION_ITEM,
    VERIFY_ITEM,
    not_ported,
)
from repro_torch.core.aggregate import (
    FusedGraphOp,
    _weighted_graph,
    make_fused_aggregate,
)
from repro_torch.core.layout import LayoutPlan, _select_order, default_layout
from repro_torch.core.sparsity import (
    PAPER_GAMMA_DEFAULT,
    SparsityDecision,
    decide_execution_path,
    decide_execution_path_from_stats,
    estimate_activation_sparsity,
)
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
        return "\n".join([head] + ["  " + l.describe() for l in self.layers]
                         + [f"  (check_plan not ported: {VERIFY_ITEM})"])


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
    layout: "LayoutPlan | str | None" = None,
    infer_only: bool = False,
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
    """
    backend = select_backend(engine)
    kind = config.kind
    if is_attention_arch(kind):
        raise not_ported(f"{kind} (attention aggregation) on the sampled path",
                         SAMPLED_ATTENTION_ITEM)
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
    agg = effective_aggregation(config)
    if agg == "max":
        raise not_ported("max aggregation on the sampled path",
                         SAMPLED_ATTENTION_ITEM)

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

    weighted = _weighted_graph(graph, agg)
    emit_bsr = backend.name in ("cuda", "torch")
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
    if emit_epilogue:
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

        layers.append(LayerPlan(
            index=i, op_kind=kind, d_in=d_in, d_out=d_out,
            feature_path=path, primitive=primitive,
            agg_primitive=agg_primitive, decision=decision, note=note,
            epilogue=epilogue, layout=lp,
        ))

    return SampledModelPlan(
        layers=layers, backend=backend.name, gamma=gamma, arch=kind,
        aggregation=agg, feature_sparsity=float(s_frontier), fanouts=fanouts,
        batch_size=int(batch_size), n_buckets=int(n_buckets), sampler=sampler,
        layout=lp, infer_only=bool(infer_only),
    )


def effective_aggregation(config) -> str:
    """The aggregation the spec lowers to: GCN always uses symmetric
    normalisation, GIN's sum is fixed by the arch, everything else takes
    ``config.aggregation``."""
    if config.kind == "GCN":
        return "gcn"
    if config.kind == "GIN":
        return "sum"
    return config.aggregation


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


def _resolve_layout(graph: CSRGraph, layout: "LayoutPlan | str | None",
                    br: Optional[int], bc: Optional[int]) -> LayoutPlan:
    """Turn a ``layout=`` argument into a concrete ``LayoutPlan``.

    * ``None`` / ``"none"`` — identity order, explicit ``br``/``bc`` when
      given, the adaptive ``bc`` otherwise;
    * ``"degree"`` / ``"rcm"`` — that order with the same tile;
    * a ``LayoutPlan`` — passes through untouched;
    * ``"auto"`` (order selection + tile autotuning) is not ported.

    Explicit ``br``/``bc`` with a ``LayoutPlan`` is a conflict (the layout
    carries the tile) and raises.
    """
    if layout == "auto":
        raise not_ported("layout='auto' (the tile autotuner)", LAYOUT_ITEM)
    if isinstance(layout, LayoutPlan):
        if br is not None or bc is not None:
            raise ValueError(
                f"explicit br/bc conflict with layout={layout!r}: the "
                f"layout carries the tile — pass one or the other")
        return layout
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
    ``layout`` takes ``None | "none" | "degree" | "rcm"`` or a
    ``LayoutPlan``; a reordered plan carries ``perm``/``inv_perm`` and
    ``GNNModel.apply`` permutes features in and logits back. Operands are
    built on ``device``: CUDA unless asked.
    """
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
    lp = _resolve_layout(graph, layout, br, bc)
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

    return ModelPlan(
        layers=layers, backend=backend.name, gamma=gamma, arch=kind,
        aggregation=agg, feature_sparsity=s_input, graph_op=graph_op,
        layout=lp, device=dev,
    )
