"""GNN layers and the full-batch model — GCN, GraphSAGE, GIN, GAT and the
GT graph-transformer layer (paper §III-A).

Counterpart of ``repro/models/gnn.py``. Parameters are a plain dictionary
``{"layers": [dict of tensors, ...]}`` with the JAX package's names and
layouts, so ``params_from_jax`` carries the JAX package's weights over
unchanged (``jax.random`` and ``torch.Generator`` never draw the same
numbers, so parity tests load one set of weights into both).
``apply_layer`` is the single definition of each arch's per-layer algebra,
bound to execution primitives through ``LayerOps``; ``GNNModel`` executes
a full-batch ``ModelPlan`` with it. Parameters are made on the card unless
the caller asks for another device.

Attention archs (GAT, GT) run the fused BSR attention primitive
``spmm_attention`` where the plan bound it (``cuda`` and ``torch``), and
the ``segment_softmax_aggregate`` gather path under
``fuse_attention=False`` or on the ``gather`` backend.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Literal, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.backends import get_backend
from repro_torch.core.lowering import LayerPlan, ModelPlan, lower
from repro_torch.graph.csr import CSRGraph

GNNKind = Literal["GCN", "SAGE", "GIN", "GAT", "GT"]


@dataclasses.dataclass
class GNNConfig:
    kind: GNNKind
    layer_dims: Sequence[int]  # [in, hidden..., out]
    aggregation: str = "gcn"  # sum | mean | gcn | max
    activation: Callable = torch.relu
    gat_heads: int = 4

    @property
    def n_layers(self) -> int:
        return len(self.layer_dims) - 1


def _xavier(shape, generator: torch.Generator) -> torch.Tensor:
    scale = math.sqrt(2.0 / (shape[0] + shape[-1]))
    return torch.randn(shape, generator=generator, dtype=torch.float32) * scale


def init_params(config: GNNConfig, generator: torch.Generator,
                device=None) -> dict:
    """Xavier-normal parameters of any arch with the JAX package's names and
    shapes, drawn on the CPU from ``generator`` and moved to ``device``
    (CUDA unless asked; raises without a card). GAT / GT layers hold
    ``w [d_in, H*Dh]``, ``a_src``/``a_dst [H, Dh]``, ``b [d_out]`` and
    ``proj [H*Dh, d_out]`` with ``Dh = d_out // H``; GT adds the residual
    ``w_res [d_in, d_out]``."""
    device = resolve_device(device)
    layers = []
    for i in range(config.n_layers):
        d_in, d_out = config.layer_dims[i], config.layer_dims[i + 1]
        if config.kind == "GCN":
            layer = {"w": _xavier((d_in, d_out), generator),
                     "b": torch.zeros(d_out)}
        elif config.kind == "SAGE":
            layer = {"w_self": _xavier((d_in, d_out), generator),
                     "w_neigh": _xavier((d_in, d_out), generator),
                     "b": torch.zeros(d_out)}
        elif config.kind == "GIN":
            layer = {"eps": torch.zeros(()),
                     "w1": _xavier((d_in, d_out), generator),
                     "b1": torch.zeros(d_out),
                     "w2": _xavier((d_out, d_out), generator),
                     "b2": torch.zeros(d_out)}
        elif config.kind in ("GAT", "GT"):
            h = config.gat_heads
            dh = max(d_out // h, 1)
            layer = {"w": _xavier((d_in, h * dh), generator),
                     "a_src": _xavier((h, dh), generator),
                     "a_dst": _xavier((h, dh), generator),
                     "b": torch.zeros(d_out),
                     "proj": _xavier((h * dh, d_out), generator)}
            if config.kind == "GT":
                # graph-transformer residual branch (pre-attention input)
                layer["w_res"] = _xavier((d_in, d_out), generator)
        else:
            raise ValueError(config.kind)
        layers.append({k: v.to(device) for k, v in layer.items()})
    return {"layers": layers}


def params_from_jax(tree: dict, device=None) -> dict:
    """The port's params from the JAX package's params pytree, given as
    numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``): same
    names, same layouts, float32, on ``device`` (CUDA unless asked)."""
    device = resolve_device(device)
    return {"layers": [
        {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
         for k, v in layer.items()}
        for layer in tree["layers"]]}


@dataclasses.dataclass
class LayerOps:
    """The execution primitives one layer's algebra runs on."""

    aggregate: Callable[[torch.Tensor], torch.Tensor]  # u -> A @ u
    # layer-0 Alg-1 sparse binding: w -> X @ w; None = dense path (x @ w)
    xw: Optional[Callable] = None
    # edge softmax: (z [N, heads*dh], a_src, a_dst, heads) -> [N, heads, dh]
    gat_attention: Optional[Callable] = None
    # bipartite mini-batch blocks: maps a src-frontier tensor onto the dst
    # frontier (a leading-row slice). None = src set == dst set.
    restrict: Optional[Callable] = None
    # (u, self_term=None, bias=None, alpha=None, activation="none") ->
    # act(A·u + alpha·self_term + bias); bound iff the layer's plan carries
    # an ``EpiloguePlan``
    fused_epilogue: Optional[Callable] = None


def apply_layer(config: GNNConfig, layer: dict, x: torch.Tensor,
                ops: LayerOps, is_last: bool) -> torch.Tensor:
    """One layer of any ported arch, on the given primitives — the same
    algebra, in the same order, as ``repro/models/gnn.py:apply_layer``.

    With ``ops.fused_epilogue`` bound, bias / self-term / ReLU run inside
    the aggregation primitive: GCN ``relu(A·(X·W) + b)``; SAGE
    ``relu(A·(X·Wn) + X·Ws + b)``; GIN sparse ``act(A·u + (1+eps)·u + b1)``,
    dense ``A·x + (1+eps)·x``. Only the port's own ``torch.relu`` lowers
    into the primitive (``core/lowering.py:_epilogue_binding`` keys on the
    same test). GAT / GT: ``attention(X·W)·proj + b`` (GT ``+ X·W_res``),
    then the activation.
    """
    kind = config.kind
    xw = ops.xw
    mm = xw if xw is not None else (lambda w: x @ w)
    res = ops.restrict if ops.restrict is not None else (lambda u: u)
    fe = ops.fused_epilogue
    relu_ok = config.activation is torch.relu
    post = "relu" if (relu_ok and not is_last) else "none"
    if kind == "GCN":
        # transform-then-aggregate (standard GCN ordering A (X W))
        if fe is not None:
            y = fe(mm(layer["w"]), bias=layer["b"], activation=post)
            return y if (is_last or post == "relu") else config.activation(y)
        y = ops.aggregate(mm(layer["w"])) + layer["b"]
    elif kind == "SAGE":
        if fe is not None:
            y = fe(mm(layer["w_neigh"]), self_term=res(mm(layer["w_self"])),
                   bias=layer["b"], activation=post)
            return y if (is_last or post == "relu") else config.activation(y)
        y = res(mm(layer["w_self"])) + ops.aggregate(x) @ layer["w_neigh"] + layer["b"]
    elif kind == "GIN":
        if xw is not None:
            # "sum" aggregation is linear, so z@W1 re-associates to
            # (1+eps)(X@W1) + A(X@W1)
            u = xw(layer["w1"])
            if fe is not None:
                act = "relu" if relu_ok else "none"
                h = fe(u, self_term=res(u), bias=layer["b1"],
                       alpha=1.0 + layer["eps"], activation=act)
                if act == "none":
                    h = config.activation(h)
            else:
                z1 = (1.0 + layer["eps"]) * res(u) + ops.aggregate(u) + layer["b1"]
                h = config.activation(z1)
            y = h @ layer["w2"] + layer["b2"]
        else:
            if fe is not None:
                z = fe(x, self_term=res(x), alpha=1.0 + layer["eps"])
            else:
                z = (1.0 + layer["eps"]) * res(x) + ops.aggregate(x)
            z1 = z @ layer["w1"] + layer["b1"]
            y = config.activation(z1) @ layer["w2"] + layer["b2"]
    elif kind in ("GAT", "GT"):
        z = mm(layer["w"])  # [N, heads*dh]
        out = ops.gat_attention(z, layer["a_src"], layer["a_dst"],
                                config.gat_heads)  # [N, heads, dh]
        y = out.reshape(out.shape[0], -1) @ layer["proj"] + layer["b"]
        if kind == "GT":
            # transformer-style residual around the attention block
            y = y + res(x) @ layer["w_res"]
    else:
        raise ValueError(kind)
    return y if is_last else config.activation(y)


class GNNModel:
    """A GNN executing a full-batch ``ModelPlan`` — counterpart of
    ``repro/models/gnn.py:GNNModel``.

    Each layer runs ``apply_layer`` on the plan's primitives: the sparse
    layer-0 X·W when the plan bound one, the fused-epilogue aggregation
    where the plan carries an ``EpiloguePlan``, the fused attention where
    the plan bound ``spmm_attention`` (else the segment path), the
    gather-scatter baseline under ``use_fused=False``. A reordered plan's operands live
    in the renumbered space: ``apply`` gathers features in through
    ``perm`` and un-permutes logits through ``inv_perm``, so callers only
    see the original node order.
    """

    def __init__(self, config: GNNConfig, graph: CSRGraph,
                 use_fused: bool = True, engine: "str | None" = None,
                 plan: Optional[ModelPlan] = None, device=None):
        self.config = config
        self.graph = graph
        self.use_fused = use_fused
        if plan is None:
            plan = lower(config, graph, None, engine=engine,
                         use_fused=use_fused, device=device)
        self.plan = plan
        self.device = plan.device
        self.backend = get_backend(plan.backend)
        self.op = plan.graph_op
        lp = plan.layout
        if lp is not None and lp.permutes:
            self._perm = torch.from_numpy(np.asarray(lp.perm, np.int64)).to(self.device)
            self._inv_perm = torch.from_numpy(
                np.asarray(lp.inv_perm, np.int64)).to(self.device)
        else:
            self._perm = self._inv_perm = None
        # fused BSR attention: bound iff the plan's aggregation primitive is
        # spmm_attention and the graph op carries the operator
        self._fuse_attention = (
            use_fused and self.op.aggregate_attention is not None
            and any(l.agg_primitive.endswith("spmm_attention")
                    for l in plan.layers))

    def init(self, generator: torch.Generator) -> dict:
        return init_params(self.config, generator, self.device)

    def _aggregate(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_fused:
            return self.op.aggregate(x)
        return self.op.baseline(x)

    def _gat_attention(self, z: torch.Tensor, a_src, a_dst,
                       heads: int) -> torch.Tensor:
        """Edge-softmax attention: the fused operator where the plan bound
        one, else the backend's segment primitive."""
        if self._fuse_attention:
            return self.op.aggregate_attention(z, a_src, a_dst, heads)
        n = z.shape[0]
        z3 = z.reshape(n, heads, z.shape[-1] // heads)
        return self.backend.segment_softmax_aggregate(
            z3, a_src, a_dst, self.op.src, self.op.dst, n)

    def _layer_ops(self, plan_layer: Optional[LayerPlan]) -> LayerOps:
        sparse_xw = None
        if plan_layer is not None and plan_layer.feature_path == "sparse":
            sparse_xw = plan_layer.sparse_xw
        fe = None
        if (self.use_fused and plan_layer is not None
                and plan_layer.epilogue is not None):
            fe = self.op.aggregate_epilogue
        return LayerOps(aggregate=self._aggregate, xw=sparse_xw,
                        gat_attention=self._gat_attention, fused_epilogue=fe)

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        n = self.config.n_layers
        if self._perm is not None:
            x = x[self._perm]
        for i, layer in enumerate(params["layers"]):
            plan_layer = self.plan.layers[i] if i < len(self.plan.layers) else None
            x = apply_layer(self.config, layer, x, self._layer_ops(plan_layer),
                            is_last=(i == n - 1))
        if self._inv_perm is not None:
            x = x[self._inv_perm]
        return x

    def loss_fn(self, params: dict, x: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy over the masked nodes (0 when none are)."""
        logp = torch.log_softmax(self.apply(params, x), dim=-1)
        nll = -logp.gather(1, labels.long()[:, None])[:, 0]
        denom = mask.sum().clamp(min=1)
        return torch.where(mask, nll, 0.0).sum() / denom

    def accuracy(self, params: dict, x, labels, mask) -> torch.Tensor:
        with torch.no_grad():
            pred = torch.argmax(self.apply(params, x), dim=-1)
        denom = mask.sum().clamp(min=1)
        return torch.where(mask, pred == labels.long(), False).sum() / denom
