"""Training loops — counterpart of ``repro/training/trainer.py``.

* ``FullBatchTrainer`` — single-device full-batch training (paper §V-C
  protocol: per-epoch forward + backward + optimizer) over a
  ``GNNModel``; ``train_step`` is the one step it and ``core/dsl.py``
  share. Checkpoints, guarded steps and fault injection wait for
  ROADMAP.md Queue 1, item 6.
* ``MiniBatchTrainer`` — the inference half of the neighbour-sampled
  trainer, as the serving path uses it: per batch, the sampler's bucketed
  block stack goes to the device and every layer runs
  ``models/gnn.py:apply_layer`` with ``LayerOps`` bound to the batch's
  bipartite operands — matmul aggregations through
  ``kernels/ops.py:bsr_spmm_pair`` (the Hopper kernel on the ``cuda``
  backend), the Alg-1 sparse input path through the gather backend's
  edge-list ``spmm``. Its training half is ROADMAP.md Queue 1, item 2;
  the distributed trainer is item 7.

PyTorch runs eagerly, so nothing is traced. ``n_infer_traces`` counts the
distinct shape signatures the infer path has seen — the JAX package's jit
retrace count — so the serving contract "at most one per bucket, none
after warmup" keeps its meaning.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.backends import compose_epilogue, get_backend
from repro_torch.backends.gather import EdgeListOperand
from repro_torch.backends.registry import (
    RUNTIME_ITEM,
    TRAINING_ITEM,
    not_ported,
)
from repro_torch.core.aggregate import gather_scatter_aggregate
from repro_torch.core.lowering import SampledModelPlan, lower_sampled
from repro_torch.core.sparsity import PAPER_GAMMA_DEFAULT
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.sampling import SampledBatch
from repro_torch.kernels import ops as kops
from repro_torch.models.gnn import (
    GNNConfig,
    GNNModel,
    LayerOps,
    apply_layer,
    init_params,
)
from repro_torch.training.optimizer import (
    Optimizer,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _signature(data: dict) -> tuple:
    return tuple((p, tuple(t.shape), t.dtype) for p, t in _leaves(data))


@dataclasses.dataclass
class TrainResult:
    losses: list
    epoch_times: list
    final_params: dict


def value_and_grad(loss_fn, params, *args):
    """(loss, grads): ``loss_fn(params, *args)`` and its gradient tree,
    shaped like ``params`` (zeros for a leaf the loss does not reach)."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def train_step(model: GNNModel, opt: Optimizer, params, opt_state, x,
               labels, mask):
    """One full-batch step: loss and gradients, then the optimizer update.
    Returns ``(params, opt_state, loss)`` with ``loss`` on the device: the
    step itself reads nothing back from the card."""
    loss, grads = value_and_grad(model.loss_fn, params, x, labels, mask)
    with torch.no_grad():
        params, opt_state = opt.update(grads, opt_state, params)
    return tree_map(torch.Tensor.detach, params), opt_state, loss


class FullBatchTrainer:
    """Single-device full-batch training over a ``GNNModel``.

    ``ckpt_dir``, ``guard`` and ``injector`` (checkpoints, the guarded
    step's resilience ladder, fault injection) are the runtime's and raise
    until it is ported.
    """

    def __init__(self, model: GNNModel, opt: Optimizer,
                 ckpt_dir: Optional[str] = None, guard=None, injector=None):
        for name, value in (("ckpt_dir", ckpt_dir), ("guard", guard),
                            ("injector", injector)):
            if value is not None:
                raise not_ported(f"FullBatchTrainer({name}=...)", RUNTIME_ITEM)
        self.model = model
        self.opt = opt

    def fit(self, params, x, labels, mask, epochs: int) -> TrainResult:
        """``epochs`` steps on the model's device; per epoch the loss and
        the wall time of the step, synchronised."""
        dev = self.model.device
        opt_state = self.opt.init(params)
        x, labels, mask = (torch.as_tensor(a, device=dev)
                           for a in (x, labels, mask))
        losses, times = [], []
        for _ in range(epochs):
            t0 = time.perf_counter()
            params, opt_state, loss = train_step(self.model, self.opt, params,
                                                 opt_state, x, labels, mask)
            losses.append(float(loss))  # synchronises with the card
            times.append(time.perf_counter() - t0)
        return TrainResult(losses=losses, epoch_times=times,
                           final_params=params)


class MiniBatchTrainer:
    """Neighbour-sampled inference over a ``SampledModelPlan``.

    ``device`` is where batches and params live: CUDA unless the caller
    passes another (``device="cpu"`` runs the plain PyTorch versions, as
    the tests do); with no card, CUDA raises. ``opt`` must be ``None`` and
    ``train_mask`` is not read: this slice ports inference only (the
    JAX package's constructor signature is kept for the training slice).
    """

    def __init__(
        self,
        config: GNNConfig,
        graph: Optional[CSRGraph],
        features: np.ndarray,
        labels: Optional[np.ndarray],
        train_mask: Optional[np.ndarray],
        opt=None,
        *,
        plan: Optional[SampledModelPlan] = None,
        fanouts=None,
        batch_size: int = 256,
        n_buckets: int = 2,
        engine: "str | None" = None,
        gamma: float = PAPER_GAMMA_DEFAULT,
        seed: int = 0,
        layout: "str | None" = None,
        infer_only: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        if opt is not None:
            raise not_ported("mini-batch training (an optimizer)",
                             TRAINING_ITEM)
        if plan is None:
            if graph is None or fanouts is None:
                raise ValueError("need either a plan or (graph, fanouts)")
            plan = lower_sampled(
                config, graph, features, fanouts=fanouts,
                batch_size=batch_size, n_buckets=n_buckets, gamma=gamma,
                engine=engine, seed=seed, layout=layout,
                infer_only=infer_only)
        self.config = config
        self.plan = plan
        self.sampler = plan.sampler
        self.backend = get_backend(plan.backend)
        # permutation contract (DESIGN.md §9): a reordered plan's sampler
        # walks the renumbered graph, so features/labels are held in
        # execution order and user node ids map through inv_perm
        lp = plan.layout
        self._inv_perm_np = (np.asarray(lp.inv_perm, dtype=np.int64)
                             if lp is not None and lp.permutes else None)
        self.features = np.asarray(features, dtype=np.float32)
        self.n_nodes = int(self.features.shape[0])
        self.labels_np = (np.zeros(self.n_nodes, dtype=np.int32)
                          if labels is None
                          else np.asarray(labels, dtype=np.int32))
        if self._inv_perm_np is not None:
            self.features = self.features[lp.perm]
            self.labels_np = self.labels_np[lp.perm]
        self.params = init_params(
            config, torch.Generator().manual_seed(seed), self.device)

        self._sparse0 = plan.layers[0].feature_path == "sparse"
        self._agg_mode = "bsr" if self.sampler.emit_bsr else "segment"
        self._inner = plan.backend if plan.backend in ("cuda", "torch") else "torch"

        self.n_infer_traces = 0
        self.n_feature_overflows = 0
        self._seen_signatures: set = set()

    def _to_exec(self, node_ids: np.ndarray) -> np.ndarray:
        """User node ids -> the reordered plan's execution ids (identity
        for unreordered plans); out-of-range ids raise ``ValueError``."""
        node_ids = np.asarray(node_ids, dtype=np.int64)
        bad = node_ids[(node_ids < 0) | (node_ids >= self.n_nodes)]
        if bad.size:
            raise ValueError(
                f"node ids out of range [0, {self.n_nodes}): "
                f"{bad[:8].tolist()}{'...' if bad.size > 8 else ''}")
        if self._inv_perm_np is None:
            return node_ids
        return self._inv_perm_np[node_ids]

    # -- per-batch LayerOps bindings ----------------------------------------

    def _make_agg(self, blk: dict, n_out: int):
        if self._agg_mode == "bsr":
            fwd = (blk["fwd"]["rows"], blk["fwd"]["cols"],
                   blk["fwd"]["first"], blk["fwd"]["blocks"])
            inner = self._inner

            def agg(u):
                # any feature width: the kernel masks the ragged edge, so
                # u is not padded to a lane tile; no transposed operand,
                # since the serving path takes no gradient
                return kops.bsr_spmm_pair(fwd, None, u.contiguous(), n_out,
                                          inner)

            return agg
        src, dst, w = blk["edge_src"], blk["edge_dst"], blk["edge_w"]

        def agg(u):
            return gather_scatter_aggregate(src, dst, w, u, n_out, "sum")

        return agg

    def _make_xw(self, data: dict):
        # the plan's "gather.feature_matmul_sparse": the per-batch COO is
        # the gather backend's edge-list operand with W as the gathered
        # matrix
        rows, cols, vals = data["feat"]
        operand = EdgeListOperand(src=cols, dst=rows, weights=vals,
                                  n_rows=data["valid"][0].shape[0])
        gather = get_backend("gather")

        def xw(w):
            return gather.spmm(operand, w)

        return xw

    def _logits(self, params, data, collect=False):
        config = self.config
        n = config.n_layers
        x = data["x"]
        levels = []
        for i in range(n):
            blk = data["blocks"][i]
            n_out = data["valid"][i + 1].shape[0]
            agg = self._make_agg(blk, n_out)
            fe = (compose_epilogue(agg)
                  if self.plan.layers[i].epilogue is not None else None)
            ops = LayerOps(
                aggregate=agg,
                xw=(self._make_xw(data) if i == 0 and "feat" in data else None),
                restrict=lambda u, _n=n_out: u[:_n],
                fused_epilogue=fe,
            )
            x = apply_layer(config, params["layers"][i], x, ops,
                            is_last=(i == n - 1))
            # re-zero padded rows: keeps dump-row garbage out of the next
            # layer's operands
            x = torch.where(data["valid"][i + 1][:, None], x, 0.0)
            if collect:
                levels.append(x)
        if collect:
            # levels[l] rows are the level-(l+1) frontier; levels[-1] is
            # the logits — the serving engine's historical-embedding feed
            return tuple(levels)
        return x  # [node_caps[L], n_classes], padded rows zero

    def _count_signature(self, kind: str, data: dict) -> None:
        sig = (kind, _signature(data))
        if sig not in self._seen_signatures:
            self._seen_signatures.add(sig)
            self.n_infer_traces += 1

    def _infer(self, params, data):
        self._count_signature("logits", data)
        with torch.no_grad():
            return self._logits(params, data)

    def _infer_levels(self, params, data):
        self._count_signature("levels", data)
        with torch.no_grad():
            return self._logits(params, data, collect=True)

    # -- host-side batch marshalling ----------------------------------------

    def _batch_arrays(self, batch: SampledBatch) -> dict:
        dev = self.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        blocks = []
        for blk in batch.blocks:
            if self._agg_mode == "bsr":
                # forward operand only: inference takes no gradient, so
                # the transposed operand never leaves the host
                d = {"fwd": {k: t(v) for k, v in blk.fwd_bsr.items()}}
            else:
                d = {"edge_src": t(blk.edge_src), "edge_dst": t(blk.edge_dst),
                     "edge_w": t(blk.edge_w)}
            blocks.append(d)
        data = {
            "x": t(batch.x),
            "valid": tuple(t(v) for v in batch.valid),
            "blocks": tuple(blocks),
        }
        if self._sparse0:
            if batch.feat_coo is not None:
                data["feat"] = tuple(t(a) for a in batch.feat_coo)
            else:  # denser than the template's cap: dense-path fallback
                self.n_feature_overflows += 1
        return data

    # -- inference ----------------------------------------------------------

    def infer_logits(self, node_ids: np.ndarray) -> np.ndarray:
        """Sampled-neighbourhood logits for arbitrary nodes (user ids);
        row i is the logits of ``node_ids[i]``, in request order. Any size
        (chunked through ``split_request``), unsorted, duplicates allowed
        (deduplicated before sampling, scattered back)."""
        node_ids = np.asarray(node_ids, dtype=np.int64).reshape(-1)
        exec_ids = self._to_exec(node_ids)
        uniq, inv = np.unique(exec_ids, return_inverse=True)
        rows = np.zeros((uniq.shape[0], self.config.layer_dims[-1]),
                        np.float32)
        off = 0
        for chunk in self.sampler.split_request(uniq):
            batch = self.sampler.sample_batch(chunk, self.features)
            logits = self._infer(self.params, self._batch_arrays(batch))
            rows[off: off + chunk.shape[0]] = (
                logits[: chunk.shape[0]].cpu().numpy())
            off += chunk.shape[0]
        return rows[inv]

    def evaluate(self, mask: np.ndarray) -> float:
        """Accuracy on the masked nodes (mask in user node order); an
        all-``False`` mask returns 0.0."""
        ids = np.flatnonzero(np.asarray(mask))
        if ids.shape[0] == 0:
            return 0.0
        pred = np.argmax(self.infer_logits(ids), axis=-1)
        return float(np.mean(pred == self.labels_np[self._to_exec(ids)]))
