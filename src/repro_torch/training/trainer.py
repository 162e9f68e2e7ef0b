"""Training loops — counterpart of ``repro/training/trainer.py``.

* ``FullBatchTrainer`` — single-device full-batch training (paper §V-C
  protocol: per-epoch forward + backward + optimizer) over a
  ``GNNModel``; ``train_step`` is the one step it and ``core/dsl.py``
  share, with checkpoints, the guarded step and fault injection
  (``runtime/``).
* ``MiniBatchTrainer`` — neighbour-sampled mini-batch training and
  inference (DESIGN.md §7): per batch, the sampler's bucketed block stack
  goes to the device and every layer runs ``models/gnn.py:apply_layer``
  with ``LayerOps`` bound to the batch's bipartite operands — matmul
  aggregations through ``kernels/ops.py:bsr_spmm_pair``, fused attention
  through ``kernels/ops.py:sampled_mha_pair`` (the Hopper kernels on the
  ``cuda`` backend), ``max`` and segment attention over the padded edge
  lists, the Alg-1 sparse input path through the gather backend's
  edge-list ``spmm``; the loss on the batch's seeds, one optimizer step
  per batch, under the same runtime: checkpoints that carry the shuffle
  and sampler RNG states, so a resume replays the exact batch sequence.
* ``DistributedGNNTrainer`` — node-sharded full-batch training over the
  ranks of a ``torch.distributed`` group (the paper's MPI backend), one
  instance in each rank process (``launch/mesh.py:run_ranks``), over the
  plan of ``core/lowering.py:lower_distributed``.

PyTorch runs eagerly, so nothing is traced. ``n_traces`` and
``n_infer_traces`` count the distinct shape signatures the training step
and the infer path have seen — the JAX package's jit retrace counts — so
the contract "at most one per bucket and input-path variant, none after
warmup" keeps its meaning.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.backends import compose_epilogue, get_backend
from repro_torch.backends.distributed import DistributedBackend
from repro_torch.backends.gather import EdgeListOperand
from repro_torch.core.aggregate import gather_scatter_aggregate
from repro_torch.core.halo import (
    DistributedGraph,
    GhostBufferRing,
    HaloSchedule,
    halo_exchange,
)
from repro_torch.core.lowering import (
    DistributedModelPlan,
    SampledModelPlan,
    lower_distributed,
    lower_sampled,
)
from repro_torch.core.pipeline import arch_layer_fns, pipelined_value_and_grad
from repro_torch.core.sparsity import PAPER_GAMMA_DEFAULT
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.sampling import SampledBatch
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import BSRDevice
from repro_torch.models.gnn import (
    GNNConfig,
    GNNModel,
    LayerOps,
    apply_layer,
    init_params,
)
from repro_torch.runtime.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.runtime.resilience import (
    FaultInjector,
    GuardPolicy,
    GuardRunner,
    guarded_update,
    pack_rng_state,
    unpack_rng_state,
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
    restored_from: Optional[int] = None
    guard: Optional[dict] = None  # GuardRunner.stats() when guarded


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


def guarded_train_step(loss_fn, opt: Optimizer, params, opt_state, *args,
                       scale: float = 1.0, poison: float = 0.0):
    """One step of ``loss_fn(params, *args)`` under the guard: the injected
    ``poison`` (the ``grad`` fault's NaN or inf; nothing on a clean step)
    added to every gradient leaf, and the candidate step committed only if
    its params and loss are finite (``runtime.resilience.guarded_update``).
    Returns ``(params, opt_state, loss, ok)``. The optimizer works out of
    place, so the old tree is kept without a copy."""
    loss, grads = value_and_grad(loss_fn, params, *args)
    if poison != 0.0:
        grads = tree_map(lambda g: g + poison, grads)
    with torch.no_grad():
        p_new, s_new = opt.update(grads, opt_state, params)
        return guarded_update(params, opt_state, p_new, s_new, loss, scale)


class FullBatchTrainer:
    """Single-device full-batch training over a ``GNNModel``, optionally
    under a guarded step.

    ``guard`` (a ``runtime.resilience.GuardPolicy``) arms the resilience
    ladder (DESIGN.md §13): each step's candidate params and loss pass one
    non-finite count on the device and commit only when finite;
    consecutive bad steps escalate skip → LR backoff → rollback to the
    last checkpoint. ``injector`` is the deterministic fault source: its
    ``grad`` site adds NaN/inf to every gradient leaf on fired steps.
    ``ckpt_dir`` restores the latest checkpoint at the start of ``fit``
    and saves ``(params, opt_state)`` every ``ckpt_every`` epochs, in the
    JAX package's format.
    """

    def __init__(self, model: GNNModel, opt: Optimizer,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
                 guard: Optional[GuardPolicy] = None,
                 injector: Optional[FaultInjector] = None):
        self.model = model
        self.opt = opt
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.injector = injector
        self.guard = GuardRunner(guard) if guard is not None else None

    def fit(self, params, x, labels, mask, epochs: int,
            start_epoch: int = 0) -> TrainResult:
        """Epochs ``start_epoch`` (or the restored checkpoint's step) to
        ``epochs`` on the model's device; per epoch the loss and the wall
        time of the step, synchronised."""
        dev = self.model.device
        opt_state = self.opt.init(params)
        restored = None
        if self.ckpt_dir:
            (params, opt_state), restored = restore_checkpoint(
                self.ckpt_dir, (params, opt_state))
            if restored is not None:
                start_epoch = restored
        x, labels, mask = (torch.as_tensor(a, device=dev)
                           for a in (x, labels, mask))
        losses, times = [], []
        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            if self.guard is None:
                params, opt_state, loss = train_step(
                    self.model, self.opt, params, opt_state, x, labels, mask)
            else:
                poison = (self.injector.grad_poison(epoch)
                          if self.injector is not None else 0.0)
                params, opt_state, loss, ok = guarded_train_step(
                    self.model.loss_fn, self.opt, params, opt_state, x,
                    labels, mask, scale=self.guard.scale, poison=poison)
                action = self.guard.after_step(bool(ok), step=epoch)
                if action == "rollback" and self.ckpt_dir:
                    (params, opt_state), _ = restore_checkpoint(
                        self.ckpt_dir, (params, opt_state))
            losses.append(float(loss))  # synchronises with the card
            times.append(time.perf_counter() - t0)
            if self.ckpt_dir and (epoch + 1) % self.ckpt_every == 0:
                save_checkpoint(self.ckpt_dir, epoch + 1, (params, opt_state),
                                injector=self.injector)
        return TrainResult(losses=losses, epoch_times=times,
                           final_params=params, restored_from=restored,
                           guard=self.guard.stats() if self.guard else None)


class MiniBatchTrainer:
    """Neighbour-sampled mini-batch training over a ``SampledModelPlan``.

    Per epoch: reshuffle the train seeds, batch them, sample the L-layer
    block stack per batch (``graph/sampling.py``), and run one optimizer
    step per batch with the loss on the batch's seeds only. The RNGs are
    drawn in the JAX package's order (the shuffle stream ``seed + 1``
    samples the epoch's batches too), so both trainers see the same
    batches. Without ``opt`` (or with an ``infer_only`` plan) the trainer
    only infers. ``device`` is where batches and params live: CUDA unless
    the caller passes another (``device="cpu"`` runs the plain PyTorch
    versions, as the tests do); with no card, CUDA raises. ``guard`` and
    ``injector`` arm the guarded step as in ``FullBatchTrainer`` (a
    rollback restores the last checkpoint, RNG streams included);
    ``ckpt_dir`` checkpoints every ``ckpt_every`` epochs and ``fit``
    resumes from the latest one.
    """

    def __init__(
        self,
        config: GNNConfig,
        graph: Optional[CSRGraph],
        features: np.ndarray,
        labels: Optional[np.ndarray],
        train_mask: Optional[np.ndarray],
        opt: Optional[Optimizer] = None,
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
        guard: Optional[GuardPolicy] = None,
        injector: Optional[FaultInjector] = None,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 5,
        device=None,
    ):
        self.device = resolve_device(device)
        if plan is None:
            if graph is None or fanouts is None:
                raise ValueError("need either a plan or (graph, fanouts)")
            plan = lower_sampled(
                config, graph, features, fanouts=fanouts,
                batch_size=batch_size, n_buckets=n_buckets, gamma=gamma,
                engine=engine, seed=seed, layout=layout,
                infer_only=infer_only, device=self.device)
        self.config = config
        self.plan = plan
        self.sampler = plan.sampler
        self.backend = get_backend(plan.backend)
        self.opt = opt
        # permutation contract (DESIGN.md §9): a reordered plan's sampler
        # walks the renumbered graph, so features/labels are held in
        # execution order and user node ids map through inv_perm
        lp = plan.layout
        self._inv_perm_np = (np.asarray(lp.inv_perm, dtype=np.int64)
                             if lp is not None and lp.permutes else None)
        self.features = np.asarray(features, dtype=np.float32)
        self.n_nodes = int(self.features.shape[0])
        self.infer_only = bool(plan.infer_only or opt is None)
        self.labels_np = (np.zeros(self.n_nodes, dtype=np.int32)
                          if labels is None
                          else np.asarray(labels, dtype=np.int32))
        if self._inv_perm_np is not None:
            self.features = self.features[lp.perm]
            self.labels_np = self.labels_np[lp.perm]
        self.train_ids = (np.zeros(0, dtype=np.int64) if train_mask is None
                          else self._to_exec(
                              np.flatnonzero(np.asarray(train_mask))))
        self.params = init_params(
            config, torch.Generator().manual_seed(seed), self.device)
        self.opt_state = opt.init(self.params) if opt is not None else None
        self._shuffle_rng = np.random.default_rng(seed + 1)
        # resilience (DESIGN.md §13): guarded steps, and checkpoints that
        # capture the sampler and shuffle RNG states, so a resume replays
        # the exact batch sequence a straight run would have drawn
        self.injector = injector
        self.guard = (GuardRunner(guard, restore_fn=self.restore)
                      if guard is not None else None)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self._epoch_idx = 0
        self._global_step = 0

        self._sparse0 = plan.layers[0].feature_path == "sparse"
        self._is_gat = config.kind in ("GAT", "GT")
        self._is_max = plan.aggregation == "max"
        # fused attention: the plan bound spmm_attention and the sampler
        # emits the per-batch BSR pair to run it on
        self._fuse_attention = (self.sampler.emit_bsr and any(
            l.agg_primitive.endswith("spmm_attention") for l in plan.layers))
        self._agg_mode = ("bsr" if self.sampler.emit_bsr
                          else "max" if self._is_max else "segment")
        self._inner = plan.backend if plan.backend in ("cuda", "torch") else "torch"

        self.n_traces = 0
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

    @staticmethod
    def _pair(blk: dict) -> tuple:
        """The batch layer's (A, Aᵀ) arrays, each (rows, cols, first,
        blocks); Aᵀ is ``None`` where only the forward was copied."""
        return tuple(None if d is None else
                     (d["rows"], d["cols"], d["first"], d["blocks"])
                     for d in (blk["fwd"], blk.get("bwd")))

    def _make_agg(self, blk: dict, n_out: int, valid_out: torch.Tensor):
        mode, inner = self._agg_mode, self._inner
        if mode == "bsr":
            fwd, bwd = self._pair(blk)

            def agg(u):
                # any feature width: the kernel masks the ragged edge, so
                # u is not padded to a lane tile
                return kops.bsr_spmm_pair(fwd, bwd, u.contiguous(), n_out,
                                          inner)

            return agg
        src, dst, w = blk["edge_src"], blk["edge_dst"], blk["edge_w"]
        if mode == "max":

            def agg(u):
                # padded rows hold no edge (-inf) or the dump row's: zeroed
                # here, not only after the layer, since -inf rows times W
                # would make dW NaN (-inf * 0)
                y = gather_scatter_aggregate(src, dst, w, u, n_out, "max")
                return torch.where(valid_out[:, None], y, 0.0)

            return agg

        def agg(u):
            return gather_scatter_aggregate(src, dst, w, u, n_out, "sum")

        return agg

    def _make_gat(self, blk: dict, n_out: int):
        if self._fuse_attention:
            # fused attention over the batch's padded bipartite BSR pair
            fwd, bwd = self._pair(blk)
            inner = self._inner

            def gat_attention(z, a_src, a_dst, heads):
                z3 = z.reshape(z.shape[0], heads, -1)
                return kops.sampled_mha_pair(fwd, bwd, z3, a_src, a_dst,
                                             n_out, inner)

            return gat_attention
        backend = self.backend
        src, dst = blk["edge_src"], blk["edge_dst"]

        def gat_attention(z, a_src, a_dst, heads):
            z3 = z.reshape(z.shape[0], heads, -1)
            return backend.segment_softmax_aggregate(z3, a_src, a_dst, src,
                                                     dst, n_out)

        return gat_attention

    def _make_xw(self, data: dict):
        # the plan's "gather.feature_matmul_sparse": the per-batch COO is
        # the gather backend's edge-list operand with W as the gathered
        # matrix. dW = Xᵀ·dY runs on the same list with source and
        # destination swapped (an index_add_ as the forward's): autograd's
        # own VJP of the gather W[cols] sorts and walks each column's
        # entries serially, and the COO's padding (13.8M of a corafull
        # 1,024-seed batch's 17.2M entries) all sits at (0, 0)
        rows, cols, vals = data["feat"]
        operand = EdgeListOperand(src=cols, dst=rows, weights=vals,
                                  n_rows=data["valid"][0].shape[0])
        gather = get_backend("gather")

        def xw(w):
            transposed = EdgeListOperand(src=rows, dst=cols, weights=vals,
                                         n_rows=w.shape[0])
            return gather.spmm_transposed_vjp(operand, transposed)(w)

        return xw

    def _logits(self, params, data, collect=False):
        config = self.config
        n = config.n_layers
        x = data["x"]
        levels = []
        for i in range(n):
            blk = data["blocks"][i]
            valid_out = data["valid"][i + 1]
            n_out = valid_out.shape[0]
            agg = self._make_agg(blk, n_out, valid_out)
            fe = (compose_epilogue(agg)
                  if self.plan.layers[i].epilogue is not None else None)
            ops = LayerOps(
                aggregate=agg,
                xw=(self._make_xw(data) if i == 0 and "feat" in data else None),
                gat_attention=(self._make_gat(blk, n_out)
                               if self._is_gat else None),
                restrict=lambda u, _n=n_out: u[:_n],
                fused_epilogue=fe,
            )
            x = apply_layer(config, params["layers"][i], x, ops,
                            is_last=(i == n - 1))
            # re-zero padded rows: keeps dump-row garbage out of the next
            # layer's operands
            x = torch.where(valid_out[:, None], x, 0.0)
            if collect:
                levels.append(x)
        if collect:
            # levels[l] rows are the level-(l+1) frontier; levels[-1] is
            # the logits — the serving engine's historical-embedding feed
            return tuple(levels)
        return x  # [node_caps[L], n_classes], padded rows zero

    def _loss(self, params, data) -> torch.Tensor:
        """Mean cross-entropy over the batch's seed rows (0 when none)."""
        logp = torch.log_softmax(self._logits(params, data), dim=-1)
        nll = -logp.gather(1, data["labels"].long()[:, None])[:, 0]
        seed_mask = data["valid"][-1]
        denom = seed_mask.sum().clamp(min=1)
        return torch.where(seed_mask, nll, 0.0).sum() / denom

    def _count_signature(self, kind: str, data: dict) -> None:
        sig = (kind, _signature(data))
        if sig not in self._seen_signatures:
            self._seen_signatures.add(sig)
            if kind == "step":
                self.n_traces += 1
            else:
                self.n_infer_traces += 1

    def _step(self, params, opt_state, data):
        """One batch: loss and gradients, then the optimizer update;
        ``loss`` stays on the device."""
        self._count_signature("step", data)
        loss, grads = value_and_grad(self._loss, params, data)
        with torch.no_grad():
            params, opt_state = self.opt.update(grads, opt_state, params)
        return tree_map(torch.Tensor.detach, params), opt_state, loss

    def _step_guarded(self, params, opt_state, data, scale: float,
                      poison: float):
        """``_step`` under the guard: ``(params, opt_state, loss, ok)``."""
        self._count_signature("step", data)
        return guarded_train_step(self._loss, self.opt, params, opt_state,
                                  data, scale=scale, poison=poison)

    def _infer(self, params, data):
        self._count_signature("logits", data)
        with torch.no_grad():
            return self._logits(params, data)

    def _infer_levels(self, params, data):
        self._count_signature("levels", data)
        with torch.no_grad():
            return self._logits(params, data, collect=True)

    # -- host-side batch marshalling ----------------------------------------

    def _batch_arrays(self, batch: SampledBatch, train: bool = False) -> dict:
        """The batch on the device. ``train`` adds what only a training
        step reads: the labels and each layer's transposed BSR operand;
        inference copies the forward operand alone."""
        dev = self.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        blocks = []
        for blk in batch.blocks:
            if self._agg_mode == "bsr":
                d = {"fwd": {k: t(v) for k, v in blk.fwd_bsr.items()}}
                if train:
                    d["bwd"] = {k: t(v) for k, v in blk.bwd_bsr.items()}
            else:
                d = {"edge_src": t(blk.edge_src), "edge_dst": t(blk.edge_dst),
                     "edge_w": t(blk.edge_w)}
            blocks.append(d)
        data = {
            "x": t(batch.x),
            "valid": tuple(t(v) for v in batch.valid),
            "blocks": tuple(blocks),
        }
        if train:
            data["labels"] = t(batch.labels)
        if self._sparse0:
            if batch.feat_coo is not None:
                data["feat"] = tuple(t(a) for a in batch.feat_coo)
            else:  # denser than the template's cap: dense-path fallback
                self.n_feature_overflows += 1
        return data

    # -- training -----------------------------------------------------------

    def _require_training(self) -> None:
        if self.infer_only:
            raise RuntimeError(
                "trainer is infer-only (plan.infer_only or no optimizer): "
                "training is unavailable")

    def train_epoch(self) -> float:
        """One reshuffled pass over the train seeds; mean seed-weighted loss."""
        self._require_training()
        total, count = 0.0, 0
        for batch in self.sampler.epoch_batches(
                self.train_ids, self.features, self.labels_np,
                rng=self._shuffle_rng):
            data = self._batch_arrays(batch, train=True)
            if self.guard is None:
                self.params, self.opt_state, loss = self._step(
                    self.params, self.opt_state, data)
            else:
                poison = (self.injector.grad_poison(self._global_step)
                          if self.injector is not None else 0.0)
                self.params, self.opt_state, loss, ok = self._step_guarded(
                    self.params, self.opt_state, data, self.guard.scale,
                    poison)
                # a rollback (restore_fn is self.restore) rewinds the RNG
                # streams too, so the replayed epochs redraw the batches
                self.guard.after_step(bool(ok), step=self._global_step)
            self._global_step += 1
            total += float(loss) * batch.n_seeds  # synchronises with the card
            count += batch.n_seeds
        return total / max(count, 1)

    # -- checkpoint / resume (DESIGN.md §13 RNG-state contract) -------------

    def _ckpt_state(self) -> dict:
        return {
            "params": self.params,
            "opt": self.opt_state,
            "epoch": np.int64(self._epoch_idx),
            "global_step": np.int64(self._global_step),
            "shuffle_rng": pack_rng_state(self._shuffle_rng),
            "sampler_rng": pack_rng_state(self.sampler.rng),
        }

    def save(self) -> Optional[str]:
        """Checkpoint params, optimizer state, the epoch and step counters
        and the shuffle and sampler RNG states: all a resume needs to
        replay the exact batch sequence."""
        if not self.ckpt_dir:
            return None
        return save_checkpoint(self.ckpt_dir, self._epoch_idx,
                               self._ckpt_state(), injector=self.injector)

    def restore(self) -> Optional[int]:
        """Restore the latest checkpoint (params, opt state, RNG streams,
        counters); returns the restored epoch, or None if there is none."""
        if not self.ckpt_dir:
            return None
        state, step = restore_checkpoint(self.ckpt_dir, self._ckpt_state())
        if step is None:
            return None
        self.params = state["params"]
        self.opt_state = state["opt"]
        self._epoch_idx = int(state["epoch"])
        self._global_step = int(state["global_step"])
        unpack_rng_state(self._shuffle_rng, state["shuffle_rng"])
        unpack_rng_state(self.sampler.rng, state["sampler_rng"])
        return step

    def fit(self, epochs: int) -> TrainResult:
        """Train until ``epochs`` epochs are done in all (resuming from the
        latest checkpoint under ``ckpt_dir``); per epoch the mean loss and
        the wall time."""
        restored = self.restore() if self.ckpt_dir else None
        losses, times = [], []
        while self._epoch_idx < epochs:
            t0 = time.perf_counter()
            losses.append(self.train_epoch())
            times.append(time.perf_counter() - t0)
            self._epoch_idx += 1
            if self.ckpt_dir and self._epoch_idx % self.ckpt_every == 0:
                self.save()
        return TrainResult(losses=losses, epoch_times=times,
                           final_params=self.params, restored_from=restored,
                           guard=self.guard.stats() if self.guard else None)

    def loss_and_grads(self, seeds: Optional[np.ndarray] = None):
        """Loss and gradients at the current params for one batch (no
        update): the probe the parity tests use. ``seeds`` are user node
        ids (the train seeds by default), sampled with the sampler's own
        stream."""
        self._require_training()
        seeds = self.train_ids if seeds is None else self._to_exec(seeds)
        batch = self.sampler.sample_batch(seeds, self.features, self.labels_np)
        return value_and_grad(self._loss, self.params,
                              self._batch_arrays(batch, train=True))

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


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


class DistributedGNNTrainer:
    """Node-sharded GNN training over the ranks of a ``torch.distributed``
    group (the MPI analog): one instance in each rank process
    (``launch/mesh.py:run_ranks``), each holding its own rows.

    The per-step program, on each rank:
      1. halo exchange            — ghost features in          (paper 2)
      2. fused local aggregation  — the BSR kernels over [local | ghost]
                                    (under a split plan the interior
                                    stream runs while the exchange is on
                                    the wire)                  (Alg 2/3)
      3. dense / Alg-1 sparse transforms per the plan          (Alg 1)
      4. pipelined backward       — each dW_l all-reduced as soon as
                                    autograd has it, before layer l−1's
                                    backward is done (paper 3); ghost
                                    gradients return through the reverse
                                    exchange
      5. optimizer                — the same update on every rank from
                                    the same summed gradients (paper 4),
                                    so the ranks' parameters stay bitwise
                                    equal (one fused Adam launch a step on
                                    the card, with ``adam(fused=True)``)

    Every layer runs ``models.gnn.apply_layer`` — the single-device
    model's algebra — with ``LayerOps`` bound to the distributed backend's
    primitives that the ``DistributedModelPlan`` names. ``dist`` is every
    rank's ``DistributedGraph`` or this rank's ``rank_slice``; a slice
    needs ``plan`` (``lower_distributed`` reads every rank's features),
    lowered on the whole graph (a ``rank_slice`` of it is enough).
    ``params`` (the same on every rank, as ``params_from_jax`` gives) or
    ``seed`` set the starting weights; ``device`` is where the rank runs
    (CUDA unless the caller asks for the CPU). ``guard`` arms the guarded
    step (``runtime.resilience.GuardPolicy``, or a ``GuardRunner`` whose
    ladder and counters carry over from a trainer before this one): the
    non-finite count of the summed gradients folds into the commit, the
    same on every rank. ``injector`` (a ``FaultInjector``, the same seed
    and specs on every rank) poisons the summed gradients of a guarded
    step where its ``grad`` site fires. ``monitor`` (a
    ``runtime.failure.HeartbeatMonitor`` over every rank) and ``clock``
    (its ``VirtualClock``) take a heartbeat a step from every rank
    (``_feed_heartbeats``): each rank keeps its own monitor and feeds it
    every rank's beat, with one step time agreed by the group, so every
    rank's monitor classifies alike. ``_step_idx`` is the global step the
    injection sites key on; a rebuilt trainer is handed it.
    """

    def __init__(self, dist: DistributedGraph, config: GNNConfig,
                 opt: Optimizer, *,
                 plan: Optional[DistributedModelPlan] = None,
                 params: Optional[dict] = None, seed: int = 0,
                 gamma: float = PAPER_GAMMA_DEFAULT,
                 guard: Optional[GuardPolicy] = None,
                 injector: Optional[FaultInjector] = None,
                 monitor=None, clock=None, device=None):
        import torch.distributed as tdist

        self.device = resolve_device(device)
        self.rank = tdist.get_rank()
        world = tdist.get_world_size()
        if world != dist.n_ranks:
            raise ValueError(f"the group has {world} ranks, the graph "
                             f"{dist.n_ranks}")
        if dist.rank is not None and dist.rank != self.rank:
            raise ValueError(f"rank {self.rank} was given the slice of rank "
                             f"{dist.rank}")
        if plan is None:
            plan = lower_distributed(config, dist, gamma=gamma)
        if plan.rank is not None and plan.rank != self.rank:
            raise ValueError(f"rank {self.rank} was given the plan slice of "
                             f"rank {plan.rank}")
        self.dist = dist
        self.config = config
        self.opt = opt
        self.plan = plan
        self.backend = DistributedBackend(inner=plan.inner)
        if params is None:
            params = init_params(config, torch.Generator().manual_seed(seed),
                                 self.device)
        self.params = tree_map(
            lambda p: p.detach().to(self.device, torch.float32).clone(), params)
        self.opt_state = opt.init(self.params)
        self.guard = (guard if isinstance(guard, GuardRunner)
                      else GuardRunner(guard) if guard is not None else None)
        # the resilience control plane (DESIGN.md §13)
        self.injector = injector
        self.monitor = monitor
        self.clock = clock
        self._step_idx = 0
        self._bind()

    def set_rollback(self, restore_fn) -> None:
        """Install the guard ladder's rollback hook (rung 2)."""
        if self.guard is not None:
            self.guard.restore_fn = restore_fn

    def guard_stats(self) -> dict:
        return self.guard.stats() if self.guard is not None else {}

    def _bind(self) -> None:
        """This rank's operands, schedule and per-layer closures, on its
        device: each BSR operand's column stream is built here, once."""
        import torch.distributed as tdist

        dist, plan, config = self.dist, self.plan, self.config
        dev = self.device
        i = 0 if dist.rank is not None else self.rank
        backend = self.backend
        n_local, n_ghost = dist.n_local, dist.n_ghost
        n_buf = n_local + n_ghost
        L = config.n_layers
        sparse0 = plan.layers[0].feature_path == "sparse"
        is_gat = config.kind in ("GAT", "GT")
        is_max = plan.aggregation == "max"
        fuse_attn = is_gat and "dist_spmm_attention" in plan.layers[0].agg_primitive
        ov = plan.overlap
        use_split = ov is not None
        # adjacent layers draw distinct staging slots (GhostBufferRing)
        self.ghost_ring = GhostBufferRing(ov.double_buffer_slots if use_split else 2)
        self.ghost_slots = tuple(self.ghost_ring.acquire(l) for l in range(L))
        self.halo = HaloSchedule.of(
            dist, device=dev, ring=self.ghost_ring,
            shifts=ov.live_shifts if use_split else None)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def operand(d, n_rows, n_cols, rows_padded=None, cols_padded=None):
            blocks = d["blocks"][i]
            _, br, bc = blocks.shape
            return BSRDevice(
                block_rows=t(d["rows"][i]), block_cols=t(d["cols"][i]),
                blocks=t(blocks), n_rows=n_rows, n_cols=n_cols,
                n_rows_padded=rows_padded or _ceil_to(n_rows, br),
                n_cols_padded=cols_padded or _ceil_to(n_cols, bc), br=br, bc=bc)

        ops: dict = {}
        if use_split and not is_max:
            ops["int_fwd"] = operand(dist.fwd_interior, n_local, n_local)
            ops["int_bwd"] = operand(dist.bwd_interior, n_local, n_local)
            ops["bnd_fwd"] = operand(dist.fwd_boundary, n_local, n_buf)
            ops["bnd_bwd"] = operand(dist.bwd_boundary, n_buf, n_local)
        elif not is_max:
            ops["fwd"] = operand(dist.fwd, n_local, n_buf)
            ops["bwd"] = operand(dist.bwd, n_buf, n_local)
        if sparse0:
            f, f_pad = plan.layers[0].d_in, plan.feat_f_pad
            ops["feat_fwd"] = operand(plan.feat_fwd, n_local, f, cols_padded=f_pad)
            ops["feat_bwd"] = operand(plan.feat_bwd, f, n_local, rows_padded=f_pad)
        #: this rank's bound operands, by name (the kernel checks read them)
        self.operands = ops
        halo = self.halo
        edge_src = t(dist.edge_src[i]) if (is_gat or is_max) else None
        edge_dst = t(dist.edge_dst[i]) if (is_gat or is_max) else None
        xw0 = (backend.dist_feature_matmul_sparse(ops["feat_fwd"], ops["feat_bwd"])
               if sparse0 else None)

        def layer_ops(l: int) -> LayerOps:
            slot = self.ghost_slots[l]
            kw = dict(slot=slot, layer=l)
            fused = gat = None
            if is_max:
                def agg(u):
                    buf = torch.cat([u.float(), halo_exchange(u, halo, slot, l)])
                    return backend.dist_segment_max(buf, edge_src, edge_dst, n_local)
            elif use_split:
                split = (ops["int_fwd"], ops["int_bwd"], ops["bnd_fwd"], ops["bnd_bwd"])
                agg = backend.dist_spmm_split_transposed_vjp(*split, halo, **kw)
                fused = backend.dist_spmm_fused_epilogue_split(*split, halo, **kw)
                if fuse_attn:
                    gat = backend.dist_spmm_attention_split(*split, halo, **kw)
            else:
                bulk = (ops["fwd"], ops["bwd"])
                agg = backend.dist_spmm_transposed_vjp(*bulk, halo, **kw)
                fused = backend.dist_spmm_fused_epilogue(*bulk, halo, **kw)
                if fuse_attn:
                    gat = backend.dist_spmm_attention(*bulk, halo, **kw)
            if is_gat and gat is None:
                def gat(z, a_src, a_dst, heads):
                    buf = torch.cat([z.float(), halo_exchange(z, halo, slot, l)])
                    return backend.dist_segment_softmax_aggregate(
                        buf.reshape(n_buf, heads, -1), a_src, a_dst, edge_src,
                        edge_dst, n_local)
            return LayerOps(
                aggregate=agg, xw=xw0 if l == 0 else None, gat_attention=gat,
                fused_epilogue=fused if plan.layers[l].epilogue is not None else None)

        self._layer_fns = arch_layer_fns(config, [layer_ops(l) for l in range(L)])
        self._x = t(dist.features[i])
        self._labels = t(dist.labels[i])
        self._mask = t(dist.mask[i])
        # the loss's denominator: the training rows of every rank, reduced once
        count = self._mask.sum().to(torch.float32)
        tdist.all_reduce(count)
        self._denom = count.clamp(min=1.0)

    def _compute(self, with_guard: bool = False):
        return pipelined_value_and_grad(
            self._layer_fns, self.params, self._x, self._labels, self._mask,
            self._denom, with_guard=with_guard)

    def train_epoch(self) -> float:
        """One full-batch step; returns the global loss (synchronises)."""
        t0 = time.perf_counter()
        if self.guard is None:
            loss, grads = self._compute()
            with torch.no_grad():
                params, self.opt_state = self.opt.update(
                    grads, self.opt_state, self.params)
            self.params = tree_map(torch.Tensor.detach, params)
        else:
            loss, grads, bad = self._compute(with_guard=True)
            poison = (self.injector.grad_poison(self._step_idx)
                      if self.injector is not None else 0.0)
            if poison != 0.0:  # the same summed gradients on every rank
                grads = tree_map(lambda g: g + poison, grads)
            with torch.no_grad():
                p_new, s_new = self.opt.update(grads, self.opt_state, self.params)
                self.params, self.opt_state, loss, ok = guarded_update(
                    self.params, self.opt_state, p_new, s_new, loss,
                    self.guard.scale, extra_bad=bad)
            self.guard.after_step(bool(ok), step=self._step_idx)
        loss = float(loss)  # waits: the step's wall time is complete
        self._feed_heartbeats(time.perf_counter() - t0)
        self._step_idx += 1
        return loss

    def _feed_heartbeats(self, dt: float) -> None:
        """The per-step heartbeat feed (DESIGN.md §13): every rank's beat
        with its step time, into this rank's monitor. The group agrees on
        one step time first (the largest rank's, ``all_reduce(MAX)``), so
        the ranks' monitors hold the same times and classify alike. The
        injector stands in for real hardware faults: a ``rank_dead`` fire
        suppresses that rank's heartbeat (the dead rank's process goes on
        and its peers stop hearing it), ``rank_slow`` inflates its step
        time; the clock, advanced by the agreed time, lets DEAD trip on
        simulated rather than wall-clock timeouts."""
        if self.monitor is None:
            return
        import torch.distributed as tdist

        agreed = torch.tensor([dt], dtype=torch.float64)
        tdist.all_reduce(agreed, op=tdist.ReduceOp.MAX)
        dt = float(agreed)
        if self.clock is not None:
            self.clock.advance(dt)
        for r in range(self.dist.n_ranks):
            if (self.injector is not None
                    and self.injector.fires("rank_dead", self._step_idx, rank=r)):
                continue  # a dead rank stops heartbeating
            factor = (self.injector.slow_factor(self._step_idx, r)
                      if self.injector is not None else 1.0)
            self.monitor.heartbeat(r, dt * factor)

    def loss_and_grads(self):
        """Global loss and all-reduced gradients at the current params (no
        update): the probe the parity tests use."""
        return self._compute()

