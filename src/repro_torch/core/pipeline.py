"""Pipelined backward propagation — paper §IV-E2.3 (Gradient Communication
Pipeline). Counterpart of ``repro/core/pipeline.py``.

The paper's MPI schedule per layer l:
  (a) compute dW_l locally,
  (b) immediately issue a non-blocking all-reduce on dW_l,
  (c) compute dX_{l-1} while the reduction is in flight,
  (d) wait only before the optimizer consumes dW.

The JAX package hand-rolls the backward per layer so that ``psum(dW_l)``
is emitted before layer l−1's backward. Here autograd runs the backward,
and a post-accumulate-grad hook on every parameter leaf issues its
``all_reduce(async_op=True)`` the moment autograd has accumulated it:
autograd runs a leaf's accumulation as soon as its gradient is ready
(before the next layer's backward nodes), so layer l's reductions are on
the wire while layer l−1's backward runs. The reductions are issued in
one fixed order on every rank (layers last to first, each layer's leaves
in tree order: a leaf waits for the ones before it), as collectives must
be; ``pipelined_value_and_grad`` waits for all of them before it
returns. The per-layer closures come from ``models/gnn.py:apply_layer``
bound to whatever ``LayerOps`` the caller supplies (the halo-exchange
compositions of ``backends/distributed.py`` on the distributed path).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as tdist

from repro_torch.models.gnn import GNNConfig, LayerOps, apply_layer
from repro_torch.training.optimizer import tree_leaves, tree_unflatten


def arch_layer_fns(config: GNNConfig,
                   layer_ops: Sequence[LayerOps]) -> list[Callable]:
    """Per-layer closures ``(layer_params, h) -> h_next`` for any arch,
    each bound to its own ``LayerOps`` (layer 0 may carry the Alg-1 sparse
    ``xw`` binding; the rest run dense)."""
    n = config.n_layers
    if len(layer_ops) != n:
        raise ValueError(f"need {n} LayerOps, got {len(layer_ops)}")

    def make(i: int) -> Callable:
        def fn(layer_params: dict, h: torch.Tensor) -> torch.Tensor:
            return apply_layer(config, layer_params, h, layer_ops[i],
                               is_last=(i == n - 1))
        return fn

    return [make(i) for i in range(n)]


def masked_ce_grad(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor, denom: torch.Tensor):
    """Loss and dlogits of the masked cross-entropy (sum over the masked
    rows / ``denom``), in closed form as the JAX package computes them."""
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    nll = -(onehot * logp).sum(-1)
    loss = torch.where(mask, nll, 0.0).sum() / denom
    dlogits = (torch.exp(logp) - onehot) * (mask[:, None].to(logits.dtype) / denom)
    return loss, dlogits


class _ReduceInOrder:
    """Issues each leaf's all-reduce once it and every leaf before it in
    ``order`` have their gradients: the same sequence on every rank."""

    def __init__(self, leaves: list, order: list):
        self.leaves, self.order = leaves, order
        self.ready = [False] * len(leaves)
        self.next = 0
        self.works: list = []

    def hook(self, i: int):
        def on_grad(_param):
            self.ready[i] = True
            self.issue()
        return on_grad

    def issue(self) -> None:
        while self.next < len(self.order) and self.ready[self.order[self.next]]:
            leaf = self.leaves[self.order[self.next]]
            self.works.append(tdist.all_reduce(leaf.grad, async_op=True))
            self.next += 1

    def finish(self) -> None:
        """Give a leaf the backward did not reach a zero gradient, issue
        the rest, and wait for every reduction."""
        for i, leaf in enumerate(self.leaves):
            if not self.ready[i]:
                leaf.grad = torch.zeros_like(leaf)
                self.ready[i] = True
        self.issue()
        for w in self.works:
            w.wait()


def pipelined_value_and_grad(
    layer_fns: Sequence[Callable],
    params: dict,
    x: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    denom: torch.Tensor,
    with_guard: bool = False,
):
    """Masked-CE loss and gradients with the per-layer early all-reduce.

    ``denom`` is the count of training rows over every rank (reduced once
    by the caller), so each rank's loss is its masked sum over it and the
    ranks' losses and gradients add up to the whole graph's. Returns
    ``(loss, grads)``, both summed over the default process group,
    ``grads`` shaped like ``params`` (``{"layers": [...]}``);
    ``with_guard=True`` adds a 0-d int32 count of the non-finite gradient
    elements (the same on every rank: it counts the reduced gradients).
    Without a process group nothing is reduced."""
    reduce = tdist.is_available() and tdist.is_initialized()
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    # the fixed order of the reductions: layers last to first
    per_layer = [len(tree_leaves(layer)) for layer in p["layers"]]
    starts = [sum(per_layer[:i]) for i in range(len(per_layer))]
    order = [starts[i] + k for i in reversed(range(len(per_layer)))
             for k in range(per_layer[i])]
    reducer = _ReduceInOrder(leaves, order) if reduce else None
    handles = ([leaf.register_post_accumulate_grad_hook(reducer.hook(i))
                for i, leaf in enumerate(leaves)] if reduce else [])
    try:
        h = x
        for fn, layer in zip(layer_fns, p["layers"]):
            h = fn(layer, h)
        loss, dlogits = masked_ce_grad(h.detach(), labels, mask, denom)
        h.backward(dlogits)
    finally:
        for handle in handles:
            handle.remove()
    if reducer is not None:
        reducer.finish()
    loss = loss.detach()
    if reduce:
        tdist.all_reduce(loss)
    grads = [torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
             for leaf in leaves]
    out = (loss, tree_unflatten(params, grads))
    if with_guard:
        bad = sum((~torch.isfinite(g)).sum(dtype=torch.int32) for g in grads)
        return out + (bad,)
    return out
