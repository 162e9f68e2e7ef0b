"""Optimizers — SGD, Adam, AdamW (paper §IV "integration with optimizers
(SGD, Adam, AdamW)" and the vectorized Adam of §IV-E2.4).

Counterpart of ``repro/training/optimizer.py`` with its optax-like
contract: ``opt.init(params) -> state``, ``opt.update(grads, state, params)
-> (new_params, new_state)``, on plain trees (dicts and lists) of tensors;
inputs are not modified. The step count lives on the host, so the bias
correction ``lr_t`` is a host float32 and a step reads nothing back from
the card. With ``fused=True`` the Adam family runs each leaf through the
Hopper kernel ``kernels/csrc/fused_adam.cu`` (one pass instead of ~10
elementwise ops); CPU tensors take its plain version.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.fused_adam import fused_adam


def tree_leaves(tree) -> list:
    """Leaves in the JAX package's order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves) -> object:
    """A tree shaped like ``like`` holding ``leaves`` (``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest):
    leaves = zip(tree_leaves(tree), *(tree_leaves(r) for r in rest))
    return tree_unflatten(tree, [fn(*args) for args in leaves])


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (params, state)


class AdamState(NamedTuple):
    step: int  # host count: lr_t is computed without a device sync
    m: object
    v: object


class SGDState(NamedTuple):
    step: int
    momentum: Optional[object]


def sgd(lr: "float | Callable" = 1e-2, momentum: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params):
        mom = tree_map(torch.zeros_like, params) if momentum else None
        return SGDState(step=0, momentum=mom)

    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        if momentum:
            new_mom = tree_map(lambda mv, g: momentum * mv + g,
                               state.momentum, grads)
            return (tree_map(lambda p, mv: p - lr_t * mv, params, new_mom),
                    SGDState(step=step, momentum=new_mom))
        return (tree_map(lambda p, g: p - lr_t * g, params, grads),
                SGDState(step=step, momentum=None))

    return Optimizer(init, update)


def bias_corrected_lr(lr: float, beta1: float, beta2: float,
                      step: int) -> float:
    """lr_t = lr · sqrt(1 - β2^t) / (1 - β1^t) in float32, on the host, as
    the JAX package folds it on the device (``optimizer.py:82``)."""
    f32 = np.float32
    t = f32(step)
    lr_t = (f32(lr) * np.sqrt(f32(1.0) - f32(beta2) ** t)
            / (f32(1.0) - f32(beta1) ** t))
    return float(f32(lr_t))


def adam(
    lr: "float | Callable" = 1e-3,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    fused: bool = False,
) -> Optimizer:
    """Adam/AdamW. ``weight_decay > 0`` gives AdamW (decoupled decay)."""
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params):
        zeros = lambda: tree_map(  # noqa: E731
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        return AdamState(step=0, m=zeros(), v=zeros())

    def leaf_plain(p, g, m, v, lr_t):
        g32 = g.float()
        m_new = beta1 * m + (1 - beta1) * g32
        v_new = beta2 * v + (1 - beta2) * g32 * g32
        upd = m_new / (torch.sqrt(v_new) + eps) + weight_decay * p.float()
        return (p - lr_t * upd.to(p.dtype)).to(p.dtype), m_new, v_new

    def leaf_fused(p, g, m, v, lr_t):
        return fused_adam(p.detach().contiguous(), g.contiguous(), m, v, lr_t,
                          beta1=beta1, beta2=beta2, eps=eps,
                          weight_decay=weight_decay)

    leaf = leaf_fused if fused else leaf_plain

    def update(grads, state, params):
        step = state.step + 1
        lr_t = bias_corrected_lr(lr_fn(step), beta1, beta2, step)
        out = [leaf(p, g, m, v, lr_t) for p, g, m, v in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
            tree_leaves(state.v))]
        new_params, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                                    for i in range(3))
        return new_params, AdamState(step=step, m=new_m, v=new_v)

    return Optimizer(init, update)


def adamw(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
          **kw) -> Optimizer:
    return adam(lr, beta1, beta2, eps, weight_decay, **kw)


def get_optimizer(name: str, lr: float, *args, **kw) -> Optimizer:
    """Paper Listing-1 style: ``gnn.optimizer("adam", 0.01, 0.9, 0.999)``."""
    name = name.lower()
    if name == "sgd":
        kw.pop("fused", None)  # sgd has no fused kernel path
        return sgd(lr, *args, **kw)
    if name in ("adam", "adamw"):
        b1 = args[0] if args else kw.pop("beta1", 0.9)
        b2 = args[1] if len(args) > 1 else kw.pop("beta2", 0.999)
        return (adam if name == "adam" else adamw)(lr, b1, b2, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
