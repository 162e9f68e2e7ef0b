"""Gradient utilities: the global norm and clipping, accumulation, the
int8 per-tensor quantisation and the compressed all-reduce over it.

Counterpart of ``repro/training/grad.py`` on plain trees of tensors
(``training/optimizer.py:tree_map``). ``compressed_psum`` reduces over the
default ``torch.distributed`` group (JAX's ``psum`` over a named axis).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.training.optimizer import tree_leaves, tree_map, tree_unflatten


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: x * scale, tree), norm


class AccumState(NamedTuple):
    grads: object
    count: int  # a host count, as the optimizers keep their steps


def accum_init(params) -> AccumState:
    return AccumState(
        grads=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params),
        count=0)


def accum_add(state: AccumState, grads) -> AccumState:
    return AccumState(grads=tree_map(lambda a, g: a + g.float(), state.grads, grads),
                      count=state.count + 1)


def accum_mean(state: AccumState):
    c = float(max(state.count, 1))
    return tree_map(lambda a: a / c, state.grads)


# ---------------------------------------------------------------------------
# int8 quantisation (per-tensor scale)
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8. Returns (q, scale)."""
    absmax = torch.max(torch.abs(x)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads, error_buf, group=None):
    """All-reduce int8-quantised gradients with error feedback.

    ``error_buf`` (shaped like ``grads``) accumulates the quantisation
    residual locally and re-injects it next step, which keeps SGD/Adam
    convergence (Karimireddy et al.-style EF). Returns ``(mean_grads,
    new_error_buf)``. Per leaf: the int8 payload is summed as int32 (no
    overflow across ranks), the per-rank scales are summed in fp32
    (negligible volume), and the mean is rebuilt from the mean of the
    scales (valid for similar magnitudes; the residual absorbs the
    reconstruction error); the payload shrinks 4x against fp32 (sent as
    int32 here: gloo sums no int8). Over ``group`` (the default group if
    None); every rank passes its own gradients and buffer.
    """
    import torch.distributed as tdist

    n = tdist.get_world_size(group)
    means, errs = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(error_buf)):
        g32 = g.float() + e
        q, scale = quantize_int8(g32)
        new_e = g32 - dequantize_int8(q, scale)  # residual stays local
        summed = q.to(torch.int32)
        tdist.all_reduce(summed, group=group)
        scale_sum = scale.reshape(1).float().clone()
        tdist.all_reduce(scale_sum, group=group)
        mean = summed.float() * (scale_sum[0] / n) / n
        means.append(mean)
        errs.append(new_e)
    return tree_unflatten(grads, means), tree_unflatten(grads, errs)
