"""Gradient utilities: the global norm and clipping, accumulation, and the
int8 per-tensor quantisation the JAX package's compressed all-reduce uses.

Counterpart of ``repro/training/grad.py`` on plain trees of tensors
(``training/optimizer.py:tree_map``). ``compressed_psum``, the all-reduce
itself, is a collective and comes with the distributed path (ROADMAP.md
Queue 1, item 7).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.training.optimizer import tree_leaves, tree_map


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
