"""Loops whose steps all take the same shapes: the sLSTM's time steps
(``models/xlstm.py:slstm_scan``, forward and backward), the SSD and mLSTM
chunk loops (``models/ssm.py``, ``models/xlstm.py``) and a training step's
microbatches (``models/model_zoo.py:make_train_step``).

``steps(n)`` is ``range(n)`` and ``stack(items, n, dim)`` is
``torch.stack(items, dim)``. A reckoning of a step's cost over value-less
tensors (``launch/step_cost.py:StepCost``) may sample such loops instead,
as the JAX package's ``launch/hlo_analysis.py`` multiplies a while body by
its known trip count: it runs the first steps, scales their counts to
``n``, and stands in for the stack of the ``n`` steps' tensors that the
sampled run did not make. A loop that autograd will differentiate through
(``through_grad``: a chunk loop's carried state in training) runs every
step, since a backward through steps that never ran cannot be counted.
Outside a reckoning both are the plain calls.
"""
from __future__ import annotations

from typing import Iterable

import torch

#: the reckoning that samples the loops (``launch/step_cost.py:StepCost``
#: sets it while it is entered with ``sample > 0``), else None
_reckoning = None


def steps(n: int, through_grad: bool = False) -> Iterable[int]:
    """The indices of an ``n``-step loop whose steps share their shapes;
    ``through_grad`` where autograd records the loop's carried state."""
    if _reckoning is None or through_grad:
        return range(n)
    return _reckoning.sampled_steps(n)


def stack(items: list, n: int, dim: int = 0) -> torch.Tensor:
    """``torch.stack(items, dim)`` of the tensors one step of a ``steps(n)``
    loop appended each; a sampled loop's fewer items stand for all ``n``."""
    if len(items) == n:
        return torch.stack(items, dim)
    return _reckoning.stack_sampled(items, n, dim)
