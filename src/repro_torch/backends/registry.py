"""Backend primitive registry — counterpart of ``repro/backends/registry.py``.

Each backend is a registered object serving the shared op vocabulary
(DESIGN.md §2). The port registers three:

* ``cuda``   — the Hopper kernels (counterpart of the ``pallas`` backend);
               its kernel wrappers run their plain versions for CPU tensors
* ``torch``  — the plain PyTorch versions on any device (counterpart of
               ``xla``): the reference the ``cuda`` backend is held against
* ``gather`` — edge-list gather + ``index_add_`` (the PyG/DGL baseline)

Unlike the JAX registry there is no platform auto-selection: ``None``
selects ``cuda``, and the device a trainer runs on is the caller's choice
(``repro_torch.resolve_device``). Primitives of later slices raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

#: the op vocabulary every backend serves (DESIGN.md §2)
OP_VOCABULARY = (
    "spmm",
    "spmm_transposed_vjp",
    "spmm_fused_epilogue",
    "segment_softmax_aggregate",
    "sparse_mha",
    "spmm_attention",
    "feature_matmul_sparse",
    "feature_matmul_dense",
)

FULL_BATCH_ITEM = "ROADMAP.md Queue 1, item 2 (full-batch training)"
ATTENTION_ITEM = "ROADMAP.md Queue 1, item 3 (attention)"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {item}")


def apply_epilogue(
    y: torch.Tensor,
    self_term: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    alpha=None,
    activation: str = "none",
) -> torch.Tensor:
    """The epilogue algebra, composed: act(y + alpha * self_term + bias)."""
    if self_term is not None:
        a = 1.0 if alpha is None else alpha
        y = y + a * self_term
    if bias is not None:
        y = y + bias
    if activation == "relu":
        y = torch.relu(y)
    elif activation != "none":
        raise ValueError(f"unsupported fused activation {activation!r}")
    return y


def compose_epilogue(agg: Callable) -> Callable:
    """Wrap an aggregation ``u -> A @ u`` into the fused-epilogue contract
    ``(u, self_term, bias, alpha, activation) -> act(agg(u) + α·self + b)``
    — the composition the sampled path binds on every backend."""

    def fused(u, self_term=None, bias=None, alpha=None, activation="none"):
        return apply_epilogue(agg(u), self_term, bias, alpha, activation)

    return fused


class Backend:
    """Base class: operand construction + the op vocabulary."""

    name: str = "abstract"

    def build_spmm_operand(self, csr, br: int = 8, bc: Optional[int] = None,
                           device=None):
        raise not_ported(f"{self.name}.build_spmm_operand", FULL_BATCH_ITEM)

    def spmm(self, operand, x: torch.Tensor) -> torch.Tensor:
        raise not_ported(f"{self.name}.spmm", FULL_BATCH_ITEM)

    def feature_matmul_dense(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Dense X·W: ``torch.matmul`` in full float32 on every backend."""
        return x @ w

    def spmm_transposed_vjp(self, fwd_operand, bwd_operand):
        raise not_ported(f"{self.name}.spmm_transposed_vjp", FULL_BATCH_ITEM)

    def spmm_fused_epilogue(self, fwd_operand, bwd_operand, bf=None):
        raise not_ported(f"{self.name}.spmm_fused_epilogue", FULL_BATCH_ITEM)

    def feature_matmul_sparse(self, x_np, br: int = 8, bc=None):
        raise not_ported(f"{self.name}.feature_matmul_sparse", FULL_BATCH_ITEM)

    def segment_softmax_aggregate(self, z, a_src, a_dst, src, dst, n_nodes):
        raise not_ported(f"{self.name}.segment_softmax_aggregate",
                         ATTENTION_ITEM)

    def sparse_mha(self, fwd_operand, bwd_operand, bf=None):
        raise not_ported(f"{self.name}.sparse_mha", ATTENTION_ITEM)

    def spmm_attention(self, fwd_operand, bwd_operand, bf=None):
        raise not_ported(f"{self.name}.spmm_attention", ATTENTION_ITEM)


_REGISTRY: dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    """Register (or replace) a backend under ``backend.name``."""
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def select_backend(preference: "str | Backend | None" = None) -> Backend:
    """Resolve an ``engine=`` preference: a Backend passes through, a name
    selects that backend, ``None``/``"auto"`` selects ``cuda``."""
    if isinstance(preference, Backend):
        return preference
    if preference is None or preference == "auto":
        preference = "cuda"
    return get_backend(preference)
