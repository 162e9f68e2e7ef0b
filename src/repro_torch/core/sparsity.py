"""Sparsity-aware execution engine — Algorithm 1 + Eq. (1)-(5) of the paper.

Counterpart of ``repro/core/sparsity.py``: the decision arithmetic is the
same, so both packages lower the same spec to the same plan. The runtime
dispatches to the sparse feature path iff s > 1 - γ, where the Efficiency
Ratio γ = η_sparse / η_dense defaults to the paper's 0.20 (τ ≈ 0.80).
``calibrate_gamma`` (γ measured on the H100) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

PAPER_GAMMA_DEFAULT = 0.20  # §IV-B.a: SpMM sustains ≈20% of dense throughput


@dataclasses.dataclass(frozen=True)
class SparsityDecision:
    mode: Literal["sparse", "dense"]
    sparsity: float
    gamma: float
    threshold: float  # τ = 1 - γ
    # modelled times (arbitrary units, work/η) for reporting
    t_dense: float
    t_sparse: float


def feature_sparsity(x: np.ndarray) -> float:
    """s = 1 - nnz(X) / (N·F). Host-side, once at load (Alg 1 Phase 1)."""
    x = np.asarray(x)
    return float(1.0 - np.count_nonzero(x) / max(x.size, 1))


def efficiency_ratio_threshold(gamma: float) -> float:
    """τ = 1 - γ  (Eq. 5)."""
    if not 0.0 < gamma <= 1.0:
        raise ValueError(f"gamma must be in (0, 1], got {gamma}")
    return 1.0 - gamma


def decide_execution_path_from_stats(
    sparsity: float,
    n_nodes: int,
    n_features: int,
    n_hidden: int,
    gamma: float = PAPER_GAMMA_DEFAULT,
) -> SparsityDecision:
    """Alg 1 decision from pre-computed statistics (no matrix needed).

    Work model (§IV-B.d): W_dense = 2NFH, W_sparse ≈ 2(1-s)NFH, T = W/η.
    """
    tau = efficiency_ratio_threshold(gamma)
    w_dense = 2.0 * n_nodes * n_features * n_hidden
    w_sparse = 2.0 * (1.0 - sparsity) * n_nodes * n_features * n_hidden
    t_dense = w_dense / 1.0  # η_dense normalised to 1
    t_sparse = w_sparse / gamma
    mode = "sparse" if sparsity >= tau else "dense"
    return SparsityDecision(
        mode=mode, sparsity=sparsity, gamma=gamma, threshold=tau,
        t_dense=t_dense, t_sparse=t_sparse,
    )


def decide_execution_path(
    x: np.ndarray,
    gamma: float = PAPER_GAMMA_DEFAULT,
    n_hidden: int | None = None,
) -> SparsityDecision:
    """Alg 1, Phase 1: runtime analysis & lowering decision for a concrete
    feature matrix (measures s, then applies the stats-based decision)."""
    s = feature_sparsity(x)
    n, f = np.asarray(x).shape[-2], np.asarray(x).shape[-1]
    h = n_hidden if n_hidden is not None else f
    return decide_execution_path_from_stats(s, n, f, h, gamma=gamma)


#: expected zero fraction of a post-ReLU activation with roughly centred
#: pre-activations — the hidden-layer analog of measured input sparsity.
POST_RELU_SPARSITY_ESTIMATE = 0.5


def estimate_activation_sparsity(activation=None) -> float:
    """Estimated sparsity of a hidden layer's input: ReLU-family
    activations (the port's own ``torch.relu`` and ``relu6``) zero about
    half the entries; smooth activations produce dense tensors."""
    if activation in (torch.relu, torch.nn.functional.relu6):
        return POST_RELU_SPARSITY_ESTIMATE
    return 0.0
