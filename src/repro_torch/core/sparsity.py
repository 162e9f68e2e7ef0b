"""Sparsity-aware execution engine — Algorithm 1 + Eq. (1)-(5) of the paper.

Counterpart of ``repro/core/sparsity.py``: the decision arithmetic is the
same, so both packages lower the same spec to the same plan. The runtime
dispatches to the sparse feature path iff s > 1 - γ, where the Efficiency
Ratio γ = η_sparse / η_dense defaults to the paper's 0.20 (τ ≈ 0.80).
``calibrate_gamma`` runs the paper's offline microbenchmark on this
device instead: the sparse primitive a plan binds for a sparse layer 0
(``feature_matmul_sparse``, on ``cuda`` the Hopper ``bsr_spmm`` over X's
nonzero columns) against float32 ``torch.matmul``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Literal, Optional

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

    @property
    def predicted_speedup(self) -> float:
        return self.t_dense / max(self.t_sparse, 1e-30)


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


@dataclasses.dataclass(frozen=True)
class GammaMeasurement:
    """One ``measure_gamma`` run: seconds a call of each side, their
    sustained rates (useful FLOP/s: 2·nnz(X)·h sparse, 2·n·f·h dense) and
    γ = η_sparse / η_dense clipped to [1e-4, 1]."""

    n: int
    f: int
    h: int
    nnz: int
    t_dense: float
    t_sparse: float
    eta_dense: float
    eta_sparse: float
    gamma: float


def _time_call(fn: Callable[[], object], device: torch.device,
               repeats: int) -> float:
    """Seconds a call, after one untimed call: CUDA events around
    ``repeats`` back-to-back calls on the card, the host clock elsewhere."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        return (time.perf_counter() - t0) / repeats
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / repeats


def measure_gamma(
    n: int = 1024,
    f: int = 1024,
    h: int = 64,
    sparsity: float = 0.9,
    seed: int = 0,
    repeats: int = 3,
    *,
    x: Optional[np.ndarray] = None,
    engine: str = "cuda",
    device=None,
) -> GammaMeasurement:
    """The microbenchmark behind ``calibrate_gamma``. X is ``x`` where
    given (the data's own features: γ at the caller's shape), else an
    ``n × f`` standard normal matrix with a ``sparsity`` share of zeros;
    W is ``f × h``. The sparse side is ``engine``'s
    ``feature_matmul_sparse(X)`` forward, its operands built before
    timing; the dense side ``torch.matmul`` in float32 (the package keeps
    TF32 off). Both on ``device`` (CUDA unless asked)."""
    from repro_torch import resolve_device
    from repro_torch.backends import select_backend

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if x is None:
        x = rng.standard_normal((n, f)).astype(np.float32)
        x[rng.random((n, f)) < sparsity] = 0.0
    x = np.asarray(x, dtype=np.float32)
    n, f = x.shape
    w = torch.from_numpy(rng.standard_normal((f, h)).astype(np.float32)).to(dev)
    xt = torch.from_numpy(x).to(dev)
    sparse = select_backend(engine).feature_matmul_sparse(x, device=dev)
    with torch.no_grad():
        t_dense = _time_call(lambda: torch.matmul(xt, w), dev, repeats)
        t_sparse = _time_call(lambda: sparse(w), dev, repeats)
    nnz = int(np.count_nonzero(x))
    eta_dense = 2.0 * n * f * h / max(t_dense, 1e-12)
    eta_sparse = 2.0 * nnz * h / max(t_sparse, 1e-12)
    return GammaMeasurement(
        n=n, f=f, h=h, nnz=nnz, t_dense=t_dense, t_sparse=t_sparse,
        eta_dense=eta_dense, eta_sparse=eta_sparse,
        gamma=float(np.clip(eta_sparse / eta_dense, 1e-4, 1.0)))


def calibrate_gamma(
    n: int = 1024,
    f: int = 1024,
    h: int = 64,
    sparsity: float = 0.9,
    seed: int = 0,
    repeats: int = 3,
    *,
    x: Optional[np.ndarray] = None,
    engine: str = "cuda",
    device=None,
) -> float:
    """Offline microbenchmark for γ on this device (paper §IV-B.a):
    η_sparse / η_dense, clipped to [1e-4, 1] (``measure_gamma``). γ is a
    per-hardware constant by design; the lowering keeps the paper's 0.20
    unless the caller passes another."""
    return measure_gamma(n, f, h, sparsity, seed, repeats, x=x,
                         engine=engine, device=device).gamma
