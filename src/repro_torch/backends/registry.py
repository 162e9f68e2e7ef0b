"""Backend primitive registry — counterpart of ``repro/backends/registry.py``.

Each backend is a registered object serving the shared op vocabulary
(DESIGN.md §2). The port registers three:

* ``cuda``   — the Hopper kernels (counterpart of the ``pallas`` backend);
               its kernel wrappers run their plain versions for CPU tensors
* ``torch``  — the plain PyTorch versions on any device (counterpart of
               ``xla``): the reference the ``cuda`` backend is held against
* ``gather`` — edge-list gather + ``index_add_`` (the PyG/DGL baseline)

and ``distributed`` (``DIST_OP_VOCABULARY``), which ``lower_distributed``
asks for by name and ``select_backend(None)`` never picks.

Unlike the JAX registry there is no platform auto-selection: ``None``
selects ``cuda``, and the device operands are built on is the caller's
choice (``repro_torch.resolve_device``: CUDA unless asked). Parts still
to be ported raise ``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph, csr_from_dense

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

#: the distributed (MPI-analog) op vocabulary (DESIGN.md §6), served by
#: ``backends/distributed.py`` as halo-exchange compositions of one rank's
#: local primitives; ``lower_distributed`` binds these per layer
DIST_OP_VOCABULARY = (
    "dist_spmm",
    "dist_spmm_transposed_vjp",
    "dist_spmm_fused_epilogue",
    "dist_segment_softmax_aggregate",
    "dist_spmm_attention",
    "dist_segment_max",
    "dist_feature_matmul_sparse",
)

#: what item 7 still leaves: (4) tensor-parallel sharding, (5) a transport
#: other than gloo (NCCL, CUDA IPC)
DIST_ITEM = "ROADMAP.md Queue 1, item 7, parts 4 and 5 (distributed)"


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


def edge_softmax_aggregate(
    z: torch.Tensor,      # [N, H, Dh] projected features (source index space)
    a_src: torch.Tensor,  # [H, Dh]
    a_dst: torch.Tensor,  # [H, Dh]
    src: torch.Tensor,    # [E] int
    dst: torch.Tensor,    # [E] int
    n_out: int,
    valid: Optional[torch.Tensor] = None,  # [E] bool; None = all edges real
) -> torch.Tensor:
    """GAT edge-softmax aggregation on the segment (gather) path, [n_out,
    H, Dh] — counterpart of ``repro/backends/registry.py:
    edge_softmax_aggregate``, which every backend's
    ``segment_softmax_aggregate`` calls.

    The true segment max is subtracted before ``exp``, as a constant
    (detached: softmax is shift-invariant), and segments without an edge,
    whose max is -inf, shift by 0. ``valid`` handles padded edge lists:
    invalid edges go to a dump segment past ``n_out`` and are zeroed, so
    they contribute nothing, value or gradient."""
    if valid is None:
        seg, n_seg, src_c, dst_c = dst.long(), n_out, src.long(), dst.long()
    else:
        src_c = torch.where(valid, src, 0).long()
        dst_c = torch.where(valid, dst, 0).long()
        seg = torch.where(valid, dst, n_out).long()  # dump slot for padding
        n_seg = n_out + 1
    alpha_src = torch.einsum("nhd,hd->nh", z, a_src)
    alpha_dst = torch.einsum("nhd,hd->nh", z, a_dst)
    pre = alpha_src[src_c] + alpha_dst[dst_c]  # [E, H]
    e = torch.where(pre >= 0, pre, 0.2 * pre)
    with torch.no_grad():
        e_max = torch.full((n_seg, e.shape[1]), -torch.inf, dtype=e.dtype,
                           device=e.device).scatter_reduce_(
            0, seg[:, None].expand_as(e), e, "amax")
        e_max = torch.where(torch.isfinite(e_max), e_max, 0.0)
    ee = torch.exp(e - e_max[seg])
    if valid is not None:
        ee = torch.where(valid[:, None], ee, 0.0)
    denom = torch.zeros((n_seg, e.shape[1]), dtype=ee.dtype,
                        device=ee.device).index_add(0, seg, ee)
    att = ee / (denom[seg] + 1e-9)
    msgs = z[src_c] * att[..., None]  # [E, H, Dh]
    if valid is not None:
        msgs = torch.where(valid[:, None, None], msgs, 0.0)
    out = torch.zeros((n_seg, *z.shape[1:]), dtype=msgs.dtype,
                      device=msgs.device).index_add(0, seg, msgs)
    return out[:n_out] if valid is not None else out


def compose_epilogue(agg: Callable) -> Callable:
    """Wrap an aggregation ``u -> A @ u`` into the fused-epilogue contract
    ``(u, self_term, bias, alpha, activation) -> act(agg(u) + α·self + b)``
    — the composition the sampled path binds on every backend."""

    def fused(u, self_term=None, bias=None, alpha=None, activation="none"):
        return apply_epilogue(agg(u), self_term, bias, alpha, activation)

    return fused


class _TransposedVJP(torch.autograd.Function):
    """``x -> spmm(fwd, x)`` whose backward is ``spmm(bwd, dy)``."""

    @staticmethod
    def forward(ctx, x, spmm, fwd_operand, bwd_operand):
        ctx.spmm, ctx.bwd_operand = spmm, bwd_operand
        return spmm(fwd_operand, x)

    @staticmethod
    def backward(ctx, dy):
        dx = ctx.spmm(ctx.bwd_operand, dy.float().contiguous())
        return dx, None, None, None


class Backend:
    """Base class: operand construction + the op vocabulary.

    Subclasses implement ``build_spmm_operand`` / ``spmm`` /
    ``operand_bytes`` for their sparse layout; the differentiable
    compositions (``spmm_transposed_vjp``, the composed
    ``spmm_fused_epilogue``, ``feature_matmul_sparse``) are shared.
    """

    name: str = "abstract"

    # -- operand construction (one-time lowering, O(nnz)) --------------------

    def build_spmm_operand(self, csr: CSRGraph, br: int = 8,
                           bc: Optional[int] = None, device=None):
        """This backend's operand of ``csr`` on ``device`` (CUDA unless
        asked). ``bc=None`` is the adaptive width (``adaptive_bc``)."""
        raise NotImplementedError

    def operand_bytes(self, operand) -> int:
        raise NotImplementedError

    # -- primitives ----------------------------------------------------------

    def spmm(self, operand, x: torch.Tensor) -> torch.Tensor:
        """Y = A @ X (not differentiable through the operand)."""
        raise NotImplementedError

    def feature_matmul_dense(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Dense X·W: ``torch.matmul`` in full float32 on every backend."""
        return x @ w

    # -- differentiable compositions ----------------------------------------

    def spmm_transposed_vjp(self, fwd_operand, bwd_operand
                            ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Differentiable ``x -> A @ x`` whose backward multiplies by the
        pre-built transposed operand (dX = Aᵀ @ dY): conflict-free, no
        autograd through the sparse layout."""

        def mm(x):
            return _TransposedVJP.apply(x, self.spmm, fwd_operand, bwd_operand)

        return mm

    def spmm_fused_epilogue(self, fwd_operand, bwd_operand) -> Callable:
        """Differentiable ``(u, self_term, bias, alpha, activation) ->
        act(A @ u + alpha * self_term + bias)`` over the pre-built pair.
        Base: the transposed-VJP spmm composed with ``apply_epilogue`` (the
        edge-list lowering); ``cuda`` and ``torch`` override it with the
        fused kernel and its plain version."""
        return compose_epilogue(
            self.spmm_transposed_vjp(fwd_operand, bwd_operand))

    def feature_matmul_sparse(self, x_np: np.ndarray, br: int = 8,
                              bc: Optional[int] = None, device=None
                              ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Differentiable ``w -> X @ w`` with X (the feature matrix) held in
        this backend's sparse layout: forward on the operand of X, backward
        dW = Xᵀ @ dY on the pre-transposed operand (dX is never formed, X is
        the input). Both O(nnz) conversions happen here, once (Alg 1
        'DenseToCSR')."""
        x_csr = csr_from_dense(np.asarray(x_np))
        fwd = self.build_spmm_operand(x_csr, br=br, bc=bc, device=device)
        bwd = self.build_spmm_operand(x_csr.transpose(), br=br, bc=bc,
                                      device=device)
        return self.spmm_transposed_vjp(fwd, bwd)

    # -- attention (DESIGN.md §10) -------------------------------------------

    def segment_softmax_aggregate(self, z, a_src, a_dst, src, dst,
                                  n_nodes: int) -> torch.Tensor:
        """GAT edge-softmax aggregation, [N, H, Dh] out, on the segment
        (gather) path: the universal attention lowering."""
        return edge_softmax_aggregate(z, a_src, a_dst, src, dst, n_nodes)

    def sparse_mha(self, fwd_operand, bwd_operand) -> Optional[Callable]:
        """Differentiable fused attention ``(z [N, H, Dh], a_src, a_dst) ->
        [n_dst, H, Dh]`` over a pre-built operand pair, or ``None`` where
        this backend has no fused lowering (the plan then binds the
        segment primitive)."""
        return None

    def spmm_attention(self, fwd_operand, bwd_operand) -> Optional[Callable]:
        """``sparse_mha`` in the models' calling convention:
        ``(z [N, H*Dh], a_src, a_dst, heads) -> [n_dst, H, Dh]``."""
        mha = self.sparse_mha(fwd_operand, bwd_operand)
        if mha is None:
            return None

        def attention(z, a_src, a_dst, heads):
            return mha(z.reshape(z.shape[0], heads, z.shape[-1] // heads),
                       a_src, a_dst)

        return attention


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
