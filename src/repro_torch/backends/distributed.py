"""Distributed backend — the MPI-analog op vocabulary, as registry
primitives. Counterpart of ``repro/backends/distributed.py``.

The backend serves ``DIST_OP_VOCABULARY`` (``registry.py``) by composing
one rank's local primitives with the halo exchange (``core/halo.py``),
inside a rank process of a ``torch.distributed`` group. Every operand is
the calling rank's own: ``BSRDevice`` pairs (``kernels/ops.py``) of its
local adjacency (rows ``[local]``, columns ``[local | ghost]``), its
interior and boundary streams, or its X_local, on its device, and its
``HaloSchedule``. The local products dispatch on an *inner* executor:
``cuda``, the Hopper kernels (whose wrappers run their plain versions
for CPU tensors), on a machine with a card, ``torch`` (the plain
versions) elsewhere.

  dist_spmm[_transposed_vjp]     ghost rows in (``halo_exchange``), then
                                 the local SpMM over ``[local | ghost]``;
                                 the VJP multiplies by the pre-built Aᵀ and
                                 returns the ghost rows' gradients to their
                                 owners through the reverse exchange.
  dist_spmm_fused_epilogue       the same with the fused epilogue kernel.
  dist_spmm_split_transposed_vjp the split-phase form (DESIGN.md §11): the
  dist_spmm_fused_epilogue_split exchange is posted, the interior product
                                 (local columns only) launched, and only
                                 then is the exchange waited for; the
                                 boundary product runs once the ghosts
                                 have landed. The backward does the same
                                 the other way: the boundary Aᵀ product
                                 gives the ghost gradients, their reverse
                                 exchange is posted, the interior Aᵀ
                                 product launched, then the exchange is
                                 waited for. With the epilogue, the
                                 interior launch folds α·self + bias and
                                 the boundary launch folds the interior
                                 sum in as its self term, so the
                                 activation and its mask come from the
                                 whole sum act(y_int + y_bnd + α·self + b),
                                 never from one stream's half.
  dist_feature_matmul_sparse     the Alg-1 sparse input path: ``w ->
                                 X_local @ w``, dW = X_localᵀ @ dY; no
                                 exchange (layer-0 rows are rank-resident).
  dist_spmm_attention[_split]    the fused attention kernels over
                                 ``[local | ghost]``; the split form runs
                                 the interior stream over the local rows
                                 while the exchange is in flight. The
                                 split is softmax-exact: each
                                 destination's in-edges lie in one stream.
  dist_segment_softmax_aggregate GAT's edge softmax on the segment path,
  dist_segment_max               and max aggregation, over the rank's
                                 -1-padded edge list.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.backends.registry import Backend, edge_softmax_aggregate
from repro_torch.core.halo import (
    HaloSchedule,
    halo_exchange,
    halo_exchange_debug,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import BSRDevice

_fit = kops._fit_rows  # zero-pad or cut the leading axis (differentiable)


def _spmm(op: BSRDevice, x: torch.Tensor, inner: str) -> torch.Tensor:
    """A @ x on padded rows: [op.n_rows_padded, F]."""
    return kops._executor(inner, "spmm")(
        op.block_rows, op.block_cols, op.blocks,
        _fit(x, op.n_cols_padded).contiguous(), op.n_rows_padded,
        **kops._nzc_kw(inner, op.nonzero_columns))


def _fused(op: BSRDevice, x, self_term, bias, alpha, activation,
           inner: str) -> tuple:
    """act(A @ x + alpha * self_term + bias) and its ReLU mask (or None),
    on padded rows."""
    return kops._executor(inner, "fused")(
        op.block_rows, op.block_cols, op.blocks,
        _fit(x, op.n_cols_padded).contiguous(), op.n_rows_padded,
        None if self_term is None
        else _fit(self_term, op.n_rows_padded).contiguous(),
        bias, alpha, activation, **kops._nzc_kw(inner, op.nonzero_columns))


def _masked(op: BSRDevice, dy, mask, inner: str) -> torch.Tensor:
    """A @ (mask ⊙ dy) on padded rows."""
    n = op.n_cols_padded
    return kops._executor(inner, "masked")(
        op.block_rows, op.block_cols, op.blocks, _fit(dy, n).contiguous(),
        _fit(mask, n).contiguous(), op.n_rows_padded,
        **kops._nzc_kw(inner, op.nonzero_columns))


def _interior_probe(sched: HaloSchedule):
    """CUDA events around the interior launches, when the schedule keeps
    timing records on the card: the exchange's record then says whether
    the interior kernels had started, and finished, by the time the wire
    finished, and how long they took (``interior_ms``)."""
    if sched.timings is None or not sched.on_card:
        return None
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _note_probe(sched: HaloSchedule, probe) -> None:
    if probe is not None:
        probe[1].synchronize()
        sched.timings[-1]["interior_ms"] = probe[0].elapsed_time(probe[1])


class _SplitSpmm(torch.autograd.Function):
    """The split-phase aggregation: ``[n_local, F]`` out, with the epilogue
    ``act(A_int·u + A_bnd·[u | ghost] + α·self + bias)`` where ``fused``
    (the fused kernel on both streams, the masked kernel on the boundary
    Aᵀ under a ReLU), else the plain ``A_int·u + A_bnd·[u | ghost]``."""

    @staticmethod
    def forward(ctx, u, self_term, bias, alpha, ops, sched, slot, layer,
                inner, fused, activation):
        int_fwd, int_bwd, bnd_fwd, bnd_bwd = ops
        n = sched.n_local
        u32 = u.detach().float().contiguous()
        tr = sched.begin(u32, slot, layer)
        probe = _interior_probe(sched)
        if probe is not None:
            probe[0].record()
        if fused:
            y_int, _ = _fused(int_fwd, u32, self_term, bias, alpha, "none",
                              inner)
        else:
            y_int = _spmm(int_fwd, u32, inner)
        if probe is not None:
            probe[1].record()
        ghost = sched.finish(tr, probe)
        _note_probe(sched, probe)
        buf = torch.cat([u32, ghost])
        mask = None
        if fused:
            one = torch.ones(1, dtype=torch.float32, device=u.device)
            y, mask = _fused(bnd_fwd, buf, y_int, None, one, activation,
                             inner)
        else:
            y = _spmm(bnd_fwd, buf, inner) + y_int
        ctx.save_for_backward(mask, self_term, alpha)
        ctx.ops, ctx.sched, ctx.slot, ctx.layer = ops, sched, slot, layer
        ctx.inner, ctx.fused = inner, fused
        ctx.bias_shape = None if bias is None else bias.shape
        return y[:n]

    @staticmethod
    def backward(ctx, dy):
        mask, self_term, alpha = ctx.saved_tensors
        int_fwd, int_bwd, bnd_fwd, bnd_bwd = ctx.ops
        sched, inner = ctx.sched, ctx.inner
        n, g = sched.n_local, sched.n_ghost
        dy = dy.float().contiguous()
        dz = dy if mask is None else dy * _fit(mask, n)
        # the boundary stream first: its ghost rows go back to their owners
        if mask is not None:
            dbuf = _masked(bnd_bwd, dy, mask, inner)
        else:
            dbuf = _spmm(bnd_bwd, dy, inner)
        tr = sched.begin_transpose(dbuf[n:n + g].contiguous(), ctx.slot,
                                   ctx.layer)
        # the interior Aᵀ product runs while the ghost gradients travel
        probe = _interior_probe(sched)
        if probe is not None:
            probe[0].record()
        du = _spmm(int_bwd, dz, inner)[:n]
        if probe is not None:
            probe[1].record()
        du = du + dbuf[:n]
        du = du + sched.finish(tr, probe)
        _note_probe(sched, probe)
        dself = dbias = dalpha = None
        need_self, need_bias, need_alpha = ctx.needs_input_grad[1:4]
        if need_self:
            dself = alpha * dz
        if need_alpha:
            dalpha = (dz * self_term).sum().reshape(alpha.shape)
        if need_bias:
            dbias = dz.sum(dim=0).reshape(ctx.bias_shape)
        return (du, dself, dbias, dalpha, None, None, None, None, None, None,
                None)


class _SplitAttention(torch.autograd.Function):
    """The split-phase fused attention: the interior stream over the local
    rows while the exchange is in flight, the boundary stream over
    ``[local | ghost]``; ``out_int + out_bnd`` (each destination's row is
    finished in one stream and exactly 0 in the other)."""

    @staticmethod
    def forward(ctx, z, a_src, a_dst, ops, sched, slot, layer, inner, heads):
        int_fwd, int_bwd, bnd_fwd, bnd_bwd = ops
        n, g = sched.n_local, sched.n_ghost
        z32 = z.detach().float().contiguous()
        hd = z32.shape[1]
        dh = hd // heads
        tr = sched.begin(z32, slot, layer)
        probe = _interior_probe(sched)
        if probe is not None:
            probe[0].record()
        geom_i = (n, n, int_fwd.n_rows_padded, int_fwd.n_cols_padded,
                  int_bwd.n_rows_padded, int_bwd.n_cols_padded)
        z3 = z32.reshape(n, heads, dh)
        res_i = kops.mha_forward(int_fwd, z3, a_src, a_dst, geom_i, inner)
        if probe is not None:
            probe[1].record()
        ghost = sched.finish(tr, probe)
        _note_probe(sched, probe)
        buf = torch.cat([z32, ghost]).reshape(n + g, heads, dh)
        geom_b = (n, n + g, bnd_fwd.n_rows_padded, bnd_fwd.n_cols_padded,
                  bnd_bwd.n_rows_padded, bnd_bwd.n_cols_padded)
        res_b = kops.mha_forward(bnd_fwd, buf, a_src, a_dst, geom_b, inner)
        ctx.save_for_backward(z3, buf, a_src, a_dst, *res_i, *res_b)
        ctx.ops, ctx.sched, ctx.slot, ctx.layer = ops, sched, slot, layer
        ctx.inner, ctx.geoms = inner, (geom_i, geom_b)
        return (res_i[0] + res_b[0]).to(z.dtype)

    @staticmethod
    def backward(ctx, dy):
        z3, buf, a_src, a_dst, *res = ctx.saved_tensors
        res_i, res_b = res[:5], res[5:]
        int_fwd, int_bwd, bnd_fwd, bnd_bwd = ctx.ops
        sched, inner = ctx.sched, ctx.inner
        geom_i, geom_b = ctx.geoms
        n, g = sched.n_local, sched.n_ghost
        dzb, dsb, ddb = kops.mha_backward(bnd_fwd, bnd_bwd, geom_b, inner,
                                          buf, a_src, a_dst, *res_b, dy)
        tr = sched.begin_transpose(dzb[n:].reshape(g, -1).contiguous(),
                                   ctx.slot, ctx.layer)
        # the interior passes run while the ghost gradients travel
        probe = _interior_probe(sched)
        if probe is not None:
            probe[0].record()
        dzi, dsi, ddi = kops.mha_backward(int_fwd, int_bwd, geom_i, inner,
                                          z3, a_src, a_dst, *res_i, dy)
        if probe is not None:
            probe[1].record()
        dz = (dzi + dzb[:n]).reshape(n, -1) + sched.finish(tr, probe)
        _note_probe(sched, probe)
        return (dz, (dsi + dsb).to(a_src.dtype), (ddi + ddb).to(a_dst.dtype),
                None, None, None, None, None, None)


class DistributedBackend(Backend):
    """Halo-exchange compositions of the local primitives (the MPI
    analog). Never selected for a single-device lowering;
    ``lower_distributed`` asks for it by name. ``slot`` is the layer's
    ``GhostBufferRing`` slot and ``layer`` labels its exchanges' timing
    records."""

    name = "distributed"

    def __init__(self, inner: Optional[str] = None):
        self._inner = inner

    def inner(self) -> str:
        """The local executor: the Hopper kernels on a machine with a card,
        their plain versions elsewhere (the JAX package's Pallas-on-TPU,
        XLA-elsewhere rule)."""
        if self._inner is not None:
            return self._inner
        return "cuda" if torch.cuda.is_available() else "torch"

    # -- the distributed op vocabulary --------------------------------------

    def dist_spmm(self, fwd: BSRDevice, bwd: BSRDevice, u: torch.Tensor,
                  sched: HaloSchedule, *, slot: int = 0,
                  layer: Optional[int] = None) -> torch.Tensor:
        """One-shot ``Y = A_local @ [u | halo(u)]``."""
        return self.dist_spmm_transposed_vjp(fwd, bwd, sched, slot=slot,
                                             layer=layer)(u)

    def _with_ghosts(self, sched, slot, layer):
        def buf(u):
            return torch.cat([u.float(), halo_exchange(u, sched, slot, layer)])

        return buf

    def dist_spmm_transposed_vjp(self, fwd: BSRDevice, bwd: BSRDevice,
                                 sched: HaloSchedule, *, slot: int = 0,
                                 layer: Optional[int] = None) -> Callable:
        """Differentiable ``u -> A_local @ [u | halo(u)]``: dbuf = A_localᵀ
        @ dY, the ghost rows' part returned through the reverse exchange."""
        from repro_torch.backends import get_backend

        mm = get_backend(self.inner()).spmm_transposed_vjp(fwd, bwd)
        with_ghosts = self._with_ghosts(sched, slot, layer)

        def agg(u):
            return mm(with_ghosts(u))

        return agg

    def dist_spmm_fused_epilogue(self, fwd: BSRDevice, bwd: BSRDevice,
                                 sched: HaloSchedule, *, slot: int = 0,
                                 layer: Optional[int] = None) -> Callable:
        """``(u, self_term, bias, alpha, activation) -> act(A_local @ [u |
        halo(u)] + alpha * self_term + bias)``: the fused kernel over the
        bulk operand (self term and bias are rank-local rows)."""
        fused_buf = kops.build_fused_epilogue(fwd, bwd, self.inner())
        with_ghosts = self._with_ghosts(sched, slot, layer)

        def fused(u, self_term=None, bias=None, alpha=None, activation="none"):
            return fused_buf(with_ghosts(u), self_term, bias, alpha, activation)

        return fused

    def _split_ops(self, int_fwd, int_bwd, bnd_fwd, bnd_bwd) -> tuple:
        ops = (int_fwd, int_bwd, bnd_fwd, bnd_bwd)
        if self.inner() == "cuda":  # the column streams, once, at bind time
            for op in ops:
                op.nonzero_columns()
        return ops

    def dist_spmm_split_transposed_vjp(
            self, int_fwd: BSRDevice, int_bwd: BSRDevice, bnd_fwd: BSRDevice,
            bnd_bwd: BSRDevice, sched: HaloSchedule, *, slot: int = 0,
            layer: Optional[int] = None) -> Callable:
        """Split-phase ``u -> A_int @ u + A_bnd @ [u | halo(u)]``: the
        interior product launched between posting the exchange and waiting
        for it, both ways."""
        ops = self._split_ops(int_fwd, int_bwd, bnd_fwd, bnd_bwd)
        inner = self.inner()

        def agg(u):
            return _SplitSpmm.apply(u, None, None, None, ops, sched, slot,
                                    layer, inner, False, "none")

        return agg

    def dist_spmm_fused_epilogue_split(
            self, int_fwd: BSRDevice, int_bwd: BSRDevice, bnd_fwd: BSRDevice,
            bnd_bwd: BSRDevice, sched: HaloSchedule, *, slot: int = 0,
            layer: Optional[int] = None) -> Callable:
        """The fused-epilogue form of the split-phase aggregation: the
        epilogue lands on the stitched ``y_int + y_bnd``."""
        ops = self._split_ops(int_fwd, int_bwd, bnd_fwd, bnd_bwd)
        inner = self.inner()

        def fused(u, self_term=None, bias=None, alpha=None, activation="none"):
            s = a = None
            if self_term is not None:
                s = self_term.float().contiguous()
                a = (torch.ones(1, dtype=torch.float32, device=u.device)
                     if alpha is None else
                     torch.as_tensor(alpha, dtype=torch.float32,
                                     device=u.device).reshape(1))
            b = None if bias is None else bias.float().contiguous()
            return _SplitSpmm.apply(u, s, b, a, ops, sched, slot, layer,
                                    inner, True, activation)

        return fused

    def dist_feature_matmul_sparse(self, feat_fwd: BSRDevice,
                                   feat_bwd: BSRDevice) -> Callable:
        """Differentiable ``w -> X_local @ w`` over the rank's BSR(X_local)
        and BSR(X_localᵀ); dW = X_localᵀ @ dY, summed over the ranks with
        the other weight gradients (X rows are disjoint across ranks)."""
        from repro_torch.backends import get_backend

        return get_backend(self.inner()).spmm_transposed_vjp(feat_fwd, feat_bwd)

    def dist_segment_softmax_aggregate(self, z_buf, a_src, a_dst, src, dst,
                                       n_local: int) -> torch.Tensor:
        """GAT edge softmax over the ``[local | ghost]`` buffer ``[n_buf, H,
        Dh]``: every destination's in-edges live on its owner, so the
        softmax is complete on the rank; -1 padded edges contribute
        nothing."""
        return edge_softmax_aggregate(z_buf, a_src, a_dst, src, dst,
                                      n_local, valid=src >= 0)

    def dist_spmm_attention(self, fwd: BSRDevice, bwd: BSRDevice,
                            sched: HaloSchedule, *, slot: int = 0,
                            layer: Optional[int] = None) -> Callable:
        """Fused attention over ``[local | ghost]``: ``(z [n_local, H*Dh],
        a_src, a_dst, heads) -> [n_local, H, Dh]``; the ghost rows'
        gradients return through the reverse exchange."""
        mha = kops.build_sparse_mha(fwd, bwd, self.inner())
        with_ghosts = self._with_ghosts(sched, slot, layer)

        def attention(z, a_src, a_dst, heads):
            buf = with_ghosts(z)
            return mha(buf.reshape(buf.shape[0], heads, -1), a_src, a_dst)

        return attention

    def dist_spmm_attention_split(
            self, int_fwd: BSRDevice, int_bwd: BSRDevice, bnd_fwd: BSRDevice,
            bnd_bwd: BSRDevice, sched: HaloSchedule, *, slot: int = 0,
            layer: Optional[int] = None) -> Callable:
        """Split-phase fused attention (DESIGN.md §11)."""
        ops = self._split_ops(int_fwd, int_bwd, bnd_fwd, bnd_bwd)
        inner = self.inner()

        def attention(z, a_src, a_dst, heads):
            return _SplitAttention.apply(z, a_src, a_dst, ops, sched, slot,
                                         layer, inner, heads)

        return attention

    def dist_segment_max(self, buf: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor, n_local: int) -> torch.Tensor:
        """Max aggregation over the rank's edge list. Rows without an edge
        (padding slots) give 0, not -inf, so padding never poisons the
        backward with NaNs; their gradient is 0."""
        valid = src >= 0
        src_c = torch.where(valid, src, 0).long()
        seg = torch.where(valid, dst, n_local).long()
        msgs = torch.where(valid[:, None], buf[src_c], -torch.inf)
        out = torch.full((n_local + 1, buf.shape[1]), -torch.inf,
                         dtype=buf.dtype, device=buf.device)
        out = out.scatter_reduce(0, seg[:, None].expand_as(msgs), msgs,
                                 "amax", include_self=False)
        return torch.where(torch.isfinite(out), out, 0.0)[:n_local]


def debug_halo_check(dist, features=None, *, device=None) -> None:
    """Debug-mode runtime guard (DESIGN.md §14), called in every rank of
    the group: one real exchange of ``features`` (the rank's rows of
    ``dist.features`` by default) with its transit checksum; raises
    ``RuntimeError`` on every rank when the rows shipped and the rows
    received into valid ghost slots disagree. Both sides sum the same
    float32 terms grouped differently, so the tolerance grows with the
    square root of the term count and with the checksum's size, as in the
    JAX package."""
    import numpy as np

    from repro_torch import resolve_device

    dev = resolve_device(device)
    sched = HaloSchedule.of(dist, device=dev)
    i = 0 if dist.rank is not None else sched.rank
    x = torch.as_tensor(np.asarray(
        dist.features[i] if features is None else features,
        dtype=np.float32), device=dev)
    _, shipped, received = halo_exchange_debug(x, sched)
    s, r = float(shipped), float(received)
    n_terms = max(len(sched.shifts), 1) * sched.max_send * x.shape[-1]
    tol = max(64.0 * float(np.finfo(np.float32).eps) * np.sqrt(n_terms)
              * max(abs(s), abs(r)), 1e-5)
    if abs(s - r) > tol:
        raise RuntimeError(
            f"halo-exchange checksum mismatch: shipped {s:.6g} != "
            f"received {r:.6g} — ghost rows were lost, duplicated, or "
            f"corrupted in transit (send/recv schedule desync?)")
