"""Sharding rules: logical-axis → mesh-axis mapping for all architectures.

Counterpart of ``repro/distributed/sharding.py``, copied: the same
branches, the same name lists, the same specs. Megatron-style tensor
parallel over the ``model`` axis, data parallel over (``pod``, ``data``).
A dimension is sharded only when divisible by the mesh axis (e.g.
whisper's 6 heads stay replicated on a 16-way model axis while its
d_ff=1536 shards cleanly).

A ``Spec`` (a tuple of axis names, tuples of them, or ``None``, one
entry a dimension) takes ``PartitionSpec``'s place, and the rules take
any mesh with ``axis_names`` and a ``shape`` mapping (axis name → size):
``launch/mesh.py:Mesh`` for the port's ranks, or the JAX package's
meshes in the tests. GSPMD inserted the JAX package's collectives from
these specs; the port's layers place their own where a rule context is
active (``distributed/tensor_parallel.py``), and without one place none,
so one-card programs are unchanged. ``shard_activation`` keeps the JAX
package's sites and kinds as markers that return ``x``.
"""
from __future__ import annotations

import contextlib
import types
from typing import Optional

import numpy as np
import torch

from repro_torch.runtime.checkpoint import _flatten_with_paths, _unflatten

#: the active rules, for the whole process and not a thread: autograd runs
#: a CUDA backward, and with it the forward of a layer that ``remat``
#: recomputes, on a thread of its own, which must place the same
#: collectives (the JAX package reads its rules only while tracing)
_ctx = types.SimpleNamespace(rules=None)


class Spec(tuple):
    """``PartitionSpec``'s counterpart: one entry a dimension, each an
    axis name, a tuple of axis names, or ``None`` (replicated); a tuple of
    one name is that name, as ``PartitionSpec`` normalises it."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1
                                     else a for a in axes))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


P = Spec


def current_rules() -> Optional["ShardingRules"]:
    return _ctx.rules


@contextlib.contextmanager
def use_rules(rules: Optional["ShardingRules"]):
    prev = current_rules()
    _ctx.rules = rules
    try:
        yield
    finally:
        _ctx.rules = prev


def shard_activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` itself: a marker at the JAX package's sites, with its kinds.
    The layer that makes ``x`` has placed the collectives its kind implies
    under the active rules (``distributed/tensor_parallel.py``), so nothing
    moves here."""
    return x


class ShardingRules:
    """Derives parameter/activation specs for one (config, mesh).

    ``fsdp=True`` additionally shards every parameter's largest free dim
    over the data axes (ZeRO-3 semantics: params all-gathered per use,
    gradients reduce-scattered; the port's runtime is
    ``distributed/fsdp.py``).
    """

    def __init__(self, mesh, cfg=None, batch_axes=("pod", "data"),
                 fsdp: bool = False, expert_parallel_2d: bool = False):
        self.mesh = mesh
        self.cfg = cfg
        self.fsdp = fsdp
        self.expert_parallel_2d = expert_parallel_2d
        self.batch_axes = tuple(a for a in batch_axes if a in mesh.axis_names)
        self.model_axis = "model" if "model" in mesh.axis_names else None
        self.model_size = mesh.shape["model"] if self.model_axis else 1
        self.data_size = int(np.prod([mesh.shape[a] for a in self.batch_axes])) \
            if self.batch_axes else 1

    # -- helpers ------------------------------------------------------------

    def _model_if_divisible(self, dim: int):
        if self.model_axis and dim % self.model_size == 0 and dim >= self.model_size:
            return self.model_axis
        return None

    def batch_spec(self, global_batch: int):
        """Batch axis mapping; falls back to replication for tiny batches."""
        if self.data_size > 1 and global_batch % self.data_size == 0:
            return self.batch_axes
        return None

    # -- parameters ----------------------------------------------------------

    def _shard_dim(self, shape: tuple, dim_from_end: int) -> Spec:
        """Shard the dim_from_end-th dim (1-indexed from the right) over the
        model axis if divisible; scanned stacks just add leading Nones."""
        n = len(shape)
        idx = n - dim_from_end
        if idx < 0:
            return P(*([None] * n))
        axes = [None] * n
        axes[idx] = self._model_if_divisible(shape[idx])
        return P(*axes)

    # parameter-name → which dim (from the right) carries tensor parallelism
    _COL_SHARDED = ("wq", "wk", "wv", "wq_b", "wkv_b", "w_in", "w_ff_in",
                    "w_gate", "w_up", "conv_w")  # shard output/channel dim
    _ROW_SHARDED = ("wo", "w_out", "w_ff_out", "w_down")  # shard input dim
    _EXPERT_SHARDED = ("we_gate", "we_up", "we_down")  # shard expert dim
    _REPLICATED = ("wq_a", "wkv_a", "router", "a_log", "dt_bias", "d_skip",
                   "skip", "scale", "bias")

    def param_spec(self, path: str, shape: tuple) -> Spec:
        """Map a parameter (by tree path + shape) to a spec."""
        last = path.split("/")[-1]
        if last == "table" and len(shape) == 2:  # embed/unembed: vocab dim
            spec = P(self._model_if_divisible(shape[0]), None)
        elif len(shape) <= 1:
            spec = P(*([None] * len(shape)))
        elif last in self._EXPERT_SHARDED:
            # 2D expert parallelism: spread experts over (batch_axes ×
            # model) so expert weights are fully resident — tokens move
            # (all-to-all), weights don't. On the multi-pod mesh, fall
            # back to (data × model) without the pod axis when E only
            # covers one pod's chips.
            if self.expert_parallel_2d:
                for ep_axes in ((*self.batch_axes, self.model_axis),
                                ("data", self.model_axis)):
                    if not all(a in self.mesh.axis_names for a in ep_axes
                               if a is not None):
                        continue
                    n_all = int(np.prod([self.mesh.shape[a]
                                         for a in ep_axes if a]))
                    if shape[-3] % n_all == 0:
                        n = len(shape)
                        axes = [None] * n
                        axes[n - 3] = ep_axes
                        return P(*axes)  # no extra FSDP axis on experts
            spec = self._shard_dim(shape, 3)
        elif last in self._COL_SHARDED:
            spec = self._shard_dim(shape, 1)
        elif last in self._ROW_SHARDED:
            spec = self._shard_dim(shape, 2)
        else:
            spec = P(*([None] * len(shape)))
        if self.fsdp and len(shape) >= 2:
            spec = self._add_fsdp_axis(spec, shape)
        return spec

    def _add_fsdp_axis(self, spec: Spec, shape: tuple) -> Spec:
        """Shard the largest still-free dim over the data axes (ZeRO-3)."""
        n = int(np.prod([self.mesh.shape[a] for a in self.batch_axes]))
        if n <= 1:
            return spec
        axes = list(spec) + [None] * (len(shape) - len(spec))
        best, best_size = None, 0
        for i, (dim, ax) in enumerate(zip(shape, axes)):
            if ax is None and dim % n == 0 and dim > best_size:
                best, best_size = i, dim
        if best is None:
            return spec
        axes[best] = self.batch_axes if len(self.batch_axes) > 1 \
            else self.batch_axes[0]
        return P(*axes)

    def tree_param_specs(self, tree):
        """The tree's spec a tensor leaf (any leaf with a ``shape``);
        other leaves map to ``None``."""
        return _unflatten(tree, [self.param_spec(path, tuple(leaf.shape))
                                 if hasattr(leaf, "shape") else None
                                 for path, leaf in _flatten_with_paths(tree)])

    # -- KV / state caches -----------------------------------------------------

    def cache_spec(self, path: str, shape: tuple, long_context: bool = False,
                   global_batch: int = 1) -> Spec:
        """Decode-cache sharding. Normal mode: batch over (pod, data), KV
        heads over model when divisible. Long-context mode (batch smaller
        than the data axis): shard the *sequence* dim of attention caches
        over 'data' (context parallelism)."""
        last = path.split("/")[-1]
        b = self.batch_spec(global_batch)
        n = len(shape)

        def at(dim_from_end, axis):
            axes = [None] * n
            idx = n - dim_from_end
            if 0 <= idx < n and axis is not None:
                axes[idx] = axis
            return axes

        if last in ("k", "v"):  # [..., B, S, KV, Dh]
            axes = at(2, self._model_if_divisible(shape[-2]))
            if long_context and "data" in self.mesh.axis_names \
                    and shape[-3] % self.mesh.shape["data"] == 0:
                axes[n - 3] = "data"
            elif b is not None and n >= 4:
                axes[n - 4] = b
            if axes[n - 2] is None and self.model_axis \
                    and shape[-3] % self.model_size == 0:
                # too few KV heads for the model axis: shard the sequence
                # dim instead (ring-attention-style cache layout)
                axes[n - 3] = self.model_axis
            return P(*axes)
        if last == "latent":  # [..., B, S, R]
            axes = [None] * n
            if long_context and "data" in self.mesh.axis_names \
                    and shape[-2] % self.mesh.shape["data"] == 0:
                axes[n - 2] = "data"
            else:
                if b is not None and n >= 3:
                    axes[n - 3] = b
                if self.model_axis and shape[-2] % self.model_size == 0:
                    axes[n - 2] = self.model_axis  # MLA: shard cache seq
            return P(*axes)
        if last == "state":  # [..., B, H, P, N]
            axes = at(3, self._model_if_divisible(shape[-3]))
            if b is not None and n >= 4:
                axes[n - 4] = b
            return P(*axes)
        if last == "conv":  # [..., B, W-1, C]
            axes = at(1, self._model_if_divisible(shape[-1]))
            if b is not None and n >= 3:
                axes[n - 3] = b
            return P(*axes)
        if last == "C":  # mlstm [..., B, H, Dk, Dv]
            axes = at(2, self._model_if_divisible(shape[-2]))
            if b is not None and n >= 4:
                axes[n - 4] = b
            return P(*axes)
        if last in ("n", "h", "c"):  # [..., B, H, Dh]
            axes = at(1, self._model_if_divisible(shape[-1]))
            if b is not None and n >= 3:
                axes[n - 3] = b
            return P(*axes)
        if last == "enc_out":  # [B, S, D]
            return P(b, None, None) if n == 3 else P(*([None] * n))
        return P(*([None] * n))

    def tree_cache_specs(self, tree, long_context: bool = False,
                         global_batch: int = 1):
        """The cache tree's spec a tensor leaf; the host index ``idx`` (a
        Python int in the port) maps to ``None``."""
        return _unflatten(tree, [self.cache_spec(path, tuple(leaf.shape), long_context,
                                                 global_batch)
                                 if hasattr(leaf, "shape") else None
                                 for path, leaf in _flatten_with_paths(tree)])

    # -- activations ----------------------------------------------------------

    def activation_spec(self, kind: str, ndim: int) -> Optional[Spec]:
        b = self.batch_axes if self.batch_axes else None
        m = self.model_axis
        if kind == "tokens_bsd":  # [B, S, D]
            return P(b, None, None)
        if kind == "ffn_hidden":  # [B, S, F] or [T, F]
            if ndim == 3:
                return P(b, None, m)
            return P(b, m)
        if kind == "attn_heads":  # [B, S, H, Dh]
            return P(b, None, m, None)
        if kind == "logits":  # [B, S, V]
            return P(b, None, m)
        if kind == "moe_expert":  # [E, C, D]
            if self.expert_parallel_2d and self.cfg is not None \
                    and self.cfg.moe is not None:
                e = self.cfg.moe.n_experts
                for ep_axes in ((*self.batch_axes, m), ("data", m)):
                    if not all(a in self.mesh.axis_names for a in ep_axes
                               if a is not None):
                        continue
                    n_all = int(np.prod([self.mesh.shape[a]
                                         for a in ep_axes if a]))
                    if e % n_all == 0:
                        return P(ep_axes, None, None)
            return P(m, b, None)
        if kind == "kv_cache_seq":  # [B, S, KV, Dh] long-context: shard S
            return P(None, "data", None, None)
        return None
