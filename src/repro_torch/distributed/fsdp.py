"""FSDP over the mesh's ``data`` axis: the runtime of ``ShardingRules
(fsdp=True)``.

Counterpart of the JAX package's ``_add_fsdp_axis``
(``repro/distributed/sharding.py``) under GSPMD's ZeRO-3 semantics. The
rules put each parameter's largest free dimension over the data axes; a
rank holds that shard of the leaf, and of its AdamW state, and

- a leaf is all-gathered over ``data`` at its use, a layer at a time:
  ``models/transformer.py:LM._run_segments`` gathers a layer's leaves
  inside the layer's ``checkpoint``, so ``remat`` recomputes the gather in
  the backward and no gathered weight outlives its layer (gathering the
  stacked ``[L, ...]`` leaf at once would put the whole model on every
  rank); the embedding and the head are gathered where they are read;
- the gather's backward is a reduce-scatter over ``data``: the gradient
  summed over the data ranks in float32 and the rank's chunk taken
  (``tensor_parallel._reduce_scatter``, an all-reduce and the chunk over
  gloo, which has no reduce-scatter); ``data_mean`` divides it by the data
  size, the convention of ``mean_over_data``, which the leaves without a
  data axis still take;
- the optimizer steps the rank's shards (one ``fused_adam`` launch a
  rank a step); in serving the weights are gathered a layer at a time and
  nothing is reduced;
- under 2D expert parallelism the experts lie over ``(data, model)``
  and stay resident (``expert_leaves``): no gather, and their gradients,
  which the tokens' all-to-all already brought every data rank's share
  of, are divided by the data size alone (``data_mean``), with or without
  FSDP.

Where the rules put the data axis on a scanned segment's stacked layer
axis (a leaf whose other dimensions are all sharded or do not divide),
layer ``r`` lives whole on one data rank: it is broadcast from that rank
(``LayerSlice``), and its gradient summed back to it.

The specs come from the parameters' full shapes, drawn once a model and
rules under ``FakeTensorMode`` (``_full_shapes``): a rank holds only its
shards, whose shapes do not say what the rules did. Without FSDP rules
(or on a data axis of one rank) nothing here runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.backends.registry import DIST_ITEM, not_ported
from repro_torch.distributed.sharding import ShardingRules, current_rules
from repro_torch.distributed.tensor_parallel import (
    _communicate,
    _reduce_scatter,
    _sum_dtype,
    mean_over_data,
)
from repro_torch.runtime.checkpoint import _flatten_with_paths


def _data_axis(entry, rules: ShardingRules) -> Optional[str]:
    """The data axis a spec entry names for FSDP (None where it names none,
    or names it beside ``model``: 2D expert parallelism's experts, which
    stay resident, no extra FSDP axis on them)."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    data = [a for a in axes if a in rules.batch_axes]
    if not data or (rules.model_axis is not None and rules.model_axis in axes):
        return None
    if len(axes) > 1:
        raise not_ported(f"FSDP over the axes {axes} at once", DIST_ITEM)
    return data[0]


def _full_shapes(model) -> dict:
    """path -> the whole parameter's shape, from ``model.init`` under
    ``FakeTensorMode`` (no values drawn; outside any dispatch mode on the
    stack, such as the dry run's ``StepCost``)."""
    with _disable_current_modes(), FakeTensorMode():
        tree = model.init(torch.Generator().manual_seed(0), device="cpu")
    return {path: tuple(t.shape) for path, t in _flatten_with_paths(tree)}


@dataclasses.dataclass
class Plan:
    """The rank's FSDP leaves: path -> (dimension, data axis) of the whole
    leaf's spec, for every leaf the rules shard over a data axis."""

    rules: ShardingRules
    dims: dict


def plan(model) -> Optional[Plan]:
    """The FSDP plan of ``model`` under the active rules (memoised on the
    model a rules layout); None where no leaf is sharded over data."""
    rules = current_rules()
    if rules is None or not rules.fsdp or rules.data_size == 1:
        return None
    key = (tuple(rules.mesh.shape.items()), rules.batch_axes, rules.expert_parallel_2d)
    memo = model.__dict__.setdefault("_fsdp_dims", {})
    if key not in memo:
        dims = {}
        for path, shape in _full_shapes(model).items():
            for d, entry in enumerate(rules.param_spec(path, shape)):
                axis = None if entry is None else _data_axis(entry, rules)
                if axis is not None:
                    dims[path] = (d, axis)
        memo[key] = dims
    return Plan(rules, memo[key])


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _scatter_grad(g: torch.Tensor, dim: int, axis: str, rules: ShardingRules):
    """The gather's backward: the rank's chunk of the gradient's sum over
    ``axis`` (a module-level name, so a planted control can replace it)."""
    return _reduce_scatter(g, axis, rules, dim=dim)


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, rules):
        ctx.dim, ctx.axis, ctx.rules = dim, axis, rules
        return _communicate("all-gather", x.contiguous(), axis, rules, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_grad(g, ctx.dim, ctx.axis, ctx.rules), None, None, None


def gather_data(x: torch.Tensor, dim: int, axis: str, rules: ShardingRules):
    """The data ranks' shards of a leaf concatenated along ``dim``, in rank
    order; the gradient reduce-scattered back."""
    return _GatherData.apply(x, dim, axis, rules)


@dataclasses.dataclass
class LayerSlice:
    """Layer ``index`` of a stacked leaf sharded over data on its layer
    axis: row ``index % len(stack)`` of the stack held by data rank
    ``index // len(stack)``."""

    stack: torch.Tensor
    index: int
    axis: str


class _BroadcastLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stack, index, axis, rules):
        per = stack.shape[0]
        owner, row = divmod(index, per)
        ctx.meta = (stack.shape, stack.dtype, owner, row, axis, rules)
        mine = rules.mesh.coords[axis] == owner
        out = stack[row].clone() if mine else stack.new_empty(stack.shape[1:])
        return _communicate("broadcast", out, axis, rules, root=owner)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, owner, row, axis, rules = ctx.meta
        buf = g.to(_sum_dtype(g.dtype), copy=True).contiguous()
        total = _communicate("reduce", buf, axis, rules, root=owner)
        grad = g.new_zeros(shape, dtype=dtype)
        if rules.mesh.coords[axis] == owner:
            grad[row] = total.to(dtype)
        return grad, None, None, None


# ---------------------------------------------------------------------------
# the model's side
# ---------------------------------------------------------------------------

def _map(tree, fn, path: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)`` (paths as
    ``_flatten_with_paths`` writes them). Plain recursion: ``_unflatten``'s
    self-referencing closure would keep the new leaves, whole gathered
    layers among them, in a reference cycle until a garbage collection."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def unbind(tree, n: int, fsdp: Plan, prefix: str) -> list:
    """``transformer._unbind`` of a stacked segment's dict under ``fsdp``:
    ``n`` per-layer dicts of views, a leaf sharded over data on its layer
    axis a ``LayerSlice`` a layer."""
    parts = {}
    for path, leaf in _flatten_with_paths(tree):
        dim = fsdp.dims.get(f"{prefix}/{path}")
        parts[path] = ([LayerSlice(leaf, r, dim[1]) for r in range(n)]
                       if dim is not None and dim[0] == 0 else torch.unbind(leaf))
    return [_map(tree, lambda path, _, r=r: parts[path][r]) for r in range(n)]


def gather(tree, fsdp: Optional[Plan], prefix: str, stacked: bool = False):
    """``tree`` (the leaves at ``prefix``; one layer of a stacked segment
    where ``stacked``) with each data-sharded leaf gathered whole over
    ``data``; itself without a plan."""
    if fsdp is None:
        return tree

    def one(path, leaf):
        if isinstance(leaf, LayerSlice):
            return _BroadcastLayer.apply(leaf.stack, leaf.index, leaf.axis, fsdp.rules)
        dim = fsdp.dims.get(f"{prefix}/{path}")
        return leaf if dim is None else gather_data(leaf, dim[0] - stacked, dim[1], fsdp.rules)

    return _map(tree, one)


def expert_leaves(model) -> frozenset:
    """The paths of the leaves whose experts the active rules spread over
    ``data`` (2D expert parallelism: each data rank holds other experts),
    memoised on the model a rules layout; empty without a data axis."""
    rules = current_rules()
    if rules is None or rules.data_size == 1 or not rules.expert_parallel_2d:
        return frozenset()
    key = (tuple(rules.mesh.shape.items()), rules.batch_axes)
    memo = model.__dict__.setdefault("_expert_leaves", {})
    if key not in memo:
        out = set()
        for path, shape in _full_shapes(model).items():
            for entry in rules.param_spec(path, shape):
                axes = entry if isinstance(entry, tuple) else (entry,)
                if rules.model_axis in axes and set(axes) & set(rules.batch_axes):
                    out.add(path)
        memo[key] = frozenset(out)
    return memo[key]


def data_mean(model, params, grads: list) -> list:
    """Each gradient leaf's mean over the data ranks: an FSDP leaf's
    reduce-scattered sum divided by the data size, and so an expert leaf
    spread over ``data`` (its gradient already holds every data rank's
    tokens, through the all-to-all's backward; a mean over ``data`` would
    mix other experts' gradients into it), every other leaf by
    ``mean_over_data`` (``grads`` in ``tree_leaves(params)`` order)."""
    fsdp = plan(model)
    divided = set(expert_leaves(model)) | (set(fsdp.dims) if fsdp is not None else set())
    if not divided:
        return mean_over_data(grads)
    sharded = [path in divided for path, _ in _flatten_with_paths(params)]
    rest = iter(mean_over_data([g for g, s in zip(grads, sharded) if not s]))
    n = current_rules().data_size
    return [g / n if s else next(rest) for g, s in zip(grads, sharded)]

