"""Tensor parallelism over the mesh's ``model`` axis, data parallelism over
``data``: the collectives the port places where GSPMD placed the JAX
package's, and the placement of a tree on a mesh.

Megatron-style, on the rules of ``distributed/sharding.py``:

- ``copy_to_model``: identity forward, all-reduce of the gradient over
  ``model`` backward. The input of every column-sharded product passes it
  (``wq``/``wk``/``wv``, ``w_gate``/``w_up``, the unembedding).
- ``reduce_from_model``: all-reduce over ``model`` forward, identity
  backward. The output of every row-sharded product passes it (``wo``,
  ``w_down``), and so do the vocabulary-sharded lookup and the cross
  entropy's sums.
- ``gather_from_model``: all-gather on the last axis forward, the rank's
  slice backward: the logits that ``forward``, ``prefill`` and
  ``decode_step`` return, whole on every rank.
- ``gather_model_cols``: all-gather on the last axis forward,
  reduce-scatter backward: the query, key or value columns of heads
  that the ``model`` axis splits below one head, gathered before RoPE
  and the softmax, which need a head's whole ``Dh``; each rank then uses
  them differently, so their gradient is summed over ``model``.
- ``mean_over_data``: each gradient leaf all-reduced over ``data`` and
  divided by its size, between ``torch.autograd.grad`` and
  ``opt.update``. A data rank's loss (``sharded_ce``) is its labels' sum
  over the whole batch's label count (all-reduced over ``data``) times
  the data size, so the mean over the data ranks is the whole batch's
  mean, as the one-device program takes it, however the labels fall.
- ``all_to_all_data``: block ``j`` of ``[n, ...]`` to data rank ``j``,
  block ``i`` of the result from data rank ``i``; its backward is the
  same exchange of the gradient. The mixture of experts moves its tokens'
  rows to the data ranks that hold their experts with it
  (``models/moe.py``); ``gather_data_rows`` (all-gather on the first
  axis, reduce-scatter back), ``scatter_data_rows`` (its transpose) and
  ``sum_over_data`` (an all-reduce whose backward scales by the data
  size, for a quantity every data rank then uses whole) serve its
  routing and its load-balance loss.
- ``gather_model_positions``: all-gather on the positions' axis over
  ``model``, no gradient (serving): MLA's latent cache, which
  ``cache_spec`` splits by position over ``model`` (each rank writes the
  positions it owns), gathered whole before ``wkv_b`` rebuilds the
  rank's heads' keys and values from it. The latent is ``kv_lora_rank +
  qk_rope_head_dim`` wide (576 at deepseek-v3-671b's widths), so this
  moves ``B·S·576`` values a layer a call, where all-gathering ``wkv_b``
  (the other exact placement) would move its ``512 x 32,768`` a layer.

A dimension that the rules leave replicated (``d_ff``, the heads or the
padded vocabulary not divisible by ``model``) runs replicated: its
product takes no ``copy_to_model`` and no ``reduce_from_model``
(``model_sharded``). A replicated leaf used inside a sharded product
(the GELU MLP's ``b_in``, a replicated ``wk``/``wv`` beside sharded
heads) passes ``copy_to_model`` itself, so its gradient comes back whole
and equal on every model rank. FSDP (``distributed/fsdp.py``) adds the
all-gather over ``data`` and its reduce-scatter.

Every collective goes through ``_communicate``: it adds the operand's
bytes and kind to every active ``CollectiveLog`` (the counterpart of
``hlo_analysis.py``'s collective bytes, read by ``launch/step_cost.py``
and by the ranks), and where the mesh has no process groups (an abstract
mesh, the dry run's) it sends nothing and returns a shape-only result.
An axis of size 1 moves and logs nothing. Sums travel and add in float32
(float64 for float64 operands) and round to the operand's dtype once:
the gradients of bfloat16 products come back in bfloat16 after a float32
sum, and gloo's bfloat16 support is never relied on. The transport is
gloo (``launch/mesh.py``), whose all-gather takes host tensors: a CUDA
operand is staged through the host.

``check_tp`` refuses the families that have no runtime under the rules
yet (SSM and xLSTM layers), and an MLA whose heads a model axis would
split below one head, by ``registry.not_ported(..., DIST_ITEM)``;
nothing falls back to the unsharded program.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.backends.registry import DIST_ITEM, not_ported
from repro_torch.distributed.sharding import ShardingRules, current_rules
from repro_torch.runtime.checkpoint import _flatten_with_paths, _unflatten

def link_bytes(kind: str, nbytes: float, n: int) -> float:
    """The bytes a rank sends one way over its links for ``kind`` of an
    operand of ``nbytes`` among ``n`` ranks, by a ring: an all-reduce
    2(n-1)/n of the operand (reduce-scatter, then all-gather), a
    reduce-scatter (n-1)/n of it, an all-gather (n-1) times its operand,
    (n-1)/n of its output, a pipelined broadcast or reduce about the
    operand once, an all-to-all the (n-1)/n of its operand bound for the
    other ranks."""
    share = {"all-reduce": 2 * (n - 1) / n, "reduce-scatter": (n - 1) / n,
             "all-to-all": (n - 1) / n, "broadcast": 1.0, "reduce": 1.0}
    return nbytes * share.get(kind, n - 1)


class CollectiveLog:
    """The collectives a run placed while this log was active: their
    count and operand bytes by kind, the bytes a rank sends over its links
    for them (``link_bytes``, a ring's), and the host seconds spent inside
    the transport's calls (``seconds``: gloo's calls return once the data
    has arrived, a CUDA operand's copies to and from the host included)."""

    def __init__(self):
        self.counts: dict = defaultdict(int)
        self.bytes: dict = defaultdict(float)
        self.link_bytes = 0.0
        self.seconds = 0.0

    def add(self, kind: str, nbytes: int, seconds: float = 0.0, n: int = 1) -> None:
        self.counts[kind] += 1
        self.bytes[kind] += nbytes
        self.link_bytes += link_bytes(kind, nbytes, n)
        self.seconds += seconds

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes.values()))


#: the active logs, for the whole process (a CUDA backward runs on a
#: thread of its own: ``sharding._ctx``)
_logs: list = []


@contextlib.contextmanager
def logging_collectives(log: CollectiveLog):
    """Add every collective placed inside the block to ``log``."""
    _logs.append(log)
    try:
        yield log
    finally:
        _logs.remove(log)


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host, contiguous, 16-bit floats viewed as bytes (gloo
    moves their bits and is never asked to know bfloat16)."""
    host = t.detach().cpu().contiguous()
    return host.view(torch.uint8) if host.element_size() == 2 and host.is_floating_point() \
        else host


def _communicate(kind: str, t: torch.Tensor, axis: str, rules: ShardingRules,
                 op=tdist.ReduceOp.SUM, dim: int = -1, root: int = 0) -> torch.Tensor:
    """``kind`` of ``t`` over the mesh axis ``axis``: an all-reduce in
    place (``t`` returned), an all-gather along ``dim`` (a new tensor), a
    reduce-scatter along ``dim`` (the rank's chunk of the float32 or
    float64 sum, at ``t``'s dtype, a new tensor: gloo has no
    reduce-scatter, so ``t``'s chunks are summed on the host, each by a
    reduce to the rank that keeps it, and only the rank's chunk comes
    back, logged as the reduce-scatter the rules mean, with the
    transport's own host seconds and the bytes of the sum's dtype), an
    all-to-all of ``t``'s equal blocks along its first axis (a new tensor:
    block ``j`` sent to the axis's rank ``j``, block ``i`` received from
    rank ``i``, staged through the host), or a broadcast from (a sum to)
    the axis's rank ``root`` in place. Logged; shape-only where the mesh
    has no process groups (an all-gather of integers zeros, so that the
    indices it stands for stay in range)."""
    mesh = rules.mesh
    n = mesh.shape[axis]
    group = mesh.group(axis)
    dim = dim % max(t.dim(), 1)
    nbytes = t.numel() * t.element_size()
    t0 = time.perf_counter()
    if kind in ("broadcast", "reduce"):
        out = t
        if group is not None:
            host = _host(t)
            src = tdist.get_global_rank(group, root)
            if kind == "broadcast":
                tdist.broadcast(host, src, group=group)
            else:
                tdist.reduce(host, src, op=op, group=group)
            t.copy_(host.view(t.dtype))
    elif kind == "all-reduce":
        out = t
        if group is not None:
            tdist.all_reduce(t, op=op, group=group)
    elif kind == "reduce-scatter":
        # staged through the host whatever the device: the card holds no
        # float32 copy of the whole operand, and only the chunk comes back
        size = t.shape[dim] // n
        if group is None:
            out = t.new_empty((*t.shape[:dim], size, *t.shape[dim + 1:]))
        else:
            host = t.detach().cpu().to(_sum_dtype(t.dtype))
            chunks = [host.narrow(dim, j * size, size).contiguous() for j in range(n)]
            for j, chunk in enumerate(chunks):
                tdist.reduce(chunk, tdist.get_global_rank(group, j), op=op, group=group)
            out = chunks[mesh.coords[axis]].to(t.device, t.dtype)
        nbytes = t.numel() * torch.finfo(_sum_dtype(t.dtype)).bits // 8
    elif kind == "all-to-all":
        if group is None:
            out = t.new_empty(t.shape)
        else:
            host = _host(t)
            recv = torch.empty_like(host)
            tdist.all_to_all_single(recv, host, group=group)
            out = recv.view(t.dtype).to(t.device)
    elif group is None:
        shape = (*t.shape[:dim], n * t.shape[dim], *t.shape[dim + 1:])
        out = t.new_empty(shape) if t.is_floating_point() else t.new_zeros(shape)
    else:
        host = _host(t)
        parts = [torch.empty_like(host) for _ in range(n)]
        tdist.all_gather(parts, host, group=group)
        out = torch.cat(parts, dim=dim).view(t.dtype).to(t.device)
    seconds = time.perf_counter() - t0 if group is not None else 0.0
    for log in _logs:
        log.add(kind, nbytes, seconds, n)
    return out


def _all_reduce(t: torch.Tensor, axis: str, rules: ShardingRules) -> torch.Tensor:
    """The sum of ``t`` over ``axis`` in float32, rounded to ``t``'s dtype
    once (``t`` is not modified)."""
    buf = t.to(_sum_dtype(t.dtype), copy=True)
    return _communicate("all-reduce", buf, axis, rules).to(t.dtype)


def _reduce_scatter(t: torch.Tensor, axis: str, rules: ShardingRules,
                    dim: int = -1) -> torch.Tensor:
    """The rank's chunk along ``dim`` of the sum of ``t`` over ``axis``,
    summed in float32 and rounded to ``t``'s dtype once."""
    return _communicate("reduce-scatter", t, axis, rules, dim=dim)


def _model_rules() -> Optional[ShardingRules]:
    """The active rules where their ``model`` axis has more than one rank."""
    rules = current_rules()
    return rules if rules is not None and rules.model_size > 1 else None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules):
        ctx.rules = rules
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "model", ctx.rules), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules):
        return _all_reduce(x, "model", rules)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules):
        ctx.rules, ctx.width = rules, x.shape[-1]
        return _communicate("all-gather", x.contiguous(), "model", rules)

    @staticmethod
    def backward(ctx, g):
        m = ctx.rules.mesh.coords["model"]
        return g.narrow(-1, m * ctx.width, ctx.width).contiguous(), None


class _GatherModelCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules):
        ctx.rules = rules
        return _communicate("all-gather", x.contiguous(), "model", rules)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, "model", ctx.rules), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, all-reduce over ``model`` backward (``x`` without
    a model axis)."""
    rules = _model_rules()
    return x if rules is None else _CopyToModel.apply(x, rules)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model ranks' ``x`` forward, identity backward."""
    rules = _model_rules()
    return x if rules is None else _ReduceFromModel.apply(x, rules)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """The model ranks' ``x`` concatenated on the last axis, in rank
    order; the rank's slice of the gradient backward."""
    rules = _model_rules()
    return x if rules is None else _GatherFromModel.apply(x, rules)


def gather_model_cols(x: torch.Tensor) -> torch.Tensor:
    """The model ranks' ``x`` concatenated on the last axis, in rank
    order; the gradient summed over ``model`` and the rank's slice taken
    backward (a reduce-scatter), since each rank uses the whole
    differently."""
    rules = _model_rules()
    return x if rules is None else _GatherModelCols.apply(x, rules)


def _data_rules() -> Optional[ShardingRules]:
    """The active rules where their data axis has more than one rank."""
    rules = current_rules()
    return rules if rules is not None and rules.data_size > 1 else None


def _data_axis_of(rules: ShardingRules) -> str:
    return rules.batch_axes[-1]


class _AllToAllData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules):
        ctx.rules = rules
        return _communicate("all-to-all", x.contiguous(), _data_axis_of(rules), rules)

    @staticmethod
    def backward(ctx, g):
        return _communicate("all-to-all", g.contiguous(), _data_axis_of(ctx.rules),
                            ctx.rules), None


class _GatherDataRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules):
        ctx.rules = rules
        return _communicate("all-gather", x.contiguous(), _data_axis_of(rules), rules, dim=0)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, _data_axis_of(ctx.rules), ctx.rules, dim=0), None


class _ScatterDataRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules):
        ctx.rules = rules
        return _reduce_scatter(x.contiguous(), _data_axis_of(rules), rules, dim=0)

    @staticmethod
    def backward(ctx, g):
        return _communicate("all-gather", g.contiguous(), _data_axis_of(ctx.rules),
                            ctx.rules, dim=0), None


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rules):
        ctx.n = rules.data_size
        return _all_reduce(x, _data_axis_of(rules), rules)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None


def all_to_all_data(x: torch.Tensor) -> torch.Tensor:
    """``x`` [n, ...], n the data size: block ``j`` goes to data rank
    ``j``, and block ``i`` of the result came from data rank ``i``; the
    gradient goes back the same way. ``x`` itself without a data axis."""
    rules = _data_rules()
    return x if rules is None else _AllToAllData.apply(x, rules)


def gather_data_rows(x: torch.Tensor) -> torch.Tensor:
    """The data ranks' ``x`` concatenated on the first axis, in rank order;
    the gradient summed over ``data`` and the rank's rows taken backward.
    An integer ``x`` (no gradient) is gathered alike."""
    rules = _data_rules()
    if rules is None:
        return x
    if not x.is_floating_point():
        return _communicate("all-gather", x.contiguous(), _data_axis_of(rules), rules, dim=0)
    return _GatherDataRows.apply(x, rules)


def scatter_data_rows(x: torch.Tensor) -> torch.Tensor:
    """The rank's rows of the sum of the data ranks' ``x`` (float32, at
    ``x``'s dtype once); the gradient all-gathered backward."""
    rules = _data_rules()
    return x if rules is None else _ScatterDataRows.apply(x, rules)


def sum_over_data(x: torch.Tensor) -> torch.Tensor:
    """The data ranks' ``x`` summed (float32). Every data rank then uses
    the sum whole in a loss that ``mean_over_data`` averages, so each
    rank's gradient of its own ``x`` is the data size times the sum's
    (what an all-reduce of the identical gradients would give)."""
    rules = _data_rules()
    return x if rules is None else _SumOverData.apply(x, rules)


def mean_over_data(leaves: list) -> list:
    """Each tensor's mean over the ``data`` ranks (no gradient flows)."""
    rules = current_rules()
    if rules is None or rules.data_size == 1:
        return list(leaves)
    axis = rules.batch_axes[-1]
    return [_all_reduce(t, axis, rules) / rules.data_size for t in leaves]


def model_sharded(n: Optional[int]) -> bool:
    """Whether the active rules shard a dimension of ``n`` over a
    ``model`` axis of more than one rank (``ShardingRules._shard_dim``'s
    test); ``n`` None: whether such an axis is active at all. False
    without rules."""
    rules = _model_rules()
    return rules is not None and (n is None or rules._model_if_divisible(n) is not None)


def all_reduce_model(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The float32 (float64) ``op`` (``"sum"`` or ``"max"``) of ``t`` over
    the ``model`` ranks, no gradient: the partial softmaxes of a
    sequence-sharded cache (``models/attention.py``)."""
    rules = _model_rules()
    buf = t.detach().to(_sum_dtype(t.dtype), copy=True)
    if rules is None:
        return buf
    red = tdist.ReduceOp.MAX if op == "max" else tdist.ReduceOp.SUM
    return _communicate("all-reduce", buf, "model", rules, op=red)


def model_shard(n: int) -> int:
    """The rank's share of a dimension of ``n`` that the rules shard over
    ``model``: ``n / model`` where they shard it, else ``n``."""
    return n // _model_rules().model_size if model_sharded(n) else n


def model_coord() -> int:
    """The rank's index on the ``model`` axis (0 without one)."""
    rules = _model_rules()
    return 0 if rules is None else rules.mesh.coords["model"]


def latent_shards(s_max: int) -> int:
    """How many ways ``cache_spec`` splits MLA's latent cache's ``s_max``
    positions over ``model``: the axis size where the positions divide it
    (each rank then holds ``s_max / model`` of them), else 1."""
    rules = _model_rules()
    return 1 if rules is None or s_max % rules.model_size else rules.model_size


def gather_model_positions(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along ``dim`` in rank order (the
    ``model_coord``-th block of positions each), no gradient: a
    position-split cache made whole. ``x`` itself without a model axis."""
    rules = _model_rules()
    if rules is None:
        return x
    return _communicate("all-gather", x.detach().contiguous(), "model", rules, dim=dim)


def seq_shards(n_kv_heads: int, s_max: int) -> int:
    """How many ways ``cache_spec`` splits a K/V cache's ``s_max``
    positions over ``model``: where the KV heads do not divide the axis and
    the positions do (each rank then holds ``s_max / model`` positions of
    every KV head), the axis size; else 1."""
    rules = _model_rules()
    if rules is None or model_sharded(n_kv_heads) or s_max % rules.model_size:
        return 1
    return rules.model_size


# ---------------------------------------------------------------------------
# the vocabulary-sharded pieces
# ---------------------------------------------------------------------------

def _vocab_offset(local: int) -> int:
    rules = _model_rules()
    return 0 if rules is None else rules.mesh.coords["model"] * local


def embed_rows(table: torch.Tensor, tokens: torch.Tensor,
               vocab: Optional[int] = None) -> torch.Tensor:
    """The table's rows for ``tokens``, whole on every rank: over a
    vocabulary shard, the rows of the tokens the rank holds and zero for
    the others, summed over ``model`` (one rank adds each row, so the sum
    is exact). ``vocab``, the whole table's rows, tells a replicated table
    (not divisible by ``model``) from a shard; None: a shard under a
    ``model`` axis."""
    v = table.shape[0]
    off = _vocab_offset(v)
    if _model_rules() is None or v == vocab:
        return table[tokens]
    mine = (tokens >= off) & (tokens < off + v)
    rows = table[(tokens - off).clamp(0, v - 1)]
    return reduce_from_model(torch.where(mine[..., None], rows,
                                         torch.zeros((), dtype=rows.dtype, device=rows.device)))


def sharded_ce(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int):
    """``_masked_ce`` of a rank under the active rules, over its vocabulary
    shard of the logits [..., V / model]: the padded vocabulary at -1e30 at
    the logits' dtype, labels < 0 ignored, the log-softmax in float32 from
    the running max (all-reduced with MAX, no gradient: softmax is
    shift-invariant) and the sum of exponentials, both over ``model``, and
    the target's logit taken on its owning rank and summed. Returns
    ``(loss, label count)``: the rank's summed nll over the whole batch's
    count (all-reduced over ``data``, at least 1) times the data size, so
    that ``mean_over_data`` of it is the whole batch's mean nll."""
    rules = current_rules()
    v = logits.shape[-1]
    tp = rules.model_size > 1 and v < -(-vocab_size // 256) * 256
    off = rules.mesh.coords["model"] * v if tp else 0
    col = torch.arange(off, off + v, device=logits.device)
    if v * rules.model_size > vocab_size:
        logits = logits.masked_fill(col >= vocab_size, -1e30)
    lf = logits.to(_sum_dtype(logits.dtype))  # float32 (float64 stays)
    with torch.no_grad():
        mx = lf.amax(-1)
        if tp:
            mx = _communicate("all-reduce", mx, "model", rules, op=tdist.ReduceOp.MAX)
    sumexp = reduce_from_model(torch.exp(lf - mx[..., None]).sum(-1))
    mine = (labels >= off) & (labels < off + v)
    picked = torch.gather(lf, -1, (labels - off).clamp(0, v - 1).long()[..., None])[..., 0]
    target = reduce_from_model(torch.where(mine, picked, torch.zeros_like(picked)))
    nll = torch.log(sumexp) + mx - target
    mask = labels >= 0
    denom = mean_over_data([mask.sum().float()])[0] * rules.data_size
    denom = denom.clamp(min=1)
    total = torch.where(mask, nll, torch.zeros_like(nll)).sum()
    return total / denom * rules.data_size, denom


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def check_tp(cfg, rules: ShardingRules) -> None:
    """Raise ``not_ported(..., DIST_ITEM)`` for a configuration with no
    runtime under the sharding rules yet: SSM and xLSTM layers (item 7,
    part 4b, sub-item 4), and MLA whose heads the model axis would split
    below one head (``wq_b``, ``wkv_b`` and ``wo`` sharded, but the heads
    not divisible by ``model``; no ``SHAPES`` mesh does this). The dense
    family (a vision frontend's embeddings allowed), the mixture of
    experts, MLA and the encoder-decoder run on any other mesh, FSDP and
    2D expert parallelism included, each dimension sharded or replicated
    as ``param_spec`` and ``cache_spec`` say."""
    why = []
    kinds = set(cfg.blocks)
    if cfg.mla is not None and rules.model_size > 1:
        m, h = cfg.mla, cfg.n_heads
        widths = (h * (m.qk_nope_head_dim + m.qk_rope_head_dim),
                  h * (m.qk_nope_head_dim + m.v_head_dim), h * m.v_head_dim)
        sharded = [rules._model_if_divisible(w) is not None for w in widths]
        if any(sharded) and not (all(sharded) and h % rules.model_size == 0):
            why.append(f"MLA's {h} heads split below one head over model "
                       f"{rules.model_size}")
    if kinds & {"mamba", "shared_attn"}:
        why.append("SSM layers")
    if kinds & {"mlstm", "slstm"}:
        why.append("xLSTM layers")
    if why:
        raise not_ported(f"tensor parallelism for {cfg.name} ({'; '.join(why)})",
                         DIST_ITEM)


def _coords_of(rank: int, shape: dict) -> dict:
    """Rank ``rank``'s coordinates on a mesh of ``shape`` (row-major: the
    last axis varies fastest, as ``jax.make_mesh`` lays out devices)."""
    idx = np.unravel_index(rank, tuple(shape.values()))
    return {a: int(i) for a, i in zip(shape, idx)}


def _index(entry, shape: dict, coords: dict) -> tuple:
    """``(shards, this device's shard)`` of a spec entry."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    n, i = 1, 0
    for a in axes:
        n, i = n * shape[a], i * shape[a] + coords[a]
    return n, i


def shard_leaf(leaf: torch.Tensor, spec, shape: dict, coords: dict) -> torch.Tensor:
    """The slice of ``leaf`` that ``NamedSharding(mesh, spec)
    .devices_indices_map`` gives the device at ``coords``, as a tensor of
    its own."""
    for dim, entry in enumerate(spec or ()):
        if entry is None:
            continue
        n, i = _index(entry, shape, coords)
        size = leaf.shape[dim] // n
        leaf = leaf.narrow(dim, i * size, size)
    return leaf.clone()


def shard_tree(params, rules: ShardingRules, coords: dict):
    """Each leaf of ``params`` cut to the device at ``coords``' slice of
    its ``param_spec``."""
    shape = dict(rules.mesh.shape)
    return _unflatten(params, [
        shard_leaf(leaf, rules.param_spec(path, tuple(leaf.shape)), shape, coords)
        if isinstance(leaf, torch.Tensor) else leaf
        for path, leaf in _flatten_with_paths(params)])


def gather_tree(shards: list, rules: ShardingRules, like):
    """``shard_tree``'s inverse: the whole tree, shaped like ``like`` (the
    whole tree or one of value-less tensors), from every rank's shards in
    rank order."""
    shape = dict(rules.mesh.shape)
    per_rank = [[leaf for _, leaf in _flatten_with_paths(s)] for s in shards]
    whole = []
    for j, (path, leaf) in enumerate(_flatten_with_paths(like)):
        spec = rules.param_spec(path, tuple(leaf.shape))
        out = torch.empty(leaf.shape, dtype=per_rank[0][j].dtype)
        for r, leaves in enumerate(per_rank):
            coords = _coords_of(r, shape)
            view = out
            for dim, entry in enumerate(spec):
                if entry is not None:
                    n, i = _index(entry, shape, coords)
                    size = leaf.shape[dim] // n
                    view = view.narrow(dim, i * size, size)
            view.copy_(leaves[j].detach().cpu())
        whole.append(out)
    return _unflatten(like, whole)
