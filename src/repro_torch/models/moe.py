"""Mixture of experts with the sorted (fused) dispatch, on PyTorch.

Counterpart of ``repro/models/moe.py``: token→expert routing is weighted
neighbour aggregation on a bipartite token–expert graph. The dense
baseline (``MoEConfig.impl = "dense"``) runs every expert on every token
and combines through a mask; the sorted path groups the (token, expert)
pairs by expert into a capacity-bounded ``[E, C, D]`` buffer, runs the
experts batched, and combines each token's ``k`` slots back.

The JAX package routes with ``lax.top_k`` (ties to the lower expert
index), packs with a stable ``argsort`` and combines with an accumulating
scatter (``.at[table].add``). Here ``route`` breaks ties the same way (a
stable descending sort), the sort is stable, and the dispatch and the
combine are gathers in both directions: ``_TokensToSlots`` fills the
buffer from each slot's token and sums each token's ``k`` slot gradients
in slot order ``j = 0..k-1``; ``_SlotsToPairs`` reads each token's ``k``
slots and sends each slot its one pair's gradient. No step of the path
sums through ``index_add_``, ``scatter_add_`` or
``index_put_(accumulate=True)``, whose order on CUDA changes from run to
run, so a step repeats bitwise. A pair the capacity drops points at the
sentinel slot ``E·C``, which reads as zeros. ``shard_activation`` marks
the ``[E, C, D]`` buffer at the JAX package's two sites.
``expert_spec`` has no counterpart.

Under sharding rules (``distributed/sharding.py``) a rank holds the
expert block ``param_spec`` gives its experts' axis: over ``(data,
model)`` under 2D expert parallelism (rank ``(d, m)`` block ``d·M + m``),
over ``model`` alone otherwise (1D), or every expert where ``model`` does
not divide them. The routing and the dispatch maps stay global, as GSPMD
keeps them: each data rank's expert ids are all-gathered over ``data``
(``[T, k]``, small), so ``capacity`` counts the whole batch's tokens and
``dispatch_maps`` sorts the whole batch's pairs, the same maps on every
rank. Only token rows move. Tokens are replicated over ``model``, so an
all-to-all over ``data`` within a model column (``all_to_all_data``)
brings each expert its slots: a rank sends every data rank of its
column a fixed ``[E_l, C_l, D]`` block of that rank's slots (2D: its
experts, every slot; 1D: the column's experts, the rank's ``C / data``
of the slots) filled with its own tokens' rows and zeros elsewhere, and
sums the blocks it receives. A slot holds one token, so the sum of a
row and zeros is exact. The experts run on the rank's block; the
combine is the transpose (every data rank of the column receives each
block), each rank reads its own tokens' pairs, and the model ranks'
partial sums are added (``reduce_from_model``; the tokens and gates pass
``copy_to_model``). The load-balance loss is the whole batch's: the
expert counts from the gathered ids, the probability sums over
``data`` (``sum_over_data``). Without a data axis nothing crosses
``data``; without rules nothing here runs. The dense baseline under the
rules gathers the tokens over ``data`` only where the experts lie over
it, and reduce-scatters its partial combine back.

Each stage runs inside a ``torch.profiler.record_function`` span named in
``SPANS``, so that a profile can put its kernels under the stage.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.distributed.sharding import current_rules, shard_activation
from repro_torch.distributed.tensor_parallel import (
    _index,
    all_to_all_data,
    copy_to_model,
    gather_data_rows,
    reduce_from_model,
    scatter_data_rows,
    sum_over_data,
)
from repro_torch.models.layers import _randn, apply_mlp, dense_init

#: the ``record_function`` spans of the stages: the router's top-k sort,
#: the dispatch (``dispatch_maps`` and the tokens-to-slots gather), the
#: experts' products and the combine's slots-to-pairs gather
SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def moe_init(generator: torch.Generator, cfg: LMConfig, lead: tuple = (),
             device=None) -> dict:
    """The router ``[D, E]`` (a bare weight), the experts ``we_gate`` /
    ``we_up`` ``[E, D, F]`` and ``we_down`` ``[E, F, D]`` (normal over
    ``sqrt`` of the input width, scaled in place: one copy of each), and
    ``shared`` at width ``F · n_shared_experts`` where there are shared
    experts; ``lead`` leading axes (a stacked segment's repetitions)."""
    m: MoEConfig = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts

    def experts(d_in: int, d_out: int) -> torch.Tensor:
        return _randn(generator, (*lead, e, d_in, d_out), device).mul_(1.0 / math.sqrt(d_in))

    p = {"router": dense_init(generator, d, e, lead, device),
         "we_gate": experts(d, f), "we_up": experts(d, f), "we_down": experts(f, d)}
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        p["shared"] = {"w_gate": dense_init(generator, d, fs, lead, device),
                       "w_up": dense_init(generator, d, fs, lead, device),
                       "w_down": dense_init(generator, fs, d, lead, device)}
    return p


def _expert_ffn(p: dict, x_ec: torch.Tensor) -> torch.Tensor:
    """x_ec: [E, C, D] -> [E, C, D], a SwiGLU batched over the experts
    (whatever ``cfg.activation`` says, as in the JAX package)."""
    with record_function("moe.experts"):
        h = F.silu(torch.einsum("ecd,edf->ecf", x_ec, p["we_gate"]))
        h = h * torch.einsum("ecd,edf->ecf", x_ec, p["we_up"])
        return torch.einsum("ecf,efd->ecd", h, p["we_down"])


def route(probs: torch.Tensor, k: int) -> tuple:
    """The top ``k`` of ``probs`` [T, E] by row, as ``jax.lax.top_k``
    gives them: values descending, ties to the lower index (a stable
    descending sort; ``torch.topk`` promises no order for ties). Returns
    ``(values [T, k], indices [T, k])``."""
    with record_function("moe.route"):
        vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        return vals[:, :k], ids[:, :k]


class ExpertLayout:
    """A rank's share of the experts under the active rules: its expert
    block (``first`` and ``n_local`` global expert ids), whether the
    block lies over ``data`` (2D) and over ``model``, and the data axis's
    size and the rank's index on it (1 and 0 where ``data`` has one
    rank)."""

    def __init__(self, rules, m: MoEConfig, d_model: int):
        entry = rules.param_spec("we_gate", (m.n_experts, d_model, m.d_ff_expert))[0]
        axes = entry if isinstance(entry, tuple) else (entry,)
        # a data axis alone is FSDP's, gathered where the layer runs
        axes = axes if rules.model_axis and rules.model_axis in axes else ()
        shape, coords = dict(rules.mesh.shape), dict(rules.mesh.coords)
        n_blocks, block = _index(axes, shape, coords) if axes else (1, 0)
        self.n_local = m.n_experts // n_blocks
        self.first = block * self.n_local
        self.over_model = rules.model_axis in axes and rules.model_size > 1
        data = rules.batch_axes[-1] if rules.batch_axes else None
        self.n_data = rules.data_size
        self.data = coords[data] if data else 0
        self.over_data = data in axes and self.n_data > 1
        # the first expert of the block each data rank of this model column holds
        self.column = [_index(axes, shape, {**coords, data: j})[1] * self.n_local
                       if self.over_data else self.first for j in range(self.n_data)]


def moe_apply(p: dict, cfg: LMConfig, x: torch.Tensor) -> tuple:
    """x [B, T, D] -> ``(out [B, T, D], aux)``. The router logits at x's
    dtype, the softmax in float32, the top-k gates renormalised (``+
    1e-9``); aux is Switch's load-balance loss ``E · Σ_e f_e · P_e``; the
    shared experts are added after the routed sum. Under sharding rules
    ``x`` holds the data rank's rows, and the routing, the capacity and
    aux are the whole batch's."""
    m: MoEConfig = cfg.moe
    b, t, d = x.shape
    tokens = x.reshape(b * t, d)
    k, e = m.n_experts_per_token, m.n_experts
    rules = current_rules()
    ep = None if rules is None else ExpertLayout(rules, m, d)

    logits = tokens @ p["router"]
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_ids = route(probs, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    ids_all = gather_data_rows(expert_ids) if ep is not None else expert_ids
    n_all = ids_all.shape[0]
    experts = torch.arange(e, device=x.device)
    counts = (ids_all.reshape(-1, 1) == experts).sum(0).float()
    p_e = probs.mean(0) if ep is None else sum_over_data(probs.sum(0)) / n_all
    aux = e * torch.sum(counts / (n_all * k) * p_e)

    if ep is not None and ep.over_model:
        tokens_in, gates_in = copy_to_model(tokens), copy_to_model(gate_vals)
    else:
        tokens_in, gates_in = tokens, gate_vals
    if m.impl == "dense":
        out = _dense_combine(p, tokens_in, gates_in, expert_ids, m, ep)
    elif ep is None:
        out = _sorted_combine(p, tokens_in, gates_in, expert_ids, m)
    else:
        out = _sharded_combine(p, tokens_in, gates_in, ids_all, m, ep)
    if ep is not None and ep.over_model:
        out = reduce_from_model(out)

    if m.n_shared_experts:
        out = out + apply_mlp(p["shared"], tokens, "swiglu",
                              m.d_ff_expert * m.n_shared_experts)
    return out.reshape(b, t, d), aux


def _dense_combine(p, tokens, gate_vals, expert_ids, m: MoEConfig, ep=None):
    """The baseline: every expert on every token, then the masked combine
    (a token's ``k`` experts are distinct, so its mask row holds its gates
    at their experts). Kept for the tests and ``impl="dense"``. Under the
    rules the rank's experts run on its tokens (every data rank's, gathered
    over ``data``, where the experts lie over it) and the rank's partial
    combine is returned (reduce-scattered back to its rows over ``data``)."""
    if ep is not None and ep.over_data:
        tokens, gate_vals = gather_data_rows(tokens), gather_data_rows(gate_vals)
        expert_ids = gather_data_rows(expert_ids)
    n_tok, d = tokens.shape
    n_local = m.n_experts if ep is None else ep.n_local
    x_all = tokens[None].expand(n_local, n_tok, d)
    y_all = _expert_ffn(p, x_all)  # [E_l, T, D]
    onehot = F.one_hot(expert_ids, m.n_experts).to(tokens.dtype)  # [T, k, E]
    if ep is not None:
        onehot = onehot[..., ep.first:ep.first + n_local]
    mask = (onehot * gate_vals.to(tokens.dtype)[..., None]).sum(1)
    out = torch.einsum("te,etd->td", mask, y_all)
    return scatter_data_rows(out) if ep is not None and ep.over_data else out


def capacity(n_tok: int, m: MoEConfig) -> int:
    """Slots an expert holds: ``n_tok · k · capacity_factor / E``, at
    least ``min(n_tok · k, 64)`` (a decode step's few tokens do not
    balance, so they get headroom instead of drops), rounded up to 8."""
    k, e = m.n_experts_per_token, m.n_experts
    c = int(max(1, (n_tok * k * m.capacity_factor) / e))
    c = max(c, min(n_tok * k, 64))
    return -(-c // 8) * 8


def dispatch_maps(expert_ids: torch.Tensor, n_experts: int, cap: int) -> tuple:
    """The (token, expert) pairs ``f = token · k + j`` of ``expert_ids``
    [T, k], stably sorted by expert (the graph-reordering step), each
    expert's first ``cap`` kept in that order. Returns ``(slot_pair [E·C],
    pair_slot [T·k])``: the pair each slot holds (``T·k`` where the slot is
    empty) and the slot each pair went to (``E·C`` where it was dropped),
    one the other's inverse on the kept pairs. Built by gathers and a
    scatter of a permutation: no accumulating op."""
    with record_function("moe.dispatch"):
        n_flat = expert_ids.numel()
        ids_flat = expert_ids.reshape(-1)
        order = torch.argsort(ids_flat, stable=True)
        ids_s = ids_flat[order]
        experts = torch.arange(n_experts, device=ids_flat.device)
        starts = torch.searchsorted(ids_s, experts)
        counts = torch.searchsorted(ids_s, experts, right=True) - starts
        pos = torch.arange(n_flat, device=ids_flat.device) - starts[ids_s]
        n_slots = n_experts * cap
        slot = torch.where(pos < cap, ids_s * cap + pos, n_slots)
        pair_slot = torch.empty_like(slot).scatter_(0, order, slot)
        c = torch.arange(cap, device=ids_flat.device)
        filled = c[None, :] < counts[:, None]  # [E, C]
        src = (starts[:, None] + c[None, :]).clamp(max=n_flat - 1)
        slot_pair = torch.where(filled, order[src], n_flat).reshape(-1)
        return slot_pair, pair_slot


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The rows of x at ``idx`` (any shape), zeros where an index is
    ``len(x)``: the sentinel a dropped pair or an empty slot reads."""
    n = x.shape[0]
    flat = idx.reshape(-1)
    out = x.index_select(0, flat.clamp(max=n - 1))
    out.masked_fill_((flat == n)[:, None], 0)
    return out.reshape(*idx.shape, *x.shape[1:])


class _TokensToSlots(torch.autograd.Function):
    """Dispatch: slot s holds the row of its pair's token (zeros where the
    slot is empty). The backward gathers each token's ``k`` slots and sums
    them in slot order, in the gradient's dtype."""

    @staticmethod
    def forward(ctx, x, slot_token, token_slot):
        ctx.save_for_backward(token_slot)
        with record_function("moe.dispatch"):
            return _rows(x, slot_token)

    @staticmethod
    def backward(ctx, g):
        (token_slot,) = ctx.saved_tensors
        parts = _rows(g, token_slot).unbind(1)  # k of [T, D]
        dx = parts[0]
        for part in parts[1:]:
            dx = dx + part
        return dx, None, None


class _SlotsToPairs(torch.autograd.Function):
    """Combine's gather: pair f reads the row of the slot it went to
    (zeros where it was dropped). A slot holds at most one pair, so the
    backward is the gather the other way."""

    @staticmethod
    def forward(ctx, y, pair_slot, slot_pair):
        ctx.save_for_backward(slot_pair)
        with record_function("moe.combine"):
            return _rows(y, pair_slot)

    @staticmethod
    def backward(ctx, g):
        (slot_pair,) = ctx.saved_tensors
        return _rows(g, slot_pair), None, None


def _sorted_combine(p, tokens, gate_vals, expert_ids, m: MoEConfig):
    """The fused dispatch: pack the pairs into ``[E, C, D]`` by expert,
    run the experts batched, weight each pair's output by its gate (at the
    output's dtype) and sum each token's ``k`` pairs in order, in the
    output's dtype."""
    n_tok, d = tokens.shape
    k, e = m.n_experts_per_token, m.n_experts
    cap = capacity(n_tok, m)
    slot_pair, pair_slot = dispatch_maps(expert_ids, e, cap)
    x_ec = _TokensToSlots.apply(tokens, torch.div(slot_pair, k, rounding_mode="floor"),
                                pair_slot.reshape(n_tok, k))
    x_ec = shard_activation(x_ec.reshape(e, cap, d), "moe_expert")
    y_ec = shard_activation(_expert_ffn(p, x_ec), "moe_expert")
    y_pairs = _SlotsToPairs.apply(y_ec.reshape(e * cap, d), pair_slot, slot_pair)
    y_pairs = y_pairs * gate_vals.reshape(-1, 1).to(y_pairs.dtype)
    parts = y_pairs.reshape(n_tok, k, d).unbind(1)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out.to(tokens.dtype)


def _sharded_combine(p, tokens, gate_vals, ids_all, m: MoEConfig, ep: ExpertLayout):
    """``_sorted_combine`` of a rank under the rules (``ExpertLayout``):
    the global maps from every data rank's ids ``ids_all`` [T_all, k],
    this rank's ``tokens`` [T, D] and their gates moved to the data ranks
    of its model column in fixed blocks (``all_to_all_data``), the rank's
    experts on the slots it receives, the outputs sent back to every data
    rank of the column and read by each rank's own pairs. Returns the
    rank's partial combine over its column's experts, in the output's
    dtype."""
    n_tok, d = tokens.shape
    k, e = m.n_experts_per_token, m.n_experts
    n_all = ids_all.shape[0]
    cap = capacity(n_all, m)
    dev = tokens.device
    slot_pair, pair_slot = dispatch_maps(ids_all, e, cap)
    with record_function("moe.dispatch"):
        n_data, n_loc = ep.n_data, ep.n_local
        # the slots each data rank of the column holds: [n_data, E_l, C_l]
        c_loc = cap if ep.over_data else -(-cap // n_data)
        local_e = torch.arange(n_loc, device=dev)
        local_c = torch.arange(c_loc, device=dev)
        blocks = []
        for j in range(n_data):
            c = local_c if ep.over_data else j * c_loc + local_c
            slot = (ep.column[j] + local_e)[:, None] * cap + c[None, :]
            blocks.append(torch.where(c[None, :] < cap, slot, e * cap))
        col = torch.stack(blocks).reshape(-1)
        n_col = col.numel()
        # each global slot's local token (n_tok where the slot is empty or
        # another data rank's), and each slot's place in the column's blocks
        tok = torch.div(slot_pair, k, rounding_mode="floor") - ep.data * n_tok
        tok = torch.where((tok >= 0) & (tok < n_tok), tok, n_tok)
        tok = torch.cat([tok, tok.new_full((1,), n_tok)])
        place = torch.full((e * cap + 1,), n_col, dtype=torch.long, device=dev)
        place.scatter_(0, col, torch.arange(n_col, device=dev))
        place[e * cap] = n_col
        mine = pair_slot.reshape(n_all, k)[ep.data * n_tok:(ep.data + 1) * n_tok]
        pair_place = place[mine]  # [T, k]
        place_pair = torch.full((n_col + 1,), n_tok * k, dtype=torch.long, device=dev)
        place_pair.scatter_(0, pair_place.reshape(-1), torch.arange(n_tok * k, device=dev))
        place_pair = place_pair[:n_col]
    send = _TokensToSlots.apply(tokens, tok[col], pair_place)
    recv = all_to_all_data(send.reshape(n_data, n_loc, c_loc, d))
    x_ec = shard_activation(recv.sum(0), "moe_expert")
    y_ec = shard_activation(_expert_ffn(p, x_ec), "moe_expert")
    back = all_to_all_data(y_ec[None].expand(n_data, *y_ec.shape))
    y_pairs = _SlotsToPairs.apply(back.reshape(n_col, d), pair_place.reshape(-1), place_pair)
    y_pairs = y_pairs * gate_vals.reshape(-1, 1).to(y_pairs.dtype)
    parts = y_pairs.reshape(n_tok, k, d).unbind(1)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out.to(tokens.dtype)
