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
the ``[E, C, D]`` buffer at the JAX package's two sites; the collectives
of 2D expert parallelism are ROADMAP.md Queue 1, item 7 (4b), and
``distributed/tensor_parallel.py:check_tp`` refuses MoE layers until
then. ``expert_spec`` has no counterpart.

Each stage runs inside a ``torch.profiler.record_function`` span named in
``SPANS``, so that a profile can put its kernels under the stage.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.distributed.sharding import shard_activation
from repro_torch.models.layers import _randn, dense_init

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


def moe_apply(p: dict, cfg: LMConfig, x: torch.Tensor) -> tuple:
    """x [B, T, D] -> ``(out [B, T, D], aux)``. The router logits at x's
    dtype, the softmax in float32, the top-k gates renormalised (``+
    1e-9``); aux is Switch's load-balance loss ``E · Σ_e f_e · P_e``; the
    shared experts are added after the routed sum."""
    m: MoEConfig = cfg.moe
    b, t, d = x.shape
    tokens = x.reshape(b * t, d)
    n_tok, k, e = b * t, m.n_experts_per_token, m.n_experts

    logits = tokens @ p["router"]
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_ids = route(probs, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    experts = torch.arange(e, device=x.device)
    counts = (expert_ids.reshape(-1, 1) == experts).sum(0).float()
    aux = e * torch.sum(counts / (n_tok * k) * probs.mean(0))

    if m.impl == "dense":
        out = _dense_combine(p, tokens, gate_vals, expert_ids, m)
    else:
        out = _sorted_combine(p, tokens, gate_vals, expert_ids, m)

    if m.n_shared_experts:
        s = p["shared"]
        h = F.silu(tokens @ s["w_gate"]) * (tokens @ s["w_up"])
        out = out + h @ s["w_down"]
    return out.reshape(b, t, d), aux


def _dense_combine(p, tokens, gate_vals, expert_ids, m: MoEConfig):
    """The baseline: every expert on every token, then the masked combine
    (a token's ``k`` experts are distinct, so its mask row holds its gates
    at their experts). Kept for the tests and ``impl="dense"``."""
    n_tok, d = tokens.shape
    x_all = tokens[None].expand(m.n_experts, n_tok, d)
    y_all = _expert_ffn(p, x_all)  # [E, T, D]
    onehot = F.one_hot(expert_ids, m.n_experts).to(tokens.dtype)  # [T, k, E]
    mask = (onehot * gate_vals.to(tokens.dtype)[..., None]).sum(1)
    return torch.einsum("te,etd->td", mask, y_all)


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
