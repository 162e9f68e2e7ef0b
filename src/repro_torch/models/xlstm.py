"""xLSTM blocks on PyTorch: mLSTM (matrix memory) and sLSTM (scalar memory).

Counterpart of ``repro/models/xlstm.py``, with its names, parameter tree,
shapes, scales and simplifications (q/k/v at d_model width with a GLU gate
on the mLSTM cell; a ``SLSTM_FF_MULT``-wide GELU MLP after the sLSTM
cell, the tanh approximation as ``jax.nn.gelu``'s default).

mLSTM's recurrence ``C_t = f_t·C_{t-1} + i_t·k_t v_tᵀ``, ``n_t = f_t·n_{t-1}
+ i_t·k_t``, ``h_t = (q_tᵀC_t)/max(|q_tᵀn_t|, 1)`` runs chunked for training
and prefill (the intra-chunk term with a decay mask, then the state
carried from chunk to chunk by a Python loop where the JAX package scans)
and as the recurrence for decode, on the JAX package's branches. Its decay
mask departs from the JAX package's as ``models/ssm.py``'s does: the log
decays are summed term by term (``_segsum``), and masked with -inf before
the ``exp``, where the JAX package's ``where(mask, exp(rel)·i, 0)``
overflows above the diagonal once a chunk's summed ``-log f`` passes
~88.7, which leaves the value right and the gradient NaN (ROADMAP.md
Queue 3, item 11).

sLSTM is sequential: a Python loop over time with the stabilised
exponential gating of the xLSTM paper. ``slstm_scan`` is a
``torch.autograd.Function`` with the JAX package's custom VJP: the forward
keeps every step's state, the backward walks time in reverse taking each
step's VJP of ``_slstm_core`` (recomputed under autograd) and keeps only
its ``drec``, and ``d r_gates`` is one contraction over the whole
sequence. Plain autograd over the loop would add a full ``[H, dh, 4·dh]``
gradient once a step. The loop runs ~20 eager launches a step (a host-bound
recurrence, PERF.md §5); the JAX package has no Pallas kernel for it.

Decode caches are float32 and updated in place: mLSTM ``{"C": [B, H, dh,
dh], "n": [B, H, dh]}``, sLSTM ``{"c", "n", "h": [B, H, dh], "m": [B, H]}``
with ``m`` from -1e30.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.models.layers import _randn, dense_init
from repro_torch.models.ssm import _decay_mask, _segsum, _up

SLSTM_FF_MULT = 1.375  # ≈ 4/3, rounded so d_ff divides the model mesh axis


def _heads(cfg: LMConfig) -> tuple[int, int]:
    h = cfg.n_heads
    return h, cfg.d_model // h


def _f32_scale(x: torch.Tensor, dh: int) -> torch.Tensor:
    """``x / np.sqrt(dh)`` as JAX computes it: the numpy scalar is a
    strongly typed float32, so a bfloat16 ``x`` is promoted first."""
    return x.to(torch.promote_types(x.dtype, torch.float32)) / math.sqrt(dh)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(generator: torch.Generator, cfg: LMConfig, lead: tuple = (),
               device=None) -> dict:
    d = cfg.d_model
    h, dh = _heads(cfg)
    return {
        "wq": dense_init(generator, d, d, lead, device),
        "wk": dense_init(generator, d, d, lead, device),
        "wv": dense_init(generator, d, d, lead, device),
        "w_gate_i": dense_init(generator, d, h, lead, device),
        "b_gate_i": torch.zeros((*lead, h), device=device),
        "w_gate_f": dense_init(generator, d, h, lead, device),
        "b_gate_f": torch.full((*lead, h), 3.0, device=device),  # remember
        "w_up": dense_init(generator, d, d, lead, device),  # GLU gate
        "w_out": dense_init(generator, d, d, lead, device),
        "skip": torch.ones((*lead, h, dh), device=device),
    }


def mlstm_apply(p: dict, cfg: LMConfig, x: torch.Tensor,
                cache: Optional[dict] = None):
    """x: [B, T, D] -> ([B, T, D], new_cache): ``new_cache`` holds the
    input cache's tensors, updated in place (None without a cache)."""
    b, t, d = x.shape
    h, dh = _heads(cfg)
    q = _f32_scale((x @ p["wq"]).reshape(b, t, h, dh), dh)
    k = _f32_scale((x @ p["wk"]).reshape(b, t, h, dh), dh)
    v = (x @ p["wv"]).reshape(b, t, h, dh)
    i_gate = torch.exp(
        torch.clamp((x @ p["w_gate_i"] + p["b_gate_i"]).float(), -10, 10)
    )  # [B,T,H]
    f_gate = torch.sigmoid((x @ p["w_gate_f"] + p["b_gate_f"]).float())

    if t == 1 and cache is not None:
        c_st, n_st = cache["C"], cache["n"]
        f0, i0 = f_gate[:, 0, :, None, None], i_gate[:, 0, :, None, None]
        c_new = f0 * c_st + i0 * torch.einsum("bhd,bhv->bhdv", *_up(k[:, 0], v[:, 0]))
        n_new = f_gate[:, 0, :, None] * n_st + i_gate[:, 0, :, None] * k[:, 0]
        num = torch.einsum("bhd,bhdv->bhv", q[:, 0].float(), c_new)
        den = torch.abs(torch.einsum("bhd,bhd->bh", q[:, 0].float(), n_new))
        hid = (num / torch.clamp(den, min=1.0)[..., None])[:, None]  # [B,1,H,dv]
    else:
        c0 = cache["C"] if cache is not None else torch.zeros(
            (b, h, dh, dh), dtype=torch.float32, device=x.device)
        n0 = cache["n"] if cache is not None else torch.zeros(
            (b, h, dh), dtype=torch.float32, device=x.device)
        hid, c_new, n_new = _chunked_mlstm(f_gate, i_gate, q, k, v, c0, n0,
                                           chunk=cfg.ssm.chunk if cfg.ssm else 128)
    new_cache = None
    if cache is not None:
        cache["C"].copy_(c_new)
        cache["n"].copy_(n_new)
        new_cache = {"C": cache["C"], "n": cache["n"]}

    hid = hid + v.float().reshape(b, -1, h, dh) * p["skip"]
    hid = hid.reshape(b, hid.shape[1], d).to(x.dtype)
    out = hid * F.silu(x @ p["w_up"])  # GLU on the cell output
    return out @ p["w_out"], new_cache


def _chunked_mlstm(f, i, q, k, v, c0, n0, chunk=128):
    """Chunked gated linear attention. f,i:[B,T,H] q,k,v:[B,T,H,dh]."""
    b, t, h = f.shape
    dh = q.shape[-1]
    c = min(chunk, t)
    pad = (-t) % c
    if pad:
        f = F.pad(f, (0, 0, 0, pad), value=1.0)
        i = F.pad(i, (0, 0, 0, pad))
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
    tp = f.shape[1]
    nc = tp // c
    compute_dtype = q.dtype  # keep the O(T·c·H) tensors in compute dtype;
    # only the log-space gate accumulators stay f32 (stability)
    fc = f.reshape(b, nc, c, h)
    ic = i.reshape(b, nc, c, h)
    qc = q.reshape(b, nc, c, h, dh)
    kc = k.reshape(b, nc, c, h, dh)
    vc = v.reshape(b, nc, c, h, dh)

    logf = torch.log(fc.clamp(min=1e-20))  # f32
    cum = torch.cumsum(logf, dim=2)  # [B,NC,c,H] f32
    rel = _segsum(logf)  # cum_i - cum_j, summed term by term
    w = (_decay_mask(rel) * ic[:, :, None, :, :]).to(compute_dtype)  # j on i
    g = torch.einsum("bkihd,bkjhd->bkijh", qc, kc)
    gw = (g * w).to(compute_dtype)
    intra = torch.einsum("bkijh,bkjhv->bkihv", *_up(gw, vc)).float()
    intra_n = gw.sum(3).float()  # [B,NC,c,H]

    total = torch.exp(cum[:, :, -1, :])
    after = torch.exp(rel[:, :, -1]) * ic
    cstate = torch.einsum("bkjhd,bkjhv->bkhdv", *_up(after[..., None] * kc, vc))
    nstate = torch.einsum("bkjh,bkjhd->bkhd", *_up(after, kc))

    cs, ns = c0, n0
    c_in, n_in = [], []  # the states *entering* each chunk
    for j in range(nc):
        c_in.append(cs)
        n_in.append(ns)
        cs = cs * total[:, j, :, None, None] + cstate[:, j]
        ns = ns * total[:, j, :, None] + nstate[:, j]
    c_in = torch.stack(c_in, dim=1)
    n_in = torch.stack(n_in, dim=1)

    carry_w = torch.exp(cum)
    inter = torch.einsum("bkihd,bkhdv->bkihv", *_up(qc * carry_w[..., None], c_in))
    inter_n = (qc * n_in[:, :, None]).sum(-1) * carry_w
    num = (intra + inter).reshape(b, tp, h, dh)[:, :t]
    den = torch.abs((intra_n + inter_n).reshape(b, tp, h))[:, :t]
    out = num / torch.clamp(den, min=1.0)[..., None]
    return out, cs, ns


def mlstm_cache_init(cfg: LMConfig, batch: int, lead: tuple = (), device=None) -> dict:
    h, dh = _heads(cfg)
    return {
        "C": torch.zeros((*lead, batch, h, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((*lead, batch, h, dh), dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(generator: torch.Generator, cfg: LMConfig, lead: tuple = (),
               device=None) -> dict:
    d = cfg.d_model
    h, dh = _heads(cfg)
    d_ff = int(-(-d * SLSTM_FF_MULT // 128) * 128)
    return {
        "w_gates": dense_init(generator, d, 4 * d, lead, device),  # i,f,z,o
        # block-diagonal recurrent mixing (per head)
        "r_gates": _randn(generator, (*lead, h, dh, 4 * dh), device) / math.sqrt(dh),
        "b_gates": torch.cat([torch.zeros((*lead, d), device=device),
                              torch.full((*lead, d), 3.0, device=device),
                              torch.zeros((*lead, 2 * d), device=device)], dim=-1),
        "w_ff_in": dense_init(generator, d, d_ff, lead, device),
        "w_ff_out": dense_init(generator, d_ff, d, lead, device),
    }


def _slstm_core(state, gx, rec):
    """One sLSTM step given the recurrent pre-activation ``rec`` as an
    INPUT (the recurrent weights never enter the step — see slstm_scan)."""
    c_st, n_st, h_st, m_st = state
    gi = gx[:, 0].float() + rec[:, 0]
    gf = gx[:, 1].float() + rec[:, 1]
    gz = gx[:, 2].float() + rec[:, 2]
    go = gx[:, 3].float() + rec[:, 3]
    log_f = F.logsigmoid(gf).mean(-1)  # scalar per head
    log_i = torch.clamp(gi, -10, 10).mean(-1)
    m_new = torch.maximum(log_f + m_st, log_i)
    keep = torch.exp(log_f + m_st - m_new)[..., None]
    write = torch.exp(log_i - m_new)[..., None]
    c_new = keep * c_st + write * torch.tanh(gz)
    n_new = keep * n_st + write
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _rec_preact(h_st, r_gates):
    b, h, dh = h_st.shape
    rec = torch.einsum("bhd,hde->bhe", *_up(h_st, r_gates)).reshape(b, h, 4, dh)
    return rec.transpose(1, 2)  # [b,4,h,dh]


class _SLSTMScan(torch.autograd.Function):
    """The recurrence over time with the JAX package's custom VJP (the
    cuDNN-RNN batched-weight-gradient trick): inputs ``r_gates [H, dh,
    4·dh]``, ``gates_x [T, B, 4, H, dh]`` and the state's four tensors;
    outputs the final state's four and ``hs [T, B, H, dh]``."""

    @staticmethod
    def forward(ctx, r_gates, gates_x, c0, n0, h0, m0):
        state = (c0, n0, h0, m0)
        states, hs = [], []
        for gx in gates_x:
            states.append(state)
            state, h_out = _slstm_core(state, gx, _rec_preact(state[2], r_gates))
            hs.append(h_out)
        ctx.save_for_backward(r_gates, gates_x,
                              *(torch.stack(s) for s in zip(*states)))
        return (*state, torch.stack(hs))

    @staticmethod
    def backward(ctx, dc, dn, dh, dm, d_hs):
        r_gates, gates_x, *states = ctx.saved_tensors
        h_all = states[2]  # [T, b, h, dh]: each step's h_prev
        b, h, dh_ = h_all.shape[1:]
        dstate = (dc, dn, dh, dm)  # unused outputs' cotangents arrive as zeros
        dgates_x = torch.empty_like(gates_x)
        drecs = torch.empty((len(gates_x), b, h, 4 * dh_), dtype=h_all.dtype,
                            device=h_all.device)
        r_up = r_gates.to(torch.promote_types(r_gates.dtype, h_all.dtype))
        for t in reversed(range(len(gates_x))):
            state = tuple(s[t].detach().requires_grad_(True) for s in states)
            gx = gates_x[t].detach().requires_grad_(True)
            rec = _rec_preact(states[2][t], r_gates).requires_grad_(True)
            with torch.enable_grad():
                new_state, _ = _slstm_core(state, gx, rec)
            # the step's h output is the new state's h: its ys cotangent
            # joins the state's
            cots = (dstate[0], dstate[1], dstate[2] + d_hs[t], dstate[3])
            grads = torch.autograd.grad(new_state, [*state, gx, rec], cots,
                                        allow_unused=True)
            dstate_in = [torch.zeros_like(s) if g is None else g
                         for s, g in zip(state, grads[:4])]
            dgates_x[t] = grads[4]
            drec_flat = grads[5].transpose(1, 2).reshape(b, h, 4 * dh_)
            drecs[t] = drec_flat
            # route drec back to h_prev through R (weights stay OUT of the loop)
            dh_prev = torch.einsum("bhe,hde->bhd", drec_flat, r_up)
            dstate = (dstate_in[0], dstate_in[1], dstate_in[2] + dh_prev, dstate_in[3])
        # batched weight gradient: ONE contraction over the whole sequence
        d_r_gates = torch.einsum("tbhd,tbhe->hde", h_all, drecs)
        return (d_r_gates.to(r_gates.dtype), dgates_x, *dstate)


def slstm_scan(r_gates, gates_x, state0):
    """Run the recurrence over time. gates_x: [T,b,4,h,dh]; state0 the
    tuple (c, n, h, m). Returns ``((c, n, h, m), hs [T, b, h, dh])``."""
    *state_fin, hs = _SLSTMScan.apply(r_gates, gates_x, *state0)
    return tuple(state_fin), hs


def slstm_apply(p: dict, cfg: LMConfig, x: torch.Tensor,
                cache: Optional[dict] = None):
    """Sequential scan with stabilized exponential gating. Returns ``(out,
    new_cache)``: ``new_cache`` holds the input cache's tensors, updated
    in place (None without a cache)."""
    b, t, d = x.shape
    h, dh = _heads(cfg)
    gates_x = (x @ p["w_gates"] + p["b_gates"]).reshape(b, t, 4, h, dh)

    if cache is not None:
        state0 = (cache["c"], cache["n"], cache["h"], cache["m"])
    else:
        z = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
        state0 = (z, z, z, torch.full((b, h), -1e30, dtype=torch.float32,
                                      device=x.device))

    state_fin, hs = slstm_scan(p["r_gates"], gates_x.transpose(0, 1), state0)
    hid = hs.transpose(0, 1).reshape(b, t, d).to(x.dtype)
    out = F.gelu(hid @ p["w_ff_in"], approximate="tanh") @ p["w_ff_out"]
    new_cache = None
    if cache is not None:
        for key, value in zip(("c", "n", "h", "m"), state_fin):
            cache[key].copy_(value)
        new_cache = {key: cache[key] for key in ("c", "n", "h", "m")}
    return out, new_cache


def slstm_cache_init(cfg: LMConfig, batch: int, lead: tuple = (), device=None) -> dict:
    h, dh = _heads(cfg)
    cache = {key: torch.zeros((*lead, batch, h, dh), dtype=torch.float32, device=device)
             for key in ("c", "n", "h")}
    cache["m"] = torch.full((*lead, batch, h), -1e30, dtype=torch.float32, device=device)
    return cache
