"""Mamba2 (SSD) block on PyTorch: the chunked parallel form for training
and prefill, the recurrence for decode.

Counterpart of ``repro/models/ssm.py``, with its names, parameter tree,
shapes and scales: a scalar decay A a head, a depthwise causal
convolution over the (x, B, C) streams, the chunked SSD (the intra-chunk
term in the factored ``(C Bᵀ ∘ L) X`` form, then the state carried from
chunk to chunk by a Python loop where the JAX package scans) and the T
= 1 recurrent step, taken on the same branches as there. The state math
is float32 whatever the stream's dtype; the stream returns to it where
the JAX package casts it back. Where JAX's ``einsum`` promotes a mixed
bfloat16/float32 pair, the port casts the bfloat16 operand up first
(``torch.einsum`` takes one dtype), and each three-operand ``einsum`` is
two steps in an order that never builds a chunk x P x N tensor.

Two departures, both in the decay mask. The JAX package takes the log
decay from source j to output i as ``cum_i - cum_j``, the difference of
two prefix sums over the chunk; at zamba2-7b's chunk of 128 those reach
~90, and in float32 the difference loses ~1e-5 of a weight near the
diagonal: a float32 SSD lands ~1.2e-6 (root mean square, relative) from
the same function in float64, and ~1.2e-7 with each entry summed from
its own terms (``_segsum``), as the port takes it. Then the JAX
package's ``where(mask, exp(rel), 0)`` overflows to inf above the
diagonal once a chunk's summed dt passes ~88.7, so the value is right
and the gradient NaN (0 · inf; ROADMAP.md Queue 3, item 11); the port
masks ``rel`` with -inf before the ``exp``: the same forward, a finite
gradient.

The decode cache ``{"conv": [B, W-1, conv_ch], "state": [B, H, P, N]}``
is float32 and updated in place (``models/attention.py`` does the same
with K/V), so ``mamba_apply`` returns the cache's own tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig, SSMConfig
from repro_torch.models.layers import _randn, dense_init


def _dims(cfg: LMConfig) -> tuple:
    """(d_inner, n_heads, conv channels) of the config's Mamba2 block."""
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, d_inner + 2 * s.state_dim


def _up(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """``a`` and ``b`` at their promoted dtype, as JAX's ``einsum`` takes a
    mixed pair."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype), b.to(dtype)


def mamba_init(generator: torch.Generator, cfg: LMConfig, lead: tuple = (),
               device=None) -> dict:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_ch = _dims(cfg)
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "w_in": dense_init(generator, d, 2 * d_inner + 2 * s.state_dim + n_heads,
                           lead, device),
        "conv_w": _randn(generator, (*lead, s.conv_width, conv_ch), device)
        / math.sqrt(s.conv_width),
        "conv_b": torch.zeros((*lead, conv_ch), device=device),
        "a_log": torch.zeros((*lead, n_heads), device=device),  # A = -exp(a_log)
        "dt_bias": torch.zeros((*lead, n_heads), device=device),
        "d_skip": torch.ones((*lead, n_heads), device=device),
        "w_out": dense_init(generator, d_inner, d, lead, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time. x:[B,T,C] w:[W,C]. Returns
    (y, new_tail) where tail carries the last W-1 inputs for decoding."""
    width = w.shape[0]
    if tail is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, T+W-1, C]
    y = sum(xp[:, i: i + x.shape[1], :] * w[i] for i in range(width)) + b
    new_tail = xp[:, -(width - 1):, :] if width > 1 else None
    return y, new_tail


def _split_proj(cfg: LMConfig, proj: torch.Tensor):
    s: SSMConfig = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    z, rest = proj[..., :d_inner], proj[..., d_inner:]
    conv_in = rest[..., : d_inner + 2 * s.state_dim]
    dt = rest[..., d_inner + 2 * s.state_dim:]
    return z, conv_in, dt, d_inner, n_heads


def mamba_apply(p: dict, cfg: LMConfig, x: torch.Tensor,
                cache: Optional[dict] = None):
    """x: [B, T, D] -> ([B, T, D], new_cache): ``new_cache`` holds the
    input cache's tensors, updated in place (None without a cache)."""
    s: SSMConfig = cfg.ssm
    proj = x @ p["w_in"]
    z, conv_in, dt, d_inner, n_heads = _split_proj(cfg, proj)

    tail = cache["conv"] if cache is not None else None
    conv_out, new_tail = _causal_conv(conv_in, p["conv_w"], p["conv_b"], tail)
    conv_out = F.silu(conv_out)
    xs = conv_out[..., :d_inner]
    b_in = conv_out[..., d_inner: d_inner + s.state_dim]  # [B,T,N]
    c_in = conv_out[..., d_inner + s.state_dim:]  # [B,T,N]

    bsz, t, _ = x.shape
    h = n_heads
    pdim = s.head_dim
    xs = xs.reshape(bsz, t, h, pdim)
    dt = F.softplus(dt + p["dt_bias"])  # [B,T,H]
    a = -torch.exp(p["a_log"])  # [H]
    decay = torch.exp(dt * a)  # [B,T,H] per-step decay
    xdt = xs * dt[..., None]  # [B,T,H,P] — never materialise [T,H,P,N]

    state0 = cache["state"] if cache is not None else torch.zeros(
        (bsz, h, pdim, s.state_dim), dtype=torch.float32, device=x.device)

    if t == 1:
        # recurrent decode step: h = decay*h + B ⊗ xdt ; y = h · C
        upd = torch.einsum("bhp,bn->bhpn", xdt[:, 0], b_in[:, 0])
        new_state = state0 * decay[:, 0, :, None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", *_up(new_state, c_in[:, 0]))[:, None]
    else:
        y, new_state = _chunked_ssd(decay, xdt, b_in, c_in, state0, s.chunk)

    y = y + xs * p["d_skip"][:, None]  # D skip per head
    # state math runs in f32 for stability; the stream stays compute-dtype
    y = y.reshape(bsz, t, d_inner).to(x.dtype) * F.silu(z)
    out = y @ p["w_out"]
    new_cache = None
    if cache is not None:
        cache["conv"].copy_(new_tail)
        cache["state"].copy_(new_state)
        new_cache = {"conv": cache["conv"], "state": cache["state"]}
    return out, new_cache


def _segsum(logs: torch.Tensor) -> torch.Tensor:
    """``rel[..., i, j, :] = logs[..., j+1, :] + ... + logs[..., i, :]``
    over a chunk's axis 2 (the log decay from source j to output i, 0 on
    the diagonal), as ``[B, NC, c, c, H]``: each entry summed from its own
    terms (a cumulative sum over i of the terms past j), not as the
    difference ``cum_i - cum_j`` of two prefix sums, which loses ~1e-5 of
    a weight near the diagonal once a chunk's prefix sums reach ~90 in
    float32. Entries above the diagonal (j > i) are left for
    ``_decay_mask``."""
    c = logs.shape[2]
    past = torch.ones((c, c), dtype=torch.bool, device=logs.device).tril(-1)  # l > j
    terms = logs[:, :, :, None, :].masked_fill(~past[:, :, None], 0.0)
    return torch.cumsum(terms, dim=2)


def _decay_mask(rel: torch.Tensor) -> torch.Tensor:
    """``exp(rel)`` on and below the diagonal of a chunk's (i, j) axes
    (2 and 3), 0 above it: ``rel`` is masked with -inf before the ``exp``,
    so no entry overflows and the gradient stays finite."""
    c = rel.shape[2]
    above = torch.ones((c, c), dtype=torch.bool, device=rel.device).triu(1)
    return rel.masked_fill(above[:, :, None], float("-inf")).exp()


def _chunked_ssd(decay, xdt, b_in, c_in, state0, chunk):
    """Chunked SSD in factored form (the Mamba2 algorithm's structure).

    decay:[B,T,H] xdt:[B,T,H,P] b_in/c_in:[B,T,N]. Intra-chunk term uses the
    (C Bᵀ ∘ L) X decomposition so the largest intermediates are the
    [B,NC,c,c] Gram matrix and the [B,NC,c,c,H] decay mask — O(T·c·H), not
    O(T·H·P·N).
    """
    bsz, t, h = decay.shape
    pdim = xdt.shape[-1]
    n = b_in.shape[-1]
    c = min(chunk, t)
    if t % c != 0:
        pad = c - t % c
        decay = F.pad(decay, (0, 0, 0, pad), value=1.0)
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    t_pad = decay.shape[1]
    nc = t_pad // c

    dec = decay.reshape(bsz, nc, c, h)
    xc = xdt.reshape(bsz, nc, c, h, pdim)
    bb = b_in.reshape(bsz, nc, c, n)
    cc = c_in.reshape(bsz, nc, c, n)

    logdec = torch.log(dec.clamp(min=1e-20))
    cum = torch.cumsum(logdec, dim=2)  # [B,NC,c,H], log prod_{l<=i}
    # decay weight of source j on output i (j<=i): exp(cum_i - cum_j)
    rel = _segsum(logdec)  # [B,NC,i,j,H]
    w = _decay_mask(rel)
    g = torch.einsum("bkin,bkjn->bkij", cc, bb)  # C·Bᵀ Gram
    intra = torch.einsum("bkijh,bkjhp->bkihp", g[..., None] * w, xc)

    # chunk summaries for the inter-chunk recurrence
    total = torch.exp(cum[:, :, -1, :])  # [B,NC,H]
    after = torch.exp(rel[:, :, -1])  # decay j -> chunk end
    chunk_state = torch.einsum("bkjn,bkjhp->bkhpn", bb, after[..., None] * xc)

    state = state0
    entering = []  # the state *entering* each chunk
    for k in range(nc):
        entering.append(state)
        state = state * total[:, k, :, None, None] + chunk_state[:, k]
    entering = torch.stack(entering, dim=1)  # [B,NC,H,P,N]

    # inter-chunk: y_i += C_i · (exp(cum_i) * h_entering)
    inter = (torch.einsum("bkin,bkhpn->bkihp", *_up(cc, entering))
             * torch.exp(cum)[..., None])
    y = (intra + inter).reshape(bsz, t_pad, h, pdim)[:, :t]
    return y, state


def mamba_cache_init(cfg: LMConfig, batch: int, dtype=torch.float32,
                     lead: tuple = (), device=None) -> dict:
    """A zeroed conv tail ``[*lead, B, W-1, conv_ch]`` (``dtype``) and SSM
    state ``[*lead, B, H, P, N]`` (float32)."""
    s: SSMConfig = cfg.ssm
    _, n_heads, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((*lead, batch, s.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((*lead, batch, n_heads, s.head_dim, s.state_dim),
                             dtype=torch.float32, device=device),
    }
