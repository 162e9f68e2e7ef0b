"""Attention for the LM substrate: GQA (+RoPE, sliding window, cross) and MLA.

Counterpart of ``repro/models/attention.py``: one masked softmax core
(``_attn_core``, the JAX package's plain attention) and the flash kernel
where it computes the same function. A prefill of a cache from index 0 by
a layer without a window is causal self-attention over the ``t`` fresh
keys starting at position 0, which is exactly what the flash kernel
computes (``kernels/flash_attention.py``, causal, top-left): there the
attention runs through the ``inner`` executor's ``"flash"`` op, the
Hopper kernel for ``inner="cuda"`` on the card. The JAX package's mask
over all ``s_max`` cache slots gives the same result, since causality
already hides every key at or beyond ``t``. Cross attention
(``kv_source``: whisper's encoder over its frames, and each decoder
layer over the encoder's output) has no RoPE, writes no cache and sees
every key, the JAX package's zero mask: in a serving call (a cache
given, which it returns unchanged) of more than one query it is the
flash kernel with ``causal=False``. Every other case (decode against the
cache, a cache index past 0, the uncached forward and loss, which need
gradients the kernel does not give, and every call of a layer with a
sliding window) is ``_attn_core``: the Pallas kernel has no window, so a
windowed layer's mask stays where the JAX package puts it
(``make_mask(..., window=)``).

The cache's tensors are updated in place (the JAX package returns new
arrays): a cache dict holds ``k``/``v`` ``[B, S, KV, Dh]`` and the index
``idx`` as a Python int on the host. DeepSeek-V3's multi-head latent
attention (``mla_apply``) caches only the compressed latent ``[B, S,
kv_lora_rank + qk_rope_head_dim]``, written in place the same way, and
rebuilds K and V from it through ``wkv_b`` at every call; its query and
key width (nope + rope) differs from its value width, so it always takes
``_attn_core``. Under the sharding rules MLA attends for the heads of
the rank's ``wq_b`` and ``wkv_b`` columns, and its latent cache holds the
rank's block of positions (``mla_apply``); cross attention takes the
query heads and the KV heads of the rank's ``wq``/``wk``/``wv`` columns
as self attention does (``_cross``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import LMConfig, MLAConfig
from repro_torch.distributed.tensor_parallel import (
    all_reduce_model,
    copy_to_model,
    gather_model_cols,
    gather_model_positions,
    latent_shards,
    model_coord,
    model_shard,
    reduce_from_model,
    seq_shards,
)
from repro_torch.kernels.ops import _executor
from repro_torch.models.layers import apply_rope, dense_init, dot

NEG_INF = -2.0e38


def _attn_core(q, k, v, mask) -> torch.Tensor:
    """q:[B,Tq,H,Dh] k:[B,Tk,KV,Dh] v:[B,Tk,KV,Dv] mask:[B|1,1,Tq,Tk]
    (additive) -> [B,Tq,H,Dv]. Logits and softmax in float32, the
    probabilities rounded to q's dtype and multiplied with v at the two's
    promoted dtype, the result at q's dtype, as in the JAX package (in
    bfloat16 training whisper's cross attention meets a bfloat16 q with
    float32 keys and values)."""
    b, tq, h, dh = q.shape
    kv = k.shape[2]
    dv = v.shape[-1]
    groups = h // kv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, tq, kv, groups, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    logits = logits + mask[:, :, None, :, :]  # broadcast over groups
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(dt), v.to(dt))
    return out.reshape(b, tq, h, dv).to(q.dtype)


def make_mask(
    q_pos: torch.Tensor,  # [Tq] absolute positions of queries
    k_pos: torch.Tensor,  # [Tk] absolute positions of keys
    causal: bool,
    window: Optional[int] = None,  # 0/None => unlimited
    k_valid: Optional[torch.Tensor] = None,  # [B, Tk] cache validity
) -> torch.Tensor:
    """Additive float32 mask [B|1, 1, Tq, Tk]: 0 where a query sees a key,
    ``NEG_INF`` where it does not (``-inf`` where both rules hide it, as
    the JAX package's float32 sum of two ``NEG_INF`` overflows). A
    ``window`` > 0 keeps only keys less than ``max(window, 1)`` positions
    behind the query."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        ok = ok & (diff >= 0)
    if window:
        ok = ok & (diff < max(window, 1))
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=diff.device)
    mask = torch.where(ok, zero, neg)[None, None, :, :]
    if k_valid is not None:
        mask = mask + torch.where(k_valid, zero, neg)[:, None, None, :]
    return mask


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_init(generator: torch.Generator, cfg: LMConfig, lead: tuple = (),
             device=None) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {"wq": dense_init(generator, d, h * dh, lead, device),
            "wk": dense_init(generator, d, kv * dh, lead, device),
            "wv": dense_init(generator, d, kv * dh, lead, device),
            "wo": dense_init(generator, h * dh, d, lead, device)}


@dataclasses.dataclass(frozen=True)
class _Split:
    """A rank's share of a GQA layer's heads under the active rules."""

    tp: bool  # wq / wo are the rank's column / row shard over ``model``
    lo: int  # the whole query heads [lo, hi) the rank attends for
    hi: int
    c0: int  # the rank's first wq column, counted from head lo's first
    width: int  # the rank's wq columns
    q_gather: bool  # those columns split a head: q gathered over ``model``
    kv_lo: int  # the KV heads [kv_lo, kv_hi) those query heads read
    kv_hi: int
    k_local: bool  # wk's columns are exactly those KV heads
    k_rep: bool  # wk / wv replicated beside sharded heads


def _split(cfg: LMConfig, p: dict) -> _Split:
    """The rank's heads, read from its ``wq`` and ``wk`` columns (the
    shards ``param_spec`` gives it): whole heads where ``H·Dh / model``
    covers them, else the heads its columns touch."""
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    w, wk = p["wq"].shape[-1], p["wk"].shape[-1]
    if w == h * dh:
        return _Split(False, 0, h, 0, w, False, 0, kv, True, wk == kv * dh)
    g = h // kv
    start = model_coord() * w
    lo, hi = start // dh, -(-(start + w) // dh)
    kv_lo, kv_hi = lo // g, (hi - 1) // g + 1
    k_rep = wk == kv * dh
    k_local = not k_rep and model_coord() * wk == kv_lo * dh and wk == (kv_hi - kv_lo) * dh
    return _Split(True, lo, hi, start - lo * dh, w, start % dh != 0 or w % dh != 0,
                  kv_lo, kv_hi, k_local, k_rep)


def _select_kv(k: torch.Tensor, sp: _Split, g: int) -> torch.Tensor:
    """The KV heads the rank's query heads read, from ``k`` [B, S, KV, Dh]
    holding every KV head, laid out so that ``_attn_core`` and flash pair
    them as GQA does: a slice where the heads fall in equal groups, else
    one KV head a query head."""
    want = [hh // g for hh in range(sp.lo, sp.hi)]
    n = sp.kv_hi - sp.kv_lo
    hl = sp.hi - sp.lo
    if hl % n == 0 and want == [sp.kv_lo + i // (hl // n) for i in range(hl)]:
        return k[:, :, sp.kv_lo:sp.kv_hi]
    return k[:, :, want]


def _kv_cols(p: dict, sp: _Split, src: torch.Tensor) -> tuple:
    """K and V columns of ``src`` through the rank's ``wk``/``wv``: every KV
    head where its columns are not whole heads (gathered over ``model``:
    RoPE and the softmax need a head's whole ``Dh``), a replicated leaf
    beside sharded heads passing ``copy_to_model``."""
    wk, wv = p["wk"], p["wv"]
    if sp.tp and sp.k_rep:  # a replicated leaf inside the sharded product
        wk, wv = copy_to_model(wk), copy_to_model(wv)
    k, v = dot(src, wk), dot(src, wv)
    if sp.tp and not sp.k_local and not sp.k_rep:
        k, v = gather_model_cols(k), gather_model_cols(v)
    return k, v


def _out_proj(p: dict, sp: _Split, out: torch.Tensor) -> torch.Tensor:
    """``out`` [B, T, hl·Dh] through ``wo``: the rank's own columns of the
    heads it attended for, its rows of ``wo``, summed over ``model``."""
    if sp.tp and out.shape[-1] != sp.width:
        out = out[..., sp.c0:sp.c0 + sp.width]
    out = dot(out, p["wo"])
    return reduce_from_model(out) if sp.tp else out


def gqa_apply(
    p: dict,
    cfg: LMConfig,
    x: torch.Tensor,  # [B, T, D]
    positions: torch.Tensor,  # [T]
    *,
    window: int = 0,  # 0 => unlimited; > 0 a sliding window
    cache: Optional[dict] = None,  # {"k": [B,S,KV,Dh], "v": ..., "idx": int}
    kv_source: Optional[torch.Tensor] = None,  # cross attention's memory [B,Tk,D]
    inner: str = "cuda",
):
    """Returns ``(out [B, T, D], new_cache)``; ``new_cache`` shares the
    input cache's (updated) tensors and holds ``idx + t``. ``inner`` picks
    the prefill attention's executor where the layer has no ``window``:
    ``"cuda"`` the flash kernel (its plain version for CPU tensors),
    ``"torch"`` the plain version. With ``kv_source`` the call is cross
    attention (``_cross``) and returns ``cache`` unchanged.

    Under tensor parallelism the heads are the rank's shard (``_split``):
    its input passes ``copy_to_model`` and ``wo``'s partial products are
    summed over ``model``. Where its ``wq`` columns split a head, the
    rank gathers q over ``model`` and attends for the whole heads its
    columns touch, keeping its own columns of their output; where its
    ``wk`` columns are not whole KV heads, K and V are gathered whole
    (RoPE and the softmax need a head's whole ``Dh``). A cache whose KV
    heads do not divide the model axis holds ``S / model`` positions of
    every KV head (``seq_shards`` of them, the rank's the ``model_coord``-th
    block): a rank writes only the positions it owns; a prefill from
    position 0 without a window runs flash on the rank's query heads
    against the fresh K and V, every other call attends for every head
    over the rank's positions, masked at global positions, and the
    partial softmaxes (max, sum, output) combine over ``model`` in
    float32 (``_attn_partials``)."""
    b, t, _ = x.shape
    dh = cfg.resolved_head_dim
    if kv_source is not None:
        return _cross(p, cfg, x, kv_source, cache, inner), cache
    sp = _split(cfg, p)
    g = cfg.n_heads // cfg.n_kv_heads
    hl = sp.hi - sp.lo
    xin = copy_to_model(x) if sp.tp else x
    q_cols = dot(xin, p["wq"])
    k, v = _kv_cols(p, sp, xin)
    k = apply_rope(k.reshape(b, t, -1, dh), positions, cfg.rope_theta)
    v = v.reshape(b, t, -1, dh)

    def own_q():
        cols = gather_model_cols(q_cols)[..., sp.lo * dh:sp.hi * dh] if sp.q_gather \
            else q_cols
        return apply_rope(cols.reshape(b, t, hl, dh), positions, cfg.rope_theta)

    def kv_of(kk):
        return kk if sp.k_local else _select_kv(kk, sp, g)

    def finish(out):  # [B, T, hl, Dh] -> [B, T, D]
        return _out_proj(p, sp, out.reshape(b, t, hl * dh))

    if cache is None:
        mask = make_mask(positions, positions, causal=True, window=window)
        return finish(_attn_core(own_q(), kv_of(k), kv_of(v), mask)), None

    idx = cache["idx"]
    ck, cv = cache["k"], cache["v"]
    shards = cache.get("seq_shards", 1)
    s_local = ck.shape[1]
    s_max = s_local * shards
    if idx + t > s_max:
        raise ValueError(f"the cache holds {s_max} positions; {idx} are filled "
                         f"and {t} more do not fit")
    off = model_coord() * s_local if shards > 1 else 0
    lo, hi = max(idx, off), min(idx + t, off + s_local)
    if lo < hi:  # the fresh positions this rank holds
        ck[:, lo - off:hi - off] = k[:, lo - idx:hi - idx].to(ck.dtype)
        cv[:, lo - off:hi - off] = v[:, lo - idx:hi - idx].to(cv.dtype)
    new_cache = {"k": ck, "v": cv, "idx": idx + t}
    if shards > 1:
        new_cache["seq_shards"] = shards
    if idx == 0 and t > 1 and not window:
        # the keys as the cache holds them, at q's dtype (as JAX reads them)
        if shards > 1:
            kc, vc = (c.to(ck.dtype).to(q_cols.dtype) for c in (k, v))
        else:
            kc, vc = (c[:, :t].to(q_cols.dtype) for c in (ck, cv))
        out = _executor(inner, "flash")(
            own_q().transpose(1, 2), kv_of(kc).transpose(1, 2), kv_of(vc).transpose(1, 2),
            causal=True).transpose(1, 2)
        return finish(out), new_cache
    k_pos = off + torch.arange(s_local, device=x.device)
    k_valid = (k_pos < idx + t)[None, :].expand(b, s_local)
    mask = make_mask(positions, k_pos, causal=True, window=window, k_valid=k_valid)
    if shards == 1:
        out = _attn_core(own_q(), kv_of(ck.to(q_cols.dtype)), kv_of(cv.to(q_cols.dtype)),
                         mask)
        return finish(out), new_cache
    q_all = gather_model_cols(q_cols) if sp.tp else q_cols
    q_all = apply_rope(q_all.reshape(b, t, -1, dh), positions, cfg.rope_theta)
    out = _attn_partials(q_all, ck.to(q_all.dtype), cv.to(q_all.dtype), mask)
    return finish(out[:, :, sp.lo:sp.hi]), new_cache


def _attn_partials(q, k, v, mask) -> torch.Tensor:
    """``_attn_core`` over keys split across the ``model`` ranks (each
    rank's ``k``/``v`` [B, S_local, KV, Dh] and its block of the additive
    mask): the logits in float32, their max over every rank's keys
    (all-reduced with MAX, floored at ``NEG_INF`` so a rank whose keys are
    all hidden adds nothing), then each rank's sum of exponentials and its
    probability-weighted values, summed over ``model`` in float32 (the
    online-softmax rule of the flash kernel, its blocks on the ranks); the
    output at q's dtype. No gradient flows (serving)."""
    b, tq, h, dh = q.shape
    kv = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, tq, kv, h // kv, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    logits = logits + mask[:, :, None, :, :]
    mx = all_reduce_model(logits.amax(-1).clamp(min=NEG_INF), "max")
    e = torch.exp(logits - mx[..., None])
    part = torch.cat([torch.einsum("bkgqs,bskd->bqkgd", e, v.float()),
                      e.sum(-1).permute(0, 3, 1, 2)[..., None]], -1)
    part = all_reduce_model(part)
    out = part[..., :-1] / part[..., -1:]
    return out.reshape(b, tq, h, v.shape[-1]).to(q.dtype)


def _cross(p: dict, cfg: LMConfig, x: torch.Tensor, src: torch.Tensor,
           cache: Optional[dict], inner: str) -> torch.Tensor:
    """Cross attention of ``x`` [B, T, D] over ``src`` [B, Tk, D] (the
    encoder's own input in its layers): no RoPE, every key visible. A
    serving call of more than one query whose q, k and v share a dtype
    runs ``inner``'s flash with ``causal=False``; decode, the uncached
    forward and loss, and bfloat16 queries against float32 memory
    (bfloat16 training) take ``_attn_core`` with a zero mask, whose
    promotions are the JAX package's. Under the rules the heads are the
    rank's (``_split``), as in ``gqa_apply``: ``x`` and ``src`` pass
    ``copy_to_model`` (once where they are one tensor), q is gathered over
    ``model`` where the rank's ``wq`` columns split a head, K and V where
    its ``wk`` columns are not whole KV heads, and ``wo``'s partial
    products are summed over ``model``. K and V are recomputed from
    ``src`` at every call, as in the JAX package."""
    b, t, _ = x.shape
    tk, dh = src.shape[1], cfg.resolved_head_dim
    sp = _split(cfg, p)
    g = cfg.n_heads // cfg.n_kv_heads
    hl = sp.hi - sp.lo
    xin = copy_to_model(x) if sp.tp else x
    src_in = xin if src is x else copy_to_model(src) if sp.tp else src
    q = dot(xin, p["wq"])
    k, v = _kv_cols(p, sp, src_in)
    if sp.q_gather:
        q = gather_model_cols(q)[..., sp.lo * dh:sp.hi * dh]
    q = q.reshape(b, t, hl, dh)
    k, v = k.reshape(b, tk, -1, dh), v.reshape(b, tk, -1, dh)
    if not sp.k_local:
        k, v = _select_kv(k, sp, g), _select_kv(v, sp, g)
    if cache is not None and t > 1 and q.dtype == k.dtype:
        out = _executor(inner, "flash")(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=False).transpose(1, 2)
    else:
        mask = torch.zeros((1, 1, t, tk), dtype=torch.float32, device=q.device)
        out = _attn_core(q, k, v, mask)
    return _out_proj(p, sp, out.reshape(b, t, hl * dh))


def gqa_cache_init(cfg: LMConfig, batch: int, s_max: int,
                   dtype=torch.bfloat16, lead: tuple = (), device=None) -> dict:
    """Zeroed ``k``/``v`` ``[*lead, B, S, KV, Dh]`` (the index lives at the
    cache's root, ``LM.init_cache``), as ``cache_spec`` splits them under
    tensor parallelism: KV the rank's heads where they divide the model
    axis, else S the rank's ``S / model`` positions where those divide it
    (``seq_shards``)."""
    kv, dh = model_shard(cfg.n_kv_heads), cfg.resolved_head_dim
    s = s_max // seq_shards(cfg.n_kv_heads, s_max)
    return {"k": torch.zeros((*lead, batch, s, kv, dh), dtype=dtype, device=device),
            "v": torch.zeros((*lead, batch, s, kv, dh), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): low-rank Q/KV with decoupled RoPE, latent KV cache
# ---------------------------------------------------------------------------

def mla_init(generator: torch.Generator, cfg: LMConfig, lead: tuple = (),
             device=None) -> dict:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {"wq_a": dense_init(generator, d, m.q_lora_rank, lead, device),
            "wq_b": dense_init(generator, m.q_lora_rank, h * qk_head, lead, device),
            "wkv_a": dense_init(generator, d, m.kv_lora_rank + m.qk_rope_head_dim,
                                lead, device),
            "wkv_b": dense_init(generator, m.kv_lora_rank,
                                h * (m.qk_nope_head_dim + m.v_head_dim), lead, device),
            "wo": dense_init(generator, h * m.v_head_dim, d, lead, device)}


def _mla_heads(cfg: LMConfig, p: dict) -> int:
    """The heads of the rank's ``wq_b`` columns: all of them where the
    rules leave it whole, else ``n_heads / model`` (``check_tp`` refuses a
    split below one head)."""
    m = cfg.mla
    return p["wq_b"].shape[-1] // (m.qk_nope_head_dim + m.qk_rope_head_dim)


def mla_apply(
    p: dict,
    cfg: LMConfig,
    x: torch.Tensor,  # [B, T, D]
    positions: torch.Tensor,  # [T]
    cache: Optional[dict] = None,  # {"latent": [B, S, R + rope], "idx": int}
):
    """Returns ``(out [B, T, D], new_cache)``. Queries through ``wq_a``
    then ``wq_b``, RoPE on their last ``qk_rope_head_dim`` columns; the
    latent ``x @ wkv_a``, RoPE on its rope part (one head shared by all);
    K and V rebuilt from the latent (read at x's dtype, as the JAX package
    reads its cache) through ``wkv_b``; the mask over every cache slot,
    causal and valid below ``idx + t``.

    Under the rules the rank attends for the heads of its ``wq_b`` and
    ``wkv_b`` columns (``wo`` its rows of them, summed over ``model``);
    ``wq_a`` and ``wkv_a`` are replicated, so the query latent and the KV
    latent (both parts: the rope part is every head's key too) pass
    ``copy_to_model`` before the sharded products. A latent cache split
    by position (``seq_shards`` of ``s_max / model`` positions, the rank's
    the ``model_coord``-th block) takes the fresh positions the rank owns,
    and is gathered whole over ``model`` (``gather_model_positions``)
    before ``wkv_b``: every head needs every position's latent."""
    m: MLAConfig = cfg.mla
    b, t, _ = x.shape
    hl = _mla_heads(cfg, p)
    tp = hl != cfg.n_heads
    r, nope, rope_d, vdim = (m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim,
                             m.v_head_dim)
    q_lat = x @ p["wq_a"]
    q = ((copy_to_model(q_lat) if tp else q_lat) @ p["wq_b"]).reshape(
        b, t, hl, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    latent_new = x @ p["wkv_a"]  # [B, T, R + rope_d]
    k_rope_new = apply_rope(latent_new[..., r:][:, :, None, :], positions,
                            cfg.rope_theta)[:, :, 0, :]
    latent_new = torch.cat([latent_new[..., :r], k_rope_new], -1)

    if cache is None:
        latent, k_pos, k_valid = latent_new, positions, None
        if tp:
            latent = copy_to_model(latent)
    else:
        idx = cache["idx"]
        local = cache["latent"]
        shards = cache.get("seq_shards", 1)
        s_local = local.shape[1]
        s_max = s_local * shards
        if idx + t > s_max:
            raise ValueError(f"the cache holds {s_max} positions; {idx} are filled "
                             f"and {t} more do not fit")
        off = model_coord() * s_local if shards > 1 else 0
        lo, hi = max(idx, off), min(idx + t, off + s_local)
        if lo < hi:  # the fresh positions this rank holds
            local[:, lo - off:hi - off] = latent_new[:, lo - idx:hi - idx].to(local.dtype)
        latent = gather_model_positions(local) if shards > 1 else local
        k_pos = torch.arange(s_max, device=x.device)
        k_valid = (k_pos < idx + t)[None, :].expand(b, s_max)

    s = latent.shape[1]
    kv = (latent[..., :r].to(x.dtype) @ p["wkv_b"]).reshape(b, s, hl, nope + vdim)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k_rope = latent[..., r:].to(x.dtype)[:, :, None, :].expand(b, s, hl, rope_d)
    qk = torch.cat([q_nope, q_rope], -1)
    kk = torch.cat([k_nope, k_rope], -1)
    mask = make_mask(positions, k_pos, causal=True, k_valid=k_valid)
    out = _attn_core(qk, kk, v, mask).reshape(b, t, hl * vdim) @ p["wo"]
    if tp:
        out = reduce_from_model(out)
    if cache is None:
        return out, None
    new_cache = {"latent": local, "idx": idx + t}
    if shards > 1:
        new_cache["seq_shards"] = shards
    return out, new_cache


def mla_cache_init(cfg: LMConfig, batch: int, s_max: int, dtype=torch.bfloat16,
                   lead: tuple = (), device=None) -> dict:
    """A zeroed latent ``[*lead, B, S, kv_lora_rank + qk_rope_head_dim]``
    (the index lives at the cache's root, ``LM.init_cache``): under the
    rules the rank's ``S / model`` positions where they divide the model
    axis (``latent_shards``), as ``cache_spec`` splits it."""
    m: MLAConfig = cfg.mla
    s = s_max // latent_shards(s_max)
    return {"latent": torch.zeros((*lead, batch, s, m.kv_lora_rank + m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
