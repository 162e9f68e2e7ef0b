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
``_attn_core``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import LMConfig, MLAConfig
from repro_torch.distributed.tensor_parallel import (
    copy_to_model,
    model_shard,
    reduce_from_model,
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
    attention (``_cross``) and returns ``cache`` unchanged. The heads are
    the weights' own (a rank's shard under tensor parallelism: its input
    passes ``copy_to_model``, and ``wo``'s partial products are summed
    over ``model``)."""
    b, t, _ = x.shape
    dh = cfg.resolved_head_dim
    h, kv = p["wq"].shape[-1] // dh, p["wk"].shape[-1] // dh
    x = copy_to_model(x)
    q = dot(x, p["wq"]).reshape(b, t, h, dh)
    if kv_source is not None:
        return _cross(p, cfg, q, kv_source, cache, inner), cache
    k = (x @ p["wk"]).reshape(b, t, kv, dh)
    v = (x @ p["wv"]).reshape(b, t, kv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        mask = make_mask(positions, positions, causal=True, window=window)
        out = _attn_core(q, k, v, mask)
        return reduce_from_model(out.reshape(b, t, h * dh) @ p["wo"]), None

    idx = cache["idx"]
    ck, cv = cache["k"], cache["v"]
    s_max = ck.shape[1]
    if idx + t > s_max:
        raise ValueError(f"the cache holds {s_max} positions; {idx} are filled "
                         f"and {t} more do not fit")
    ck[:, idx:idx + t] = k.to(ck.dtype)
    cv[:, idx:idx + t] = v.to(cv.dtype)
    if idx == 0 and t > 1 and not window:
        # the keys as the cache holds them, at q's dtype (as JAX reads them)
        kc, vc = (c[:, :t].to(q.dtype) for c in (ck, cv))
        out = _executor(inner, "flash")(
            q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            causal=True).transpose(1, 2)
    else:
        k_pos = torch.arange(s_max, device=x.device)
        k_valid = (k_pos < idx + t)[None, :].expand(b, s_max)
        mask = make_mask(positions, k_pos, causal=True, window=window,
                         k_valid=k_valid)
        out = _attn_core(q, ck.to(q.dtype), cv.to(q.dtype), mask)
    new_cache = {"k": ck, "v": cv, "idx": idx + t}
    return reduce_from_model(out.reshape(b, t, h * dh) @ p["wo"]), new_cache


def _cross(p: dict, cfg: LMConfig, q: torch.Tensor, src: torch.Tensor,
           cache: Optional[dict], inner: str) -> torch.Tensor:
    """Cross attention of ``q`` [B, T, H, Dh] over ``src`` [B, Tk, D]: no
    RoPE, every key visible. A serving call of more than one query whose
    q, k and v share a dtype runs ``inner``'s flash with ``causal=False``;
    decode, the uncached forward and loss, and bfloat16 queries against
    float32 memory (bfloat16 training) take ``_attn_core`` with a zero
    mask, whose promotions are the JAX package's."""
    b, t, h, dh = q.shape
    tk, kv = src.shape[1], cfg.n_kv_heads
    k = dot(src, p["wk"]).reshape(b, tk, kv, dh)
    v = dot(src, p["wv"]).reshape(b, tk, kv, dh)
    if cache is not None and t > 1 and q.dtype == k.dtype:
        out = _executor(inner, "flash")(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=False).transpose(1, 2)
    else:
        mask = torch.zeros((1, 1, t, tk), dtype=torch.float32, device=q.device)
        out = _attn_core(q, k, v, mask)
    return dot(out.reshape(b, t, h * dh), p["wo"])


def gqa_cache_init(cfg: LMConfig, batch: int, s_max: int,
                   dtype=torch.bfloat16, lead: tuple = (), device=None) -> dict:
    """Zeroed ``k``/``v`` ``[*lead, B, S, KV, Dh]`` (the index lives at the
    cache's root, ``LM.init_cache``), KV the rank's heads under tensor
    parallelism (``cache_spec``'s split)."""
    kv, dh = model_shard(cfg.n_kv_heads), cfg.resolved_head_dim
    return {"k": torch.zeros((*lead, batch, s_max, kv, dh), dtype=dtype, device=device),
            "v": torch.zeros((*lead, batch, s_max, kv, dh), dtype=dtype, device=device)}


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
    causal and valid below ``idx + t``."""
    m: MLAConfig = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    r, nope, rope_d, vdim = (m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim,
                             m.v_head_dim)
    q = ((x @ p["wq_a"]) @ p["wq_b"]).reshape(b, t, h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    latent_new = x @ p["wkv_a"]  # [B, T, R + rope_d]
    k_rope_new = apply_rope(latent_new[..., r:][:, :, None, :], positions,
                            cfg.rope_theta)[:, :, 0, :]
    latent_new = torch.cat([latent_new[..., :r], k_rope_new], -1)

    if cache is None:
        latent, k_pos, k_valid = latent_new, positions, None
    else:
        idx = cache["idx"]
        latent = cache["latent"]
        s_max = latent.shape[1]
        if idx + t > s_max:
            raise ValueError(f"the cache holds {s_max} positions; {idx} are filled "
                             f"and {t} more do not fit")
        latent[:, idx:idx + t] = latent_new.to(latent.dtype)
        k_pos = torch.arange(s_max, device=x.device)
        k_valid = (k_pos < idx + t)[None, :].expand(b, s_max)

    s = latent.shape[1]
    kv = (latent[..., :r].to(x.dtype) @ p["wkv_b"]).reshape(b, s, h, nope + vdim)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k_rope = latent[..., r:].to(x.dtype)[:, :, None, :].expand(b, s, h, rope_d)
    qk = torch.cat([q_nope, q_rope], -1)
    kk = torch.cat([k_nope, k_rope], -1)
    mask = make_mask(positions, k_pos, causal=True, k_valid=k_valid)
    out = _attn_core(qk, kk, v, mask).reshape(b, t, h * vdim) @ p["wo"]
    new_cache = None if cache is None else {"latent": latent, "idx": idx + t}
    return out, new_cache


def mla_cache_init(cfg: LMConfig, batch: int, s_max: int, dtype=torch.bfloat16,
                   lead: tuple = (), device=None) -> dict:
    """A zeroed latent ``[*lead, B, S, kv_lora_rank + qk_rope_head_dim]``
    (the index lives at the cache's root, ``LM.init_cache``)."""
    m: MLAConfig = cfg.mla
    return {"latent": torch.zeros((*lead, batch, s_max, m.kv_lora_rank + m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
