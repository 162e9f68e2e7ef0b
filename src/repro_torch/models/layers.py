"""Shared LM building blocks: norms, MLPs, embeddings, RoPE.

Counterpart of ``repro/models/layers.py``, with its parameter names and
layouts (weights ``[d_in, d_out]``, applied as ``x @ w``), so
``models/transformer.py:params_from_jax`` carries the JAX package's
weights over unchanged. Initialisers draw from an explicit
``torch.Generator`` on the generator's device and place the result on
``device``. Under sharding rules with a ``model`` axis
(``distributed/tensor_parallel.py``) the MLP's column products take
``copy_to_model``'s input and its row product's output is summed over
``model``, the lookup reads the rank's vocabulary shard (summed at
``tokens_bsd``) and the unembedding gives the rank's vocabulary slice of
the logits; without rules each is the one-card function.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.tensor_parallel import (
    copy_to_model,
    embed_rows,
    model_coord,
    model_sharded,
    reduce_from_model,
)


def _randn(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(device)


def norm_init(kind: str, d: int, lead: tuple = (), device=None) -> dict:
    """RMSNorm ``{"scale"}`` or LayerNorm ``{"scale", "bias"}`` (ones and
    zeros), with ``lead`` leading axes (a stacked segment's repetitions)."""
    p = {"scale": torch.ones((*lead, d), device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((*lead, d), device=device)
    return p


def apply_norm(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis, eps 1e-6, in float32, the
    result in x's dtype."""
    x32 = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + 1e-6) * p["scale"]
    else:
        mean = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
        out = (x32 - mean) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]
    return out.to(x.dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               lead: tuple = (), device=None) -> torch.Tensor:
    """A ``[*lead, d_in, d_out]`` weight, normal with std ``1/sqrt(d_in)``."""
    return _randn(generator, (*lead, d_in, d_out), device) * (1.0 / math.sqrt(d_in))


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             activation: str, lead: tuple = (), device=None) -> dict:
    if activation == "swiglu":
        return {"w_gate": dense_init(generator, d_model, d_ff, lead, device),
                "w_up": dense_init(generator, d_model, d_ff, lead, device),
                "w_down": dense_init(generator, d_ff, d_model, lead, device)}
    return {"w_in": dense_init(generator, d_model, d_ff, lead, device),
            "b_in": torch.zeros((*lead, d_ff), device=device),
            "w_out": dense_init(generator, d_ff, d_model, lead, device),
            "b_out": torch.zeros((*lead, d_model), device=device)}


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` at the two operands' promoted dtype, as ``jnp.matmul``
    promotes them (``torch.matmul`` refuses mixed dtypes): in bfloat16
    training the whisper encoder's float32 frames meet bfloat16 weights,
    which the JAX package upcasts."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def apply_mlp(p: dict, x: torch.Tensor, activation: str,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """SwiGLU ``(silu(x·W_gate) ⊙ x·W_up)·W_down``, or GELU (tanh
    approximation, as ``jax.nn.gelu``'s default) with biases, its products
    at the promoted dtype (``dot``: whisper's encoder). Where the rules
    shard ``d_ff`` (the whole width; None: wherever a ``model`` axis is
    active) the weights are the rank's shards: the input passes
    ``copy_to_model``, the rank adds its columns of the replicated
    ``b_in`` (through ``copy_to_model``, so its gradient comes back whole
    on every model rank), the row product is summed over ``model`` and
    ``b_out`` added once after it; else the MLP runs replicated."""
    if not model_sharded(d_ff):
        if activation == "swiglu":
            return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
        h = F.gelu(dot(x, p["w_in"]) + p["b_in"], approximate="tanh")
        return dot(h, p["w_out"]) + p["b_out"]
    x = copy_to_model(x)
    if activation == "swiglu":
        return reduce_from_model(
            (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"])
    cols = p["w_in"].shape[-1]
    b_in = p["b_in"]
    if b_in.shape[-1] != cols:
        b_in = copy_to_model(b_in).narrow(-1, model_coord() * cols, cols)
    h = F.gelu(dot(x, p["w_in"]) + b_in, approximate="tanh")
    return reduce_from_model(dot(h, p["w_out"])) + p["b_out"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., T, H, Dh]; positions: [..., T]. The half-split form: the
    first and second halves of each head are the pair's two coordinates
    (not interleaved pairs); angles in float32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None, None].float() * freqs  # [..., T, 1, Dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(generator: torch.Generator, vocab: int, d_model: int,
               device=None) -> dict:
    return {"table": _randn(generator, (vocab, d_model), device) * 0.02}


def embed_lookup(p: dict, tokens: torch.Tensor, vocab: Optional[int] = None) -> torch.Tensor:
    """The one-hot product as a gather of the table's rows (over a
    vocabulary shard, the ranks' lookups summed: ``embed_rows``; ``vocab``
    the whole table's rows)."""
    return embed_rows(p["table"], tokens, vocab)


def embed_dense_path(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The dense path, ``one_hot(tokens) @ table``, kept for the crossover
    tests beside the gather."""
    onehot = F.one_hot(tokens.long(), p["table"].shape[0]).to(p["table"].dtype)
    return onehot @ p["table"]


def unembed(p: dict, x: torch.Tensor, vocab: Optional[int] = None) -> torch.Tensor:
    """The logits over the table's rows: the rank's vocabulary slice where
    the table is a shard (fewer rows than ``vocab``; None: a shard wherever
    a ``model`` axis is active), else all of them."""
    if model_sharded(None) and p["table"].shape[0] != vocab:
        x = copy_to_model(x)
    return x @ p["table"].T
