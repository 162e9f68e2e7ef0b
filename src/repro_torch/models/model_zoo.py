"""Model registry, parameter counting and step closures for the LM substrate.

Counterpart of ``repro/models/model_zoo.py``: ``build_model(cfg)`` -> LM,
``count_params`` (the closed form, copied: N for the 6·N·D roofline term,
``active_only`` counting only routed-in experts), the training step
``make_train_step`` and ``make_eval_step``, the serving steps
``make_prefill_step`` / ``make_decode_step``, and ``make_dummy_batch``.
The port runs eagerly, so the steps are closures over the model; a
training step is autograd over ``LM.loss`` and one ``opt.update``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.distributed.fsdp import data_mean
from repro_torch.distributed.tensor_parallel import mean_over_data
from repro_torch.models import loops
from repro_torch.models.transformer import LM
from repro_torch.models.xlstm import SLSTM_FF_MULT
from repro_torch.training.grad import accum_add, accum_init, accum_mean
from repro_torch.training.optimizer import Optimizer, tree_leaves, tree_map, tree_unflatten


def build_model(cfg: LMConfig, inner: str = "cuda", remat: str = "layer") -> LM:
    """The LM for ``cfg`` with ``inner``'s prefill attention (``"cuda"``
    the flash kernel, ``"torch"`` its plain version) and ``remat``'s
    recomputation in training (``"layer"`` or ``"none"``)."""
    return LM(cfg, inner=inner, remat=remat)


# ---------------------------------------------------------------------------
# Parameter counting (closed-form; validated against init in tests)
# ---------------------------------------------------------------------------

def count_params(cfg: LMConfig, active_only: bool = False) -> int:
    """The JAX package's closed form, for every family; like it, it leaves
    out the final norm's ``d_model`` scales."""
    d = cfg.d_model
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    total = cfg.padded_vocab() * d  # embed
    if not cfg.tie_embeddings:
        total += cfg.padded_vocab() * d  # head

    def attn_params() -> int:
        if cfg.mla:
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            return (d * m.q_lora_rank + m.q_lora_rank * h * qk
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                    + h * m.v_head_dim * d)
        return d * h * dh + 2 * d * kv * dh + h * dh * d

    def mlp_params(width: int) -> int:
        if cfg.activation == "swiglu":
            return 3 * d * width
        return 2 * d * width + width + d

    def moe_params(active: bool) -> int:
        m = cfg.moe
        e_count = m.n_experts_per_token if active else m.n_experts
        p = e_count * 3 * d * m.d_ff_expert + d * m.n_experts
        if m.n_shared_experts:
            p += 3 * d * m.d_ff_expert * m.n_shared_experts
        return p

    def mamba_params() -> int:
        s = cfg.ssm
        d_inner = s.expand * d
        nh = d_inner // s.head_dim
        conv_ch = d_inner + 2 * s.state_dim
        return (d * (2 * d_inner + 2 * s.state_dim + nh)
                + s.conv_width * conv_ch + conv_ch
                + 3 * nh + d_inner * d)

    def mlstm_params() -> int:
        return 5 * d * d + 2 * d * h + (d // h) * h  # q,k,v,up,out + gates + skip

    def slstm_params() -> int:
        d_ff = int(-(-d * SLSTM_FF_MULT // 128) * 128)
        return 4 * d * d + h * (d // h) * 4 * (d // h) + 4 * d + 2 * d * d_ff

    shared_counted = False
    for lid, kind in enumerate(cfg.blocks):
        if kind == "attn":
            total += attn_params() + 2 * d
            if cfg.is_encoder_decoder:
                total += attn_params() + d
            if cfg.moe is not None and lid >= cfg.first_k_dense_layers:
                total += moe_params(active_only)
            else:
                total += mlp_params(cfg.d_ff)
        elif kind == "shared_attn":
            if not shared_counted:
                total += attn_params() + mlp_params(cfg.d_ff) + 2 * d
                shared_counted = True
        elif kind == "mamba":
            total += mamba_params() + d
        elif kind == "mlstm":
            total += mlstm_params() + d
        elif kind == "slstm":
            total += slstm_params() + d
    if cfg.is_encoder_decoder:
        total += cfg.n_encoder_layers * (attn_params() + mlp_params(cfg.d_ff) + 2 * d)
    if cfg.mtp_depth:
        total += 2 * d * d + attn_params() + mlp_params(cfg.d_ff) + 3 * d
    return int(total)


# ---------------------------------------------------------------------------
# Step closures
# ---------------------------------------------------------------------------

def make_train_step(model: LM, opt: Optimizer, compute_dtype=torch.bfloat16,
                    microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, loss).

    The loss runs on every float32 leaf cast to ``compute_dtype``, so the
    gradients reach the float32 leaves through the casts, as in the JAX
    package. ``microbatches > 1`` splits the batch's leading axis into
    equal parts, sums their float32 gradients (``training/grad.py``'s
    accumulators) and losses in order and takes both means before the one
    ``opt.update``. Under sharding rules with a ``data`` axis each
    gradient leaf and the loss are then averaged over the data ranks
    (``tensor_parallel.mean_over_data``; an FSDP leaf's gradient, already
    reduce-scattered over ``data``, divided by its size:
    ``fsdp.data_mean``), so ``opt`` steps each rank's own shards from the
    same gradients on every data replica."""

    def cast(tree):
        return tree_map(lambda x: x.to(compute_dtype) if x.dtype == torch.float32
                        else x, tree)

    def loss_and_grads(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = model.loss(cast(tree_unflatten(params, leaves)), batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    def step(params, opt_state, batch):
        if microbatches <= 1:
            loss, grads = loss_and_grads(params, batch)
            grads = data_mean(model, params, list(grads))
            loss = mean_over_data([loss])[0]
            new_params, new_opt_state = opt.update(
                tree_unflatten(params, grads), opt_state, params)
            return new_params, new_opt_state, loss
        n = next(iter(batch.values())).shape[0]
        if n % microbatches:
            raise ValueError(f"a batch of {n} does not split into {microbatches} "
                             "equal microbatches")
        acc = accum_init(params)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
        for i in loops.steps(microbatches):
            mb = {k: torch.chunk(v, microbatches)[i] for k, v in batch.items()}
            loss, grads = loss_and_grads(params, mb)
            acc = accum_add(acc, tree_unflatten(params, list(grads)))
            loss_sum = loss_sum + loss
        new_params, new_opt_state = opt.update(
            tree_unflatten(params, data_mean(model, params, tree_leaves(accum_mean(acc)))),
            opt_state, params)
        return (new_params, new_opt_state,
                mean_over_data([loss_sum * (1.0 / microbatches)])[0])

    return step


def make_eval_step(model: LM):
    def step(params, batch):
        with torch.no_grad():
            return model.loss(params, batch)

    return step


def make_prefill_step(model: LM):
    def step(params, tokens, cache, frontend_embeds=None, encoder_frames=None):
        return model.prefill(params, tokens, cache, frontend_embeds=frontend_embeds,
                             encoder_frames=encoder_frames)

    return step


def make_decode_step(model: LM):
    def step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return step


# ---------------------------------------------------------------------------
# Batch construction
# ---------------------------------------------------------------------------

def make_dummy_batch(cfg: LMConfig, batch: int, seq: int,
                     generator: Optional[torch.Generator] = None) -> dict:
    """A random batch, drawn from ``generator`` on its device (a CPU
    generator seeded 0 if none), with the JAX package's keys and shapes:
    ``max(seq - n_front, 8)`` tokens a row in [0, vocab_size), where
    ``n_front`` is the vision frontend's token count (0 without one), and
    the labels, the tokens shifted by one with a -100 tail; standard
    normal float32 ``frontend_embeds`` [B, n_front, D] for the vision
    frontend and ``encoder_frames`` [B, encoder_seq, D] for an
    encoder-decoder."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    tokens = torch.randint(0, cfg.vocab_size, (batch, max(seq - n_front, 8)),
                           generator=gen, device=gen.device)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -100)], dim=1)
    out = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "vision":
        out["frontend_embeds"] = torch.randn((batch, n_front, cfg.d_model),
                                             generator=gen, device=gen.device)
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                            generator=gen, device=gen.device)
    return out
