"""Model registry, parameter counting and step closures for the LM substrate.

Counterpart of ``repro/models/model_zoo.py``: ``build_model(cfg)`` -> LM,
``count_params`` (the closed form, copied: N for the 6·N·D roofline term,
``active_only`` counting only routed-in experts), and the serving steps
``make_prefill_step`` / ``make_decode_step``. The port runs eagerly, so
the steps are thin closures over the model. ``make_train_step`` waits for
LM training (ROADMAP.md Queue 1, item 9).
"""
from __future__ import annotations

from repro_torch.configs.base import LMConfig
from repro_torch.models.transformer import LM

#: ``repro/models/xlstm.py:SLSTM_FF_MULT``, for the sLSTM block's count
SLSTM_FF_MULT = 1.375


def build_model(cfg: LMConfig, inner: str = "cuda") -> LM:
    """The LM for ``cfg`` with ``inner``'s prefill attention (``"cuda"``
    the flash kernel, ``"torch"`` its plain version)."""
    return LM(cfg, inner=inner)


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

def make_prefill_step(model: LM):
    def step(params, tokens, cache):
        return model.prefill(params, tokens, cache)

    return step


def make_decode_step(model: LM):
    def step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return step
