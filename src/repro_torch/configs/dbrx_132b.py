"""dbrx-132b — 16-expert top-4 fine-grained MoE
[hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""
from repro_torch.configs.base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    norm="layernorm",
    activation="swiglu",
    rope_theta=500_000.0,
    moe=MoEConfig(
        n_experts=16, n_experts_per_token=4, d_ff_expert=10752,
        capacity_factor=1.25,
    ),
    source="hf:databricks/dbrx-base; unverified",
)
