"""zamba2-7b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64. The
hybrid pattern interleaves one *weight-shared* attention block every 6
layers (the Zamba trick: a single attention parameter set reused at every
``shared_attn`` site).
"""
from repro_torch.configs.base import LMConfig, SSMConfig

_PATTERN = tuple("shared_attn" if i % 6 == 5 else "mamba" for i in range(81))

CONFIG = LMConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    norm="rmsnorm",
    activation="swiglu",
    block_pattern=_PATTERN,
    ssm=SSMConfig(state_dim=64, head_dim=64, conv_width=4, expand=2, chunk=128),
    source="arXiv:2411.15242; unverified",
)
