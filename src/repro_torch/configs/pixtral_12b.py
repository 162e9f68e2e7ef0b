"""pixtral-12b — pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072. The vision
front-end is a STUB per the assignment: ``input_specs()`` supplies
precomputed patch embeddings (256 tokens at d_model), prepended to the
text sequence.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=1_000_000_000.0,
    frontend="vision",
    n_frontend_tokens=256,
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)
