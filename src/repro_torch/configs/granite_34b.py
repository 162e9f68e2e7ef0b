"""granite-34b — llama-arch code model, MQA [arXiv:2405.04324; hf].

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=10_000.0,
    source="arXiv:2405.04324; hf",
)
