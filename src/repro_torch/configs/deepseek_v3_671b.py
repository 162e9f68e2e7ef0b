"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8 MoE, MTP
[arXiv:2412.19437; hf].

61L d_model=7168 128H (kv=128) d_ff=2048 (expert width) vocab=129280.
Faithful extras: first 3 layers use a dense 18432-wide FFN; MLA with
q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128; one depth of
multi-token prediction.
"""
from repro_torch.configs.base import LMConfig, MLAConfig, MoEConfig

CONFIG = LMConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,  # dense FFN width for the first_k_dense layers
    vocab_size=129280,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=10_000.0,
    moe=MoEConfig(
        n_experts=256, n_experts_per_token=8, n_shared_experts=1,
        d_ff_expert=2048, capacity_factor=1.25,
    ),
    mla=MLAConfig(
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    ),
    mtp_depth=1,
    first_k_dense_layers=3,
    source="arXiv:2412.19437; hf",
)
