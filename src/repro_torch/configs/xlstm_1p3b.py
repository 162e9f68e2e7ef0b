"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304. ``d_ff=0``: the xLSTM
blocks carry their own projections (mLSTM pre-up-projection factor 2,
sLSTM post-FFN 4/3), so there is no separate transformer MLP. Block mix
follows the paper's [7:1] recipe: one sLSTM block per 8 layers.
"""
from repro_torch.configs.base import LMConfig, SSMConfig

_PATTERN = tuple("slstm" if i % 8 == 3 else "mlstm" for i in range(48))

CONFIG = LMConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    norm="rmsnorm",
    activation="gelu",
    block_pattern=_PATTERN,
    ssm=SSMConfig(state_dim=64, head_dim=512, conv_width=4, expand=2, chunk=128),
    source="arXiv:2405.04517; unverified",
)
