"""gemma3-1b — 5:1 local:global interleaved attention, 128k-ready
[hf:google/gemma-3-1b-pt; unverified].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, head_dim=256.
Every 6th layer is global; the rest use a 512-token sliding window —
which is what makes the ``long_500k`` decode cell sub-quadratic.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    norm="rmsnorm",
    activation="gelu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    sliding_window=512,
    global_every=6,
    source="hf:google/gemma-3-1b-pt; unverified",
)
