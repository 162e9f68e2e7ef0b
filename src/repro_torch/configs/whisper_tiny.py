"""whisper-tiny — encoder-decoder with conv frontend stub
[arXiv:2212.04356; unverified].

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865. The conv1d audio
front-end is a STUB: ``input_specs()`` supplies precomputed frame
embeddings [B, 1500, 384]. Decode shapes run against the decoder with
cross-attention to the encoder output.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    norm="layernorm",
    activation="gelu",
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_seq=1500,
    frontend="audio",
    source="arXiv:2212.04356; unverified",
)
