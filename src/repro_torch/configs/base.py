"""Config system: architecture + shape registries for the assigned pool.

Every assigned architecture is a frozen ``LMConfig``; shapes are
``ShapeConfig`` entries. ``reduced()`` derives the small CPU-smoke variant
of the same family (same block structure, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    n_experts_per_token: int
    n_shared_experts: int = 0
    d_ff_expert: int = 0  # per-expert FFN width
    capacity_factor: float = 1.25
    impl: str = "sorted"  # "sorted" (fused dispatch) | "dense" (baseline)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64  # N
    head_dim: int = 64  # P
    conv_width: int = 4
    expand: int = 2
    chunk: int = 128  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"
    activation: str = "swiglu"  # swiglu | gelu
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # layer pattern: per-layer block kind; None => all "attn"
    # kinds: attn | mamba | slstm | mlstm | shared_attn
    block_pattern: Optional[Sequence[str]] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # gemma3-style interleaved local attention: window size + every Nth global
    sliding_window: int = 0
    global_every: int = 0  # 0 => all global
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500  # stubbed frame count
    # multimodal stub front-end
    frontend: str = "none"  # none | vision | audio
    n_frontend_tokens: int = 0  # e.g. image patches prepended
    # deepseek multi-token prediction
    mtp_depth: int = 0
    # deepseek: first k layers use a dense FFN (width = d_ff) instead of MoE
    first_k_dense_layers: int = 0
    # source/verification tag from the assignment table
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def blocks(self) -> Sequence[str]:
        if self.block_pattern is not None:
            return tuple(self.block_pattern)
        return tuple(["attn"] * self.n_layers)

    def padded_vocab(self, multiple: int = 256) -> int:
        return -(-self.vocab_size // multiple) * multiple

    def param_count(self) -> int:
        """Approximate parameter count (for 6ND roofline math)."""
        from repro_torch.models.model_zoo import count_params

        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model_zoo import count_params

        return count_params(self, active_only=True)

    def reduced(self) -> "LMConfig":
        """Tiny same-family variant for CPU smoke tests."""
        blocks = self.blocks
        # keep the *pattern* (first 4 kinds) but shrink depth; make sure every
        # block kind in the full config appears in the reduced one
        n = min(self.n_layers, 4)
        pattern = None
        if self.block_pattern:
            pat = [blocks[i] for i in range(n)]
            missing = [k for k in dict.fromkeys(blocks) if k not in pat]
            for j, kind in enumerate(missing):
                pat[-(j + 1)] = kind
            pattern = tuple(pat)
        moe = None
        if self.moe:
            moe = dataclasses.replace(
                self.moe, n_experts=4,
                n_experts_per_token=min(2, self.moe.n_experts_per_token),
                d_ff_expert=64,
            )
        mla = None
        if self.mla:
            mla = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                            qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8)
        ssm = None
        if self.ssm:
            ssm = dataclasses.replace(self.ssm, state_dim=8, head_dim=8, chunk=16)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=128,
            vocab_size=512,
            head_dim=16,
            block_pattern=pattern,
            moe=moe,
            mla=mla,
            ssm=ssm,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=32 if self.is_encoder_decoder else self.encoder_seq,
            n_frontend_tokens=8 if self.n_frontend_tokens else 0,
            mtp_depth=self.mtp_depth,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# sub-quadratic attention requirement: which archs run long_500k
LONG_CONTEXT_ARCHS = {"xlstm-1.3b", "zamba2-7b", "gemma3-1b"}


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment's skip rules."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, (
            "pure full-attention arch: 500k context needs sub-quadratic "
            "attention (DESIGN.md §4 skip list)"
        )
    return True, ""
