"""Architecture registry: ``get_config("<arch-id>")`` + shape registry.

A copy of ``repro/configs`` (pure Python data, copied because the port
imports nothing of ``repro``); ``LMConfig.param_count`` reads the port's
``models/model_zoo.py:count_params``. The LM path of the port runs the
dense configurations (``models/transformer.py``)."""
from __future__ import annotations

from repro_torch.configs.base import (
    LMConfig,
    MoEConfig,
    MLAConfig,
    SSMConfig,
    ShapeConfig,
    SHAPES,
    LONG_CONTEXT_ARCHS,
    cell_is_runnable,
)

from repro_torch.configs.xlstm_1p3b import CONFIG as _xlstm
from repro_torch.configs.pixtral_12b import CONFIG as _pixtral
from repro_torch.configs.whisper_tiny import CONFIG as _whisper
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2
from repro_torch.configs.gemma3_1b import CONFIG as _gemma3
from repro_torch.configs.llama3p2_1b import CONFIG as _llama32
from repro_torch.configs.granite_34b import CONFIG as _granite

ARCHS: dict[str, LMConfig] = {
    c.name: c
    for c in [
        _xlstm, _pixtral, _whisper, _zamba2, _dbrx,
        _deepseek, _starcoder2, _gemma3, _llama32, _granite,
    ]
}


def get_config(name: str) -> LMConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted(ARCHS)
