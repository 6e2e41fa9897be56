"""Architecture registry: ``--arch <id>`` resolves here (the port's copy
of ``src/repro/configs/__init__.py``, same ten configs in ``ARCHS``).
``PORT_ARCHS`` holds the architectures the port runs and the JAX package
does not; ``get_config`` finds both."""
from __future__ import annotations

from repro_torch.configs.base import (
    ALL_CELLS,
    CELLS_BY_NAME,
    DECODE_32K,
    LONG_500K,
    LONG_CONTEXT_ARCHS,
    PREFILL_32K,
    TRAIN_4K,
    EncDecConfig,
    HybridMoEConfig,
    Mamba2Config,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeCell,
    SSMConfig,
    YarnScaling,
    cell_applicable,
    input_specs,
)

from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL
from repro_torch.configs.falcon_mamba_7b import CONFIG as FALCON_MAMBA_7B
from repro_torch.configs.granite_20b import CONFIG as GRANITE_20B
from repro_torch.configs.gemma3_12b import CONFIG as GEMMA3_12B
from repro_torch.configs.olmo_1b import CONFIG as OLMO_1B
from repro_torch.configs.qwen2_0_5b import CONFIG as QWEN2_0_5B
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B
from repro_torch.configs.granite_moe_3b import CONFIG as GRANITE_MOE_3B
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2_MOE_A2_7B
from repro_torch.configs.qwen2_vl_7b import CONFIG as QWEN2_VL_7B
from repro_torch.configs.granite_4_0_h_small import (
    CONFIG as GRANITE_4_0_H_SMALL,
)
from repro_torch.configs.deepseek_v2_lite import CONFIG as DEEPSEEK_V2_LITE

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        WHISPER_SMALL,
        FALCON_MAMBA_7B,
        GRANITE_20B,
        GEMMA3_12B,
        OLMO_1B,
        QWEN2_0_5B,
        ZAMBA2_1_2B,
        GRANITE_MOE_3B,
        QWEN2_MOE_A2_7B,
        QWEN2_VL_7B,
    )
}


# the port's own architectures, with no twin in the JAX package
PORT_ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (GRANITE_4_0_H_SMALL, DEEPSEEK_V2_LITE)
}


def get_config(name: str) -> ModelConfig:
    cfg = ARCHS.get(name, PORT_ARCHS.get(name))
    if cfg is None:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(ARCHS) + sorted(PORT_ARCHS)}")
    return cfg


__all__ = [
    "ARCHS",
    "PORT_ARCHS",
    "get_config",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "EncDecConfig",
    "HybridMoEConfig",
    "Mamba2Config",
    "MLAConfig",
    "YarnScaling",
    "ShapeCell",
    "ALL_CELLS",
    "CELLS_BY_NAME",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "LONG_CONTEXT_ARCHS",
    "cell_applicable",
    "input_specs",
]
