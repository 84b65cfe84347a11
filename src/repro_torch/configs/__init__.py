"""Architecture registry: --arch <id> resolves here.

Counterpart: ``repro/configs/__init__.py``: all ten architectures of the
JAX package (the five dense ones, the two MoE ones, the zamba hybrid,
xlstm-350m and whisper-medium).
"""
from .base import ArchConfig  # noqa: F401

from . import (chameleon_34b, granite_moe_1b, mistral_nemo_12b, phi35_moe,
               phi3_mini, qwen25_3b, qwen3_4b, whisper_medium, xlstm_350m,
               zamba2_27b)

REGISTRY = {m.CONFIG.name: m.CONFIG for m in (
    chameleon_34b, granite_moe_1b, mistral_nemo_12b, phi35_moe, qwen3_4b,
    qwen25_3b, phi3_mini, whisper_medium, xlstm_350m, zamba2_27b)}

ARCH_IDS = sorted(REGISTRY)


def get_config(name: str, *, tiny: bool = False) -> ArchConfig:
    cfg = REGISTRY[name]
    return cfg.tiny() if tiny else cfg
