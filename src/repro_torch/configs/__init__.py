"""Architecture registry: --arch <id> resolves here.

Counterpart: ``repro/configs/__init__.py``.  The five dense architectures,
the two MoE ones and the zamba hybrid are ported; the other two ids wait
for their families and raise ``NotImplementedError`` naming the ROADMAP
item.
"""
from .base import ArchConfig  # noqa: F401

from . import (chameleon_34b, granite_moe_1b, mistral_nemo_12b, phi35_moe,
               phi3_mini, qwen25_3b, qwen3_4b, zamba2_27b)

REGISTRY = {m.CONFIG.name: m.CONFIG for m in (
    chameleon_34b, granite_moe_1b, mistral_nemo_12b, phi35_moe, qwen3_4b,
    qwen25_3b, phi3_mini, zamba2_27b)}

# arch id -> the ROADMAP item that ports its family
PENDING = {
    "xlstm-350m": "ROADMAP item 11 (recurrent families)",
    "whisper-medium": "ROADMAP item 11 (encoder-decoder)",
}

ARCH_IDS = sorted(REGISTRY) + sorted(PENDING)


def get_config(name: str, *, tiny: bool = False) -> ArchConfig:
    if name in PENDING:
        raise NotImplementedError(
            f"{name!r} is not ported yet: its family comes with "
            f"{PENDING[name]}")
    cfg = REGISTRY[name]
    return cfg.tiny() if tiny else cfg
