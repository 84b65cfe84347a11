"""qwen3-4b [dense]: qk_norm + GQA [hf:Qwen/Qwen3-8B family config].
Counterpart: ``repro/configs/qwen3_4b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab=151936,
    qk_norm=True, norm="rms", mlp_kind="swiglu", rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)
