"""qwen2.5-3b [dense]: GQA kv=2, QKV bias [hf:Qwen/Qwen2.5 family].
Counterpart: ``repro/configs/qwen25_3b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab=151936,
    qkv_bias=True, norm="rms", mlp_kind="swiglu", rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B",
)
