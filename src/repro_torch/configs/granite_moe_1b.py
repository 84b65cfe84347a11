"""granite-moe-1b-a400m [moe]: 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].
Counterpart: ``repro/configs/granite_moe_1b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    n_experts=32, top_k=8,
    norm="rms", mlp_kind="swiglu",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
